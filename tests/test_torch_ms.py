"""Parity of the port's multiple-shooting transcription with the JAX
package's, in float64: the NLP functions and the bound assembly (exact), the
robot by multiple shooting (the same status and iteration count, x to 1e-8,
and its cost within 2% of the collocation cost, tests/test_ms.py's oracle),
and the kite MS batch of the ``kite_ms_b512`` path at B=4 (per-lane status
and iterations equal, x to 1e-8), through the LU epoch on both sides and
through the dense epoch kernel's plain version in the port; and the
harness's timed unit and the committed record.
"""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import single_thread  # noqa: E402,F401
from polympc_tpu.models import robot_ocp as j_robot_ocp  # noqa: E402
from polympc_tpu.nlp import SQPSettings as JSQPSettings  # noqa: E402
from polympc_tpu.nlp import sqp_solve as j_sqp_solve  # noqa: E402
from polympc_tpu.ocp import ms_bounds as j_ms_bounds  # noqa: E402
from polympc_tpu.ocp import transcribe_ms as j_transcribe_ms  # noqa: E402
from polympc_tpu.qp.types import ADMMSettings as JADMMSettings  # noqa: E402
from polympc_torch import ocp_extras_point as op  # noqa: E402
from polympc_torch.models import robot_ocp  # noqa: E402
from polympc_torch.nlp import SQPSettings, sqp_solve  # noqa: E402
from polympc_torch.ocp import ms_bounds, transcribe_ms  # noqa: E402
from polympc_torch.qp.box_admm import epoch_route  # noqa: E402
from polympc_torch.qp.types import ADMMSettings  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
X0 = [0.5, 0.5, 0.5]
UL, UU = [-1.5, -0.75], [1.5, 0.75]


def _robot():
    jtr = j_transcribe_ms(j_robot_ocp(), num_segments=10,
                          steps_per_segment=4)
    ttr = transcribe_ms(robot_ocp(), num_segments=10, steps_per_segment=4)
    return jtr, ttr


def test_ms_functions_match_jax():
    """eq, cost and ineq-free layout on random lanes, the split and the
    initial guess."""
    jtr, ttr = _robot()
    assert (ttr.nlp.n, ttr.nlp.ne, ttr.nlp.ni) == (jtr.nlp.n, jtr.nlp.ne,
                                                  jtr.nlp.ni) == (53, 30, 0)
    jp = jtr.params(d=[2.0], t0=0.0, tf=2.0)
    tp = ttr.params(d=[2.0], t0=0.0, tf=2.0, device="cpu")
    z = np.random.default_rng(3).normal(size=(4, jtr.nlp.n))
    zt = torch.tensor(z)
    np.testing.assert_allclose(
        ttr.nlp.eq(zt, tp).numpy(),
        np.asarray(jax.vmap(jtr.nlp.eq, (0, None))(jnp.asarray(z), jp)),
        rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(
        ttr.nlp.cost(zt, tp).numpy(),
        np.asarray(jax.vmap(jtr.nlp.cost, (0, None))(jnp.asarray(z), jp)),
        rtol=1e-13)
    for a, b in zip(ttr.split(zt[0]), jtr.split(jnp.asarray(z[0]))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        ttr.initial_guess(X0, device="cpu").numpy(),
        np.asarray(jtr.initial_guess(X0)))


def test_ms_bounds_exact():
    jtr, ttr = _robot()
    kw = dict(xl=[-1.0, -2.0, -3.0], xu=[1.0, 2.0, 3.0], ul=UL, uu=UU,
              x0=X0, xf=[0.1, 0.2, 0.3])
    jb = j_ms_bounds(jtr, **kw)
    tb = ms_bounds(ttr, device="cpu", **kw)
    for f in tb._fields:
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), f)


def test_ms_robot_matches_jax():
    jtr, ttr = _robot()
    qp = dict(eps_abs=1e-6, eps_rel=1e-6, max_epochs=40)
    js = j_sqp_solve(jtr.nlp, jtr.initial_guess(X0),
                     p=jtr.params(d=[2.0], t0=0.0, tf=2.0),
                     bounds=j_ms_bounds(jtr, ul=UL, uu=UU, x0=X0),
                     settings=JSQPSettings(hessian="exact", max_iter=100,
                                           qp=JADMMSettings(**qp)))
    ts = sqp_solve(ttr.nlp, ttr.initial_guess(X0, device="cpu")[None],
                   p=ttr.params(d=[2.0], t0=0.0, tf=2.0, device="cpu"),
                   bounds=ms_bounds(ttr, ul=UL, uu=UU, x0=X0, device="cpu"),
                   settings=SQPSettings(hessian="exact", max_iter=100,
                                        qp=ADMMSettings(**qp)))
    assert int(ts.status[0]) == int(js.status) == 1
    assert int(ts.iters[0]) == int(js.iters)
    np.testing.assert_allclose(ts.x[0].numpy(), np.asarray(js.x), rtol=0,
                               atol=1e-8)
    rec = np.load(ROOT / "tests" / "data" / "ocp_extras_jax_cpu.npz")
    np.testing.assert_allclose(float(ts.cost[0]),
                               float(rec["ms_robot_collocation_cost"]),
                               rtol=2e-2)


@pytest.fixture(scope="module")
def kite_jax():
    """The JAX package's float64 MS kite batch (B=4, LU epoch) from
    tests/data/make_ocp_extras_reference.py's problem."""
    import sys
    sys.path.insert(0, str(ROOT / "tests" / "data"))
    import make_ocp_extras_reference as gen
    x0s = op.bench_x0s(4).astype(np.float64)
    tr, bounds, prm, settings = gen.kite_ms(jnp.float64, op.MAX_ITER)
    sols = gen.kite_solve_fn(tr, bounds, prm, settings)(jnp.asarray(x0s))
    return x0s, jax.tree_util.tree_map(np.asarray, sols)


@pytest.mark.parametrize("kkt_solver", ["lu", "kernel"])
def test_kite_ms_batch_matches_jax_per_lane(kite_jax, kkt_solver):
    """The port's batch (its "lu" epoch, and the path's "kernel" route, whose
    CPU form is the dense epoch kernel's plain version) against the JAX LU
    epoch, float64."""
    x0s, js = kite_jax
    tr, bounds, prm, settings = op.kite_ms_problem("cpu", torch.float64)
    settings = type(settings)(**{**settings.__dict__, "qp": type(
        settings.qp)(**{**settings.qp.__dict__, "kkt_solver": kkt_solver})})
    want = {"lu": "lu", "kernel": "dense_kernel"}[kkt_solver]
    assert epoch_route(tr.nlp.n, tr.nlp.m, settings.qp) == want
    x0 = torch.tensor(x0s)
    sol = sqp_solve(tr.nlp, tr.initial_guess(x0, device="cpu"), p=prm,
                    bounds=op.pin_ms(tr, bounds, x0), settings=settings)
    np.testing.assert_array_equal(sol.status.numpy(), js.status)
    np.testing.assert_array_equal(sol.iters.numpy(), js.iters)
    np.testing.assert_allclose(sol.x.numpy(), js.x, rtol=0, atol=1e-8)


def test_kite_ms_unit_and_record():
    """The path's timed unit at B=2 on the CPU (float32 solve, float64
    certify) and the committed JAX record: bench's x0s, under 1 MB, the
    record's own counts consistent."""
    path = ROOT / "tests" / "data" / "ocp_extras_jax_cpu.npz"
    assert path.stat().st_size < 1024 * 1024
    rec = np.load(path)
    np.testing.assert_array_equal(rec["kite_x0s"], op.bench_x0s(512))
    assert int(rec["kite_max_iter"]) == op.MAX_ITER
    np.testing.assert_array_equal(rec["kite_certified"],
                                  rec["kite_residual"] <= op.KKT_TOL)
    assert rec["kite_x"].shape == (512, 75)
    assert 2 * rec["kite_certified"].sum() >= 512
    extra, lanes = op.kite_ms(2, "cpu", reps=1, warmup=0)
    assert extra["batch"] == 2 and lanes["x"].shape == (2, 75)
    assert np.isfinite(lanes["residual"]).all()
    assert extra["certified"] == 2
