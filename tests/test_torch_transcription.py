"""Parity of the port's collocation transcription with the JAX package's, in
float64: defects, the structured constraint Jacobian, cost and cost
gradient, the per-node Lagrangian Hessian, the RK4 rollout guess, the bound
assembly and the BBT structure, on bench.py's augmented kite and on the
parking OCP (a parameter border and a node inequality), to 1e-10 relative.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_parity as tp  # noqa: E402
from polympc_tpu.ocp import ocp_bounds as j_ocp_bounds  # noqa: E402
from polympc_torch.ocp import ocp_bounds  # noqa: E402
from polympc_torch.ops.structure import structure_is_consistent  # noqa: E402
from polympc_torch.utils import convert  # noqa: E402

B = 3


def _close(got, want, rtol=1e-10):
    want = np.asarray(want)
    scale = max(1.0, float(np.max(np.abs(want)))) if want.size else 1.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * scale)


def _prm_np(name):
    if name == "kite":
        return {"p": np.zeros(0), "d": np.array([0.05]), "t0": 0.0,
                "tf": 2.0}
    return {"p": np.array([1.3]), "d": np.array([2.0]), "t0": 0.0,
            "tf": 1.0}


@pytest.fixture(scope="module", params=["kite", "parking"])
def problem(request):
    """Both transcriptions, random lane points, and every JAX output."""
    name = request.param
    if name == "kite":
        jtr = tp.jax_kite()[0]
        ttr = tp.torch_kite()[0]
    else:
        jtr, ttr = tp.jax_parking(), tp.torch_parking()
    prm = _prm_np(name)
    jprm = {k: jnp.asarray(v, jnp.float64) for k, v in prm.items()}
    z, lam = tp.lane_points(jtr, B, seed=11)
    nlp = jtr.nlp
    zj, lj = jnp.asarray(z), jnp.asarray(lam)
    out = {
        "cost": jax.vmap(nlp.cost, (0, None))(zj, jprm),
        "cost_grad": jax.vmap(jax.grad(nlp.cost), (0, None))(zj, jprm),
        "eq": jax.vmap(nlp.eq, (0, None))(zj, jprm),
        "eq_jac": jax.vmap(nlp.eq_jac, (0, None))(zj, jprm),
        "lag_hessian": jax.vmap(nlp.lag_hessian, (0, 0, None))(
            zj, lj, jprm),
    }
    if nlp.ineq is not None:
        out["ineq"] = jax.vmap(nlp.ineq, (0, None))(zj, jprm)
        out["ineq_jac"] = jax.vmap(nlp.ineq_jac, (0, None))(zj, jprm)
    return {"name": name, "jtr": jtr, "ttr": ttr, "z": z, "lam": lam,
            "prm": prm, "tprm": convert.params(prm, device="cpu"),
            "out": {k: np.asarray(v) for k, v in out.items()}}


@pytest.mark.parametrize("fn", ["cost", "cost_grad", "eq", "eq_jac",
                                "ineq", "ineq_jac"])
def test_first_order_matches_jax(problem, fn):
    nlp = problem["ttr"].nlp
    if getattr(nlp, fn) is None:
        assert fn not in problem["out"]
        return
    got = getattr(nlp, fn)(tp.t64(problem["z"]), problem["tprm"])
    _close(got, problem["out"][fn])


def test_lag_hessian_matches_jax(problem):
    nlp = problem["ttr"].nlp
    H = nlp.lag_hessian(tp.t64(problem["z"]), tp.t64(problem["lam"]),
                        problem["tprm"])
    assert H.shape == (B, nlp.n, nlp.n)
    _close(H, problem["out"]["lag_hessian"])
    np.testing.assert_allclose(H.numpy(), H.transpose(1, 2).numpy(),
                               atol=1e-12)


def test_float32_evaluation_stays_float32(problem):
    """Derivatives of float32 inputs come back in float32."""
    nlp = problem["ttr"].nlp
    z = tp.t64(problem["z"]).float()
    lam = tp.t64(problem["lam"]).float()
    prm = convert.params(problem["prm"], torch.float32, device="cpu")
    for v in (nlp.eq_jac(z, prm), nlp.cost_grad(z, prm),
              nlp.lag_hessian(z, lam, prm)):
        assert v.dtype == torch.float32
    _close(nlp.lag_hessian(z, lam, prm).double(),
           problem["out"]["lag_hessian"], rtol=1e-4)


def test_bbt_structure_matches_jax(problem):
    js = problem["jtr"].bbt_structure()
    ts = problem["ttr"].bbt_structure()
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert structure_is_consistent(ts)


def test_rollout_guess_matches_jax():
    jtr, jb, jprm, _ = tp.jax_kite()
    ttr, _, tprm, _ = tp.torch_kite()
    x0s = tp.headline.bench_x0s(512)[:5].astype(np.float64)
    want = jax.vmap(lambda x: jtr.rollout_guess(x, jprm))(jnp.asarray(x0s))
    got = ttr.rollout_guess(tp.t64(x0s), tprm)
    _close(got, want)


def test_ocp_bounds_match_jax():
    jtr = tp.jax_kite()[0]
    ttr = tp.torch_kite()[0]
    kw = dict(ul=[-5.0, -10.0], uu=[5.0, 10.0], xl=tp.KITE_XL,
              xu=tp.KITE_XU, x0=[0.3, 0.1, 0.0, 1.0, 0.05])
    want = j_ocp_bounds(jtr, dtype=jnp.float64, **kw)
    got = ocp_bounds(ttr, dtype=torch.float64, device="cpu", **kw)
    for f in got._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))


def test_scaling_pack_unpack_match_jax():
    """x/u scaling: the physical <-> scaled decision-vector maps."""
    from polympc_tpu.ocp import transcribe as j_transcribe
    from polympc_torch.ocp import transcribe
    jtr0, ttr0 = tp.jax_kite()[0], tp.torch_kite()[0]
    sx, su = [1.0, 2.0, 0.5, 4.0, 1.0], [3.0, 0.25]
    jtr = j_transcribe(jtr0.ocp, jtr0.mesh, x_scale=sx, u_scale=su)
    ttr = transcribe(ttr0.ocp, ttr0.mesh, x_scale=sx, u_scale=su)
    z = tp.lane_points(jtr, B, seed=5)[0]
    want = [jax.vmap(jtr.unpack)(jnp.asarray(z))[i] for i in range(3)]
    got = ttr.unpack(tp.t64(z))
    for g, w in zip(got, want):
        _close(g, w)
    _close(ttr.pack(*got), z)
    x0 = [0.3, 0.1, 0.0, 1.0, 0.05]
    _close(ttr.initial_guess(x0, device="cpu"), jtr.initial_guess(x0))
    prm = _prm_np("kite")
    jprm = {k: jnp.asarray(v, jnp.float64) for k, v in prm.items()}
    lam = tp.lane_points(jtr, B, seed=6)[1]
    tprm = convert.params(prm, device="cpu")
    _close(ttr.nlp.eq_jac(tp.t64(z), tprm),
           jax.vmap(jtr.nlp.eq_jac, (0, None))(jnp.asarray(z), jprm))
    _close(ttr.nlp.lag_hessian(tp.t64(z), tp.t64(lam), tprm),
           jax.vmap(jtr.nlp.lag_hessian, (0, 0, None))(
               jnp.asarray(z), jnp.asarray(lam), jprm))
