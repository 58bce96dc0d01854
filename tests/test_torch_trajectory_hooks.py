"""Trajectory-level hooks in the port's transcription (GenericOCP's rate
operators, generic_ocp.hpp:88-101), against the JAX package in float64: the
SpectralOps handed to a hook equal the JAX package's exactly (and
differentiate a cubic exactly); the hooked NLP's cost, rows, Jacobian and
Hessian to 1e-12; the robot with a rate bound |du/dt| <= 1.2 and with a rate
cost solved with the same status and iterations and x within 1e-8, the bound
met and binding.
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_parity as tp  # noqa: E402
from _torch_parity import single_thread  # noqa: E402,F401
from polympc_tpu import basis as jb  # noqa: E402
from polympc_tpu.models import robot_ocp as j_robot_ocp  # noqa: E402
from polympc_tpu.nlp import SQPSettings as JSQPSettings  # noqa: E402
from polympc_tpu.nlp import sqp_solve as j_sqp_solve  # noqa: E402
from polympc_tpu.ocp import ocp_bounds as j_ocp_bounds  # noqa: E402
from polympc_tpu.ocp import transcribe as j_transcribe  # noqa: E402
from polympc_tpu.qp.types import ADMMSettings as JADMMSettings  # noqa: E402
from polympc_torch import basis as tb  # noqa: E402
from polympc_torch.models import robot_ocp  # noqa: E402
from polympc_torch.nlp import SQPSettings, sqp_solve  # noqa: E402
from polympc_torch.ocp import ocp_bounds, transcribe  # noqa: E402
from polympc_torch.qp.types import ADMMSettings  # noqa: E402

X0 = [0.5, 0.5, 0.5]
N, NU, RMAX = 11, 2, 1.2
QP = dict(rho=1.0, eps_abs=1e-6, eps_rel=1e-6, max_epochs=40,
          equil_iters=2)


def _rate_rows(X, U, P, d, t, ops):
    return (ops.D @ U).reshape(-1)


def _rate_cost(lib):
    def cost(X, U, P, d, t, ops):
        dU = ops.D @ U
        return 0.5 * lib.sum((dU * dU) * ops.w[:, None])
    return cost


def _hooked(base, lib, bound, cost):
    return dataclasses.replace(
        base, trajectory_ineq=_rate_rows if bound else None,
        ntg=N * NU if bound else 0,
        trajectory_cost=_rate_cost(lib) if cost else None)


def _pair(bound, cost):
    jtr = j_transcribe(_hooked(j_robot_ocp(), jnp, bound, cost),
                       jb.SegmentedBasis(jb.Chebyshev(5), 2))
    ttr = transcribe(_hooked(robot_ocp(), torch, bound, cost),
                     tb.SegmentedBasis(tb.Chebyshev(5), 2))
    return jtr, ttr


def test_spectral_ops_equal_jax():
    seen = {}

    def spy(store, lib):
        def cost(X, U, P, d, t, ops):
            store["ops"] = ops
            return lib.sum(X) * 0.0
        return cost
    jtr = j_transcribe(dataclasses.replace(j_robot_ocp(),
                                           trajectory_cost=spy(seen, jnp)),
                       jb.SegmentedBasis(jb.Chebyshev(5), 2))
    jtr.nlp.cost(jnp.zeros(jtr.nlp.n), jtr.params(d=[2.0], t0=0.0, tf=2.0))
    jops = seen.pop("ops")
    ttr = transcribe(dataclasses.replace(robot_ocp(),
                                         trajectory_cost=spy(seen, torch)),
                     tb.SegmentedBasis(tb.Chebyshev(5), 2))
    ttr.nlp.cost(torch.zeros(1, ttr.nlp.n, dtype=torch.float64),
                 ttr.params(d=[2.0], t0=0.0, tf=2.0, device="cpu"))
    tops = seen["ops"]
    np.testing.assert_array_equal(tops.D.numpy(), np.asarray(jops.D))
    np.testing.assert_array_equal(tops.w.numpy(), np.asarray(jops.w))
    t = ttr.mesh.time_nodes(0.0, 2.0)
    np.testing.assert_allclose(tops.D.numpy() @ (t ** 3 - 2 * t),
                               3 * t ** 2 - 2, atol=1e-9)


@pytest.mark.parametrize("bound,cost", [(True, True), (True, False),
                                        (False, True)])
def test_hooked_nlp_matches_jax(bound, cost):
    jtr, ttr = _pair(bound, cost)
    nlp, tn = jtr.nlp, ttr.nlp
    assert (tn.ne, tn.ni) == (nlp.ne, nlp.ni)
    jp = jtr.params(d=[2.0], t0=0.0, tf=2.0)
    tpr = ttr.params(d=[2.0], t0=0.0, tf=2.0, device="cpu")
    z, lam = tp.lane_points(jtr, 3, seed=9)
    zj, lj, zt, lt = jnp.asarray(z), jnp.asarray(lam), torch.tensor(z), \
        torch.tensor(lam)
    vm = lambda f: np.asarray(jax.vmap(f, (0, None))(zj, jp))
    tol = dict(rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tn.cost(zt, tpr).numpy(), vm(nlp.cost), **tol)
    np.testing.assert_allclose(
        tn.lag_hessian(zt, lt, tpr).numpy(),
        np.asarray(jax.vmap(nlp.lag_hessian, (0, 0, None))(zj, lj, jp)),
        **tol)
    if bound:
        np.testing.assert_allclose(tn.ineq(zt, tpr).numpy(), vm(nlp.ineq),
                                   **tol)
        np.testing.assert_allclose(tn.ineq_jac(zt, tpr).numpy(),
                                   vm(nlp.ineq_jac), **tol)


def _solve(jtr, ttr, tg):
    kw = dict(ul=[-1.5, -0.75], uu=[1.5, 0.75], x0=X0,
              tgl=None if tg is None else -tg, tgu=tg)
    js = j_sqp_solve(jtr.nlp, jtr.initial_guess(jnp.asarray(X0)),
                     p=jtr.params(d=[2.0], t0=0.0, tf=2.0),
                     bounds=j_ocp_bounds(jtr, **kw),
                     settings=JSQPSettings(hessian="exact", max_iter=60,
                                           qp=JADMMSettings(**QP)))
    ts = sqp_solve(ttr.nlp, ttr.initial_guess(X0, device="cpu")[None],
                   p=ttr.params(d=[2.0], t0=0.0, tf=2.0, device="cpu"),
                   bounds=ocp_bounds(ttr, device="cpu", **kw),
                   settings=SQPSettings(hessian="exact", max_iter=60,
                                        qp=ADMMSettings(**QP)))
    assert int(ts.status[0]) == int(js.status) == 1
    assert int(ts.iters[0]) == int(js.iters)
    np.testing.assert_allclose(ts.x[0].numpy(), np.asarray(js.x), rtol=0,
                               atol=1e-8)
    return ts


def test_rate_constraint_solve_matches_jax():
    jtr, ttr = _pair(True, False)
    ts = _solve(jtr, ttr, RMAX * np.ones(N * NU))
    _, U, _ = ttr.unpack(ts.x[0])
    D = ttr.Dg_unit / (2.0 / (2.0 * ttr.mesh.num_segments))
    rate = np.abs(D @ U.numpy()).max()
    assert rate <= RMAX + 1e-4
    rec = np.load(Path(__file__).parent / "data" / "ocp_extras_jax_cpu.npz")
    assert float(rec["rate_free_max_rate"]) > RMAX   # the bound binds


def test_rate_cost_solve_matches_jax():
    jtr, ttr = _pair(False, True)
    _solve(jtr, ttr, None)
