"""Parity of the port's batch-first solvers with the JAX package's vmapped
ones, in float64:

  * ``box_admm_solve`` on B kite QPs, through the BBT epoch with the
    structure and through the dense LU epoch, against
    ``jax.vmap(box_admm_solve)``;
  * ``regularize`` in every mode;
  * the kite ``make_batch_solver`` (bench's settings, rollout guess) at
    B=4: per-lane status and iteration counts equal, x within 1e-6.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_parity as tp  # noqa: E402
from polympc_tpu.nlp.hessian import regularize as j_regularize  # noqa: E402
from polympc_tpu.parallel import make_batch_solver as j_mbs  # noqa: E402
from polympc_tpu.qp.box_admm import box_admm_solve as j_box  # noqa: E402
from polympc_tpu.qp.types import QPData as JQPData  # noqa: E402
from polympc_torch.nlp import regularize  # noqa: E402
from polympc_torch.nlp.sqp import sqp_solve  # noqa: E402
from polympc_torch.parallel import make_batch_solver  # noqa: E402
from polympc_torch.qp import box_admm_solve  # noqa: E402
from polympc_torch.qp.types import ADMMSettings  # noqa: E402
from polympc_torch.utils import convert  # noqa: E402
from polympc_torch.utils import status as st  # noqa: E402

B = 4


@pytest.fixture(scope="module")
def kite_qps():
    """B kite QP subproblems at random points near the rollout guess, as
    the SQP forms them (regularised exact Hessian, shifted bounds)."""
    jtr, jb, jprm, jset = tp.jax_kite()
    nlp = jtr.nlp
    rng = np.random.default_rng(21)
    x0s = tp.headline.bench_x0s(512)[:B].astype(np.float64)
    z0 = jax.vmap(lambda x: jtr.rollout_guess(x, jprm))(jnp.asarray(x0s))
    z = z0 + 0.05 * rng.normal(size=z0.shape)
    lam = jnp.asarray(rng.normal(size=(B, nlp.m)))
    H = jax.vmap(lambda a, b: j_regularize(nlp.lag_hessian(a, b, jprm),
                                           "mirror", 1e-6))(z, lam)
    c = jax.vmap(nlp.eq, (0, None))(z, jprm)
    qp = JQPData(H=H, h=jax.vmap(jax.grad(nlp.cost), (0, None))(z, jprm),
                 A=jax.vmap(nlp.eq_jac, (0, None))(z, jprm), al=-c, au=-c,
                 xl=jb.lbx[None] - z, xu=jb.ubx[None] - z)
    qp_np = JQPData(*(np.asarray(a) for a in qp))
    return jtr, jset, qp_np, np.asarray(lam)


@pytest.mark.parametrize("solver", ["bbt", "lu"])
def test_box_admm_matches_jax(kite_qps, solver):
    jtr, jset, qp, lam = kite_qps
    jqs = jset.qp if solver == "bbt" else dataclasses.replace(
        jset.qp, kkt_solver="lu", structure=None)
    want = jax.vmap(lambda q, y: j_box(q, y0=y, settings=jqs))(
        JQPData(*(jnp.asarray(a) for a in qp)), jnp.asarray(lam))
    ttr = tp.torch_kite()[0]
    tqs = dataclasses.replace(
        tp.torch_kite()[3].qp,
        **({} if solver == "bbt" else {"kkt_solver": "lu",
                                       "structure": None}))
    assert (tqs.structure is None) == (solver == "lu")
    got = box_admm_solve(convert.qp_data(qp, device="cpu"), y0=tp.t64(lam),
                         settings=tqs)
    np.testing.assert_array_equal(got.status.numpy(),
                                  np.asarray(want.status))
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    for f in ("x", "y", "y_box", "res_prim", "res_dual"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-9, atol=1e-9, err_msg=f)
    # adaptive rho scales by sqrt(relative residual ratio); the residuals
    # are differences of nearly equal terms (~1e-5 of O(1) values), so
    # 1e-12 iterate differences reach rho at ~1e-7 relative
    np.testing.assert_allclose(got.rho.numpy(), np.asarray(want.rho),
                               rtol=1e-6)
    assert ttr.bbt_structure() == tp.torch_kite()[3].qp.structure


def test_box_admm_refuses_unported_options(kite_qps):
    """Polish and Ruiz equilibration are ported; the JAX package's name of
    the kernel setting, "pallas", is not an option of the port ("kernel")."""
    qp = convert.qp_data(kite_qps[2], device="cpu")
    for kw in (dict(polish=True), dict(polish=False, equil_iters=2)):
        with tp.one_thread():
            sol = box_admm_solve(qp, settings=ADMMSettings(max_epochs=1,
                                                           **kw))
        assert torch.isfinite(sol.x).all()
    with pytest.raises(ValueError, match="invalid ADMM settings"):
        box_admm_solve(qp, settings=ADMMSettings(kkt_solver="pallas"))


@pytest.mark.parametrize("mode", ["none", "gershgorin", "eigen", "eigmin",
                                  "mirror", "clip", "ridge"])
def test_regularize_matches_jax(mode):
    rng = np.random.default_rng(5)
    H = rng.normal(size=(3, 12, 12))
    H = H + H.transpose(0, 2, 1)
    H[2] *= 1e-3
    want = jax.vmap(lambda h: j_regularize(h, mode, 1e-6))(jnp.asarray(H))
    got = regularize(tp.t64(H), mode, 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9,
                               atol=1e-9)


@pytest.fixture(scope="module")
def kite_batch():
    jtr, jb, jprm, jset = tp.jax_kite()
    x0s = tp.headline.bench_x0s(512)[:B].astype(np.float64)
    jsol = j_mbs(jtr, jb, jprm, jset, rollout_guess=True)(jnp.asarray(x0s))
    ttr, tb, tprm, tset = tp.torch_kite()
    tsol = make_batch_solver(ttr, tb, tprm, tset, rollout_guess=True)(
        tp.t64(x0s))
    return jsol, tsol


def test_batch_solver_status_and_iters_match_jax(kite_batch):
    jsol, tsol = kite_batch
    np.testing.assert_array_equal(tsol.status.numpy(),
                                  np.asarray(jsol.status))
    np.testing.assert_array_equal(tsol.iters.numpy(), np.asarray(jsol.iters))
    np.testing.assert_array_equal(tsol.qp_iters.numpy(),
                                  np.asarray(jsol.qp_iters))


@pytest.mark.parametrize("field", ["x", "lam", "lam_box"])
def test_batch_solver_solution_matches_jax(kite_batch, field):
    jsol, tsol = kite_batch
    got = getattr(tsol, field).numpy()
    want = np.asarray(getattr(jsol, field))
    assert np.abs(got - want).max() <= 1e-6


def test_batch_solver_diagnostics_match_jax(kite_batch):
    jsol, tsol = kite_batch
    for f in ("cost", "primal_step", "dual_step", "violation"):
        np.testing.assert_allclose(getattr(tsol, f).numpy(),
                                   np.asarray(getattr(jsol, f)),
                                   rtol=1e-6, atol=1e-9, err_msg=f)
    assert set(tsol.status.tolist()) <= {st.SOLVED, st.MAX_ITER_EXCEEDED}


def test_sqp_refuses_unported_modes():
    tr, b, prm, s = tp.torch_kite()
    z = tr.initial_guess(device="cpu")[None]
    for kw, slice_ in ((dict(hessian="bfgs"), "slice 3"),
                       (dict(hessian="exact", line_search="filter"),
                        "slice 3")):
        with pytest.raises(NotImplementedError, match=slice_):
            sqp_solve(tr.nlp, z, p=prm, bounds=b,
                      settings=dataclasses.replace(s, **kw))


def test_rollout_guess_overwrites_caller_z0s():
    """Kept from the JAX package (a known fault there): with
    rollout_guess=True a caller's start point is replaced by the rollout."""
    tr, b, prm, s = tp.torch_kite()
    s1 = dataclasses.replace(s, max_iter=1)
    x0 = tp.t64(tp.headline.bench_x0s(2))
    solve = make_batch_solver(tr, b, prm, s1, rollout_guess=True)
    a = solve(x0)
    c = solve(x0, z0s=torch.ones((2, tr.nlp.n), dtype=torch.float64))
    torch.testing.assert_close(a.x, c.x)
