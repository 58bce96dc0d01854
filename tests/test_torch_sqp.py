"""Parity of the port's batch-first solvers with the JAX package's vmapped
ones, in float64:

  * ``box_admm_solve`` on B kite QPs, through the BBT epoch with the
    structure and through the dense LU epoch, against
    ``jax.vmap(box_admm_solve)``;
  * ``regularize`` in every mode;
  * the kite ``make_batch_solver`` (bench's settings, rollout guess) at
    B=4: per-lane status and iteration counts equal, x within 1e-6;
  * ``sqp_solve`` on tests/test_sqp.py's oracles (Rosenbrock, Rosenbrock
    on the circle, the simple constrained NLP, HS071) from three start
    points each, with the quasi-Newton Hessians (bfgs, sr1, block_bfgs on
    a declared block structure), the filter line search and the trace:
    per-lane status and iteration counts equal, x within 1e-8, the trace
    equal (NaN where NaN).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_parity as tp  # noqa: E402
from polympc_tpu.nlp import NLP as JNLP  # noqa: E402
from polympc_tpu.nlp import NLPBounds as JNLPBounds  # noqa: E402
from polympc_tpu.nlp import SQPSettings as JSQPSettings  # noqa: E402
from polympc_tpu.nlp import sqp_solve as j_sqp  # noqa: E402
from polympc_tpu.nlp.hessian import regularize as j_regularize  # noqa: E402
from polympc_tpu.qp.types import ADMMSettings as JADMMSettings  # noqa: E402
from polympc_tpu.parallel import make_batch_solver as j_mbs  # noqa: E402
from polympc_tpu.qp.box_admm import box_admm_solve as j_box  # noqa: E402
from polympc_tpu.qp.types import QPData as JQPData  # noqa: E402
from polympc_torch.control import MPC  # noqa: E402
from polympc_torch.models import robot_ocp  # noqa: E402
from polympc_torch.nlp import IPNLPSettings, NLP, NLPBounds, SQPSettings  # noqa: E402,E501
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
    """Every Hessian mode and line search of the JAX package runs in the
    port, and ``MPC(solver="ip")`` runs the interior point; what it
    refuses is what the JAX package refuses too (explicitly tuned settings
    of the other solver's type, unknown modes) and block-BFGS on an NLP
    without a block structure."""
    with pytest.raises(TypeError, match="requires IPNLPSettings"):
        MPC(robot_ocp(), solver="ip", settings=SQPSettings(hessian="bfgs"),
            device="cpu")
    with pytest.raises(TypeError, match="requires SQPSettings"):
        MPC(robot_ocp(), solver="sqp", settings=IPNLPSettings(),
            device="cpu")
    with pytest.raises(ValueError, match="solver must be"):
        MPC(robot_ocp(), solver="qp", device="cpu")
    with pytest.raises(TypeError, match="requires SQPSettings"):
        MPC(robot_ocp(), settings=ADMMSettings(), device="cpu")
    nlp, x0, _, _ = _port_case("rosenbrock")
    with pytest.raises(ValueError, match="invalid SQP settings"):
        sqp_solve(nlp, x0, settings=SQPSettings(hessian="lbfgs"))
    with pytest.raises(ValueError, match="block_structure"):
        sqp_solve(NLP(cost=nlp.cost, n=2), x0,
                  settings=SQPSettings(hessian="block_bfgs"))


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


# ---- sqp_solve on tests/test_sqp.py's oracles, every mode ----

TIGHT = dict(eps_abs=1e-6, eps_rel=1e-6, max_epochs=40)
SQP_CASES = {
    # name: (n, start point, (N, nx, nu, np) of a declared block structure)
    "rosenbrock": (2, [-1.2, 1.0], (1, 1, 1, 0)),
    "circle": (2, [0.5, 0.5], (1, 1, 1, 0)),
    "simple": (2, [1.2, 0.1], (1, 1, 1, 0)),
    "hs071": (4, [1.0, 5.0, 5.0, 1.0], (2, 1, 1, 0)),
}


def _starts(name):
    """Three start points per case: test_sqp.py's and two perturbations
    inside its bounds (numpy, seeded)."""
    n, x0, _ = SQP_CASES[name]
    rng = np.random.default_rng(len(name))
    X = np.asarray(x0) + 0.05 * rng.uniform(-1.0, 1.0, (3, n))
    X[0] = x0
    return np.clip(X, 1.0, 5.0) if name == "hs071" else X


def _jax_case(name):
    n, _, bs = SQP_CASES[name]
    rosen = lambda x, p: (1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2
    inf = jnp.inf
    if name == "rosenbrock":
        return JNLP(cost=rosen, n=n, block_structure=bs), None
    if name == "circle":
        return JNLP(cost=rosen, n=n, eq=lambda x, p: jnp.array([x @ x - 1.0]),
                    ne=1, block_structure=bs), None
    if name == "simple":
        return (JNLP(cost=lambda x, p: -x[0] - x[1], n=n,
                     ineq=lambda x, p: jnp.array([x @ x]), ni=1,
                     block_structure=bs),
                JNLPBounds(lbx=jnp.zeros(2), ubx=jnp.full(2, inf),
                           gl=jnp.array([1.0]), gu=jnp.array([2.0])))
    return (JNLP(cost=lambda x, p: x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2],
                 n=n, eq=lambda x, p: jnp.array([x @ x - 40.0]), ne=1,
                 ineq=lambda x, p: jnp.array([x[0] * x[1] * x[2] * x[3]]),
                 ni=1, block_structure=bs),
            JNLPBounds(lbx=jnp.full(4, 1.0), ubx=jnp.full(4, 5.0),
                       gl=jnp.array([25.0]), gu=jnp.array([inf])))


def _port_case(name):
    """The same NLP, batch-first in the port: (nlp, x0 (3, n), bounds,
    start points in numpy)."""
    n, _, bs = SQP_CASES[name]
    X = _starts(name)
    rosen = lambda x, p: (1.0 - x[:, 0]) ** 2 + 100.0 * (
        x[:, 1] - x[:, 0] ** 2) ** 2
    sq = lambda x: torch.sum(x * x, dim=1, keepdim=True)
    inf = float("inf")
    if name == "rosenbrock":
        nlp, b = NLP(cost=rosen, n=n, block_structure=bs), None
    elif name == "circle":
        nlp, b = NLP(cost=rosen, n=n, eq=lambda x, p: sq(x) - 1.0, ne=1,
                     block_structure=bs), None
    elif name == "simple":
        nlp = NLP(cost=lambda x, p: -x[:, 0] - x[:, 1], n=n,
                  ineq=lambda x, p: sq(x), ni=1, block_structure=bs)
        b = NLPBounds(lbx=tp.t64([0.0, 0.0]), ubx=tp.t64([inf, inf]),
                      gl=tp.t64([1.0]), gu=tp.t64([2.0]))
    else:
        nlp = NLP(cost=lambda x, p: x[:, 0] * x[:, 3] * x[:, :3].sum(1)
                  + x[:, 2], n=n, eq=lambda x, p: sq(x) - 40.0, ne=1,
                  ineq=lambda x, p: torch.prod(x, dim=1, keepdim=True),
                  ni=1, block_structure=bs)
        b = NLPBounds(lbx=tp.t64([1.0] * 4), ubx=tp.t64([5.0] * 4),
                      gl=tp.t64([25.0]), gu=tp.t64([inf]))
    return nlp, tp.t64(X), b, X


# (case, hessian, line search, trace_iters): every quasi-Newton mode on
# every oracle, the filter on two, the trace with an exact, a quasi-Newton
# and a filter run.  SR1 on Rosenbrock is chaotic and has its own test.
MODES = [(c, h, "merit", 0) for c in SQP_CASES
         for h in ("bfgs", "sr1", "block_bfgs")
         if (c, h) != ("rosenbrock", "sr1")]
MODES += [("hs071", "exact", "filter", 0), ("circle", "bfgs", "filter", 40),
          ("rosenbrock", "exact", "merit", 30),
          ("hs071", "bfgs", "merit", 12)]


@pytest.mark.parametrize("case,hessian,line_search,trace", MODES,
                         ids=["-".join(map(str, m)) for m in MODES])
def test_sqp_modes_match_jax(case, hessian, line_search, trace):
    kw = dict(hessian=hessian, line_search=line_search, trace_iters=trace,
              max_iter=150)
    jnlp, jb = _jax_case(case)
    nlp, x0, b, X = _port_case(case)
    js = JSQPSettings(qp=JADMMSettings(**TIGHT), **kw)
    want = jax.jit(jax.vmap(lambda x: j_sqp(jnlp, x, bounds=jb,
                                            settings=js)))(jnp.asarray(X))
    got = sqp_solve(nlp, x0, bounds=b,
                    settings=SQPSettings(qp=ADMMSettings(**TIGHT), **kw))
    np.testing.assert_array_equal(got.status.numpy(),
                                  np.asarray(want.status))
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0,
                               atol=1e-8)
    assert (st.SOLVED == got.status).any()
    if trace:
        wt = np.asarray(want.trace)
        assert got.trace.shape == (3, trace, 4)
        np.testing.assert_array_equal(np.isnan(got.trace.numpy()),
                                      np.isnan(wt))
        np.testing.assert_allclose(got.trace.numpy(), wt, rtol=1e-8,
                                   atol=1e-10)
    else:
        assert got.trace is None and want.trace is None


def test_sqp_default_settings_run():
    """``sqp_solve`` with ``SQPSettings()`` (hessian="bfgs") solves HS071."""
    nlp, x0, b, _ = _port_case("hs071")
    sol = sqp_solve(nlp, x0[:1], bounds=b)
    assert int(sol.status[0]) == st.SOLVED
    np.testing.assert_allclose(sol.x[0].numpy(), [1.0, 4.743, 3.821, 1.379],
                               atol=1e-2)


def test_sqp_sr1_rosenbrock_matches_jax_to_the_optimum():
    """SR1 on Rosenbrock from (-1.2, 1) amplifies a rounding difference of
    the first QP solve (2.7e-13 in the step, summation order) to 1e-3 by
    iteration 25 in either package, so the last iterates differ and a
    lane's count may move by one.  Held here: statuses equal, iteration
    counts within one, and both packages at the optimum (1, 1)."""
    kw = dict(hessian="sr1", max_iter=150)
    jnlp, jb = _jax_case("rosenbrock")
    nlp, x0, b, X = _port_case("rosenbrock")
    js = JSQPSettings(qp=JADMMSettings(**TIGHT), **kw)
    want = jax.vmap(lambda x: j_sqp(jnlp, x, settings=js))(jnp.asarray(X))
    got = sqp_solve(nlp, x0, settings=SQPSettings(qp=ADMMSettings(**TIGHT),
                                                  **kw))
    np.testing.assert_array_equal(got.status.numpy(),
                                  np.asarray(want.status))
    assert (got.status == st.SOLVED).all()
    assert np.abs(got.iters.numpy() - np.asarray(want.iters)).max() <= 1
    for x in (got.x.numpy(), np.asarray(want.x)):
        np.testing.assert_allclose(x, np.ones((3, 2)), atol=1e-3)
