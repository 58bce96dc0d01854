"""Parity of the port's interior-point NLP solver (polympc_torch.nlp.ip)
with the JAX package's, in float64 on the CPU: the cases of
tests/test_nlp_ip.py, two lanes of bench's kite transcription, and
``MPC(solver="ip")`` on the robot quick start.

Each case goes through the port as one batch and through the JAX function
lane by lane: per lane the status and iteration count are equal, x, the
duals and the cost agree to 1e-8 (the same Newton systems through LAPACK
solves, the same Armijo decisions; the duals come out of near-singular
complementarity products, so 1e-8 rather than 1e-10).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from polympc_tpu.nlp import NLP as JNLP
from polympc_tpu.nlp import NLPBounds as JNLPBounds
from polympc_tpu.nlp import IPNLPSettings as JIPNLPSettings
from polympc_tpu.nlp import nlp_ip_solve as j_ip
from polympc_torch.nlp import IPNLPSettings, NLP, NLPBounds, nlp_ip_solve
from polympc_torch.utils import status as st

from tests import _torch_parity as tp
from tests._torch_parity import single_thread  # noqa: F401

TOL = dict(rtol=1e-8, atol=1e-8)
INF = np.inf


def _t(v):
    return torch.tensor(np.asarray(v, np.float64))


def cases():
    """name -> (JAX NLP, port NLP, x0s (B, n), bounds (lbx, ubx, gl, gu) or
    None, settings kwargs)."""
    rosen = lambda x: (1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2
    rosen_b = lambda x, p: ((1.0 - x[:, 0]) ** 2
                            + 100.0 * (x[:, 1] - x[:, 0] ** 2) ** 2)
    H = np.array([[4.0, 1.0], [1.0, 2.0]])
    hv = np.array([1.0, 1.0])
    hs_cost = lambda x: x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2]
    return {
        "rosenbrock": (JNLP(cost=lambda x, p: rosen(x), n=2),
                       NLP(cost=rosen_b, n=2),
                       [[-1.2, 1.0]], None, {}),
        "circle": (JNLP(cost=lambda x, p: rosen(x), n=2,
                        eq=lambda x, p: jnp.array([x @ x - 1.0]), ne=1),
                   NLP(cost=rosen_b, n=2,
                       eq=lambda x, p: (x * x).sum(1, keepdim=True) - 1.0,
                       ne=1),
                   [[0.5, 0.5]], None, {}),
        "simple_constrained": (
            JNLP(cost=lambda x, p: -x[0] - x[1], n=2,
                 ineq=lambda x, p: jnp.array([x @ x]), ni=1),
            NLP(cost=lambda x, p: -x[:, 0] - x[:, 1], n=2,
                ineq=lambda x, p: (x * x).sum(1, keepdim=True), ni=1),
            [[1.2, 0.1]], ([0.0, 0.0], [INF, INF], [1.0], [2.0]), {}),
        "hs071": (
            JNLP(cost=lambda x, p: hs_cost(x), n=4,
                 eq=lambda x, p: jnp.array([x @ x - 40.0]), ne=1,
                 ineq=lambda x, p: jnp.array([x[0] * x[1] * x[2] * x[3]]),
                 ni=1),
            NLP(cost=lambda x, p: hs_cost(x.T), n=4,
                eq=lambda x, p: (x * x).sum(1, keepdim=True) - 40.0, ne=1,
                ineq=lambda x, p: torch.prod(x, 1, keepdim=True), ni=1),
            [[1.0, 5.0, 5.0, 1.0]],
            ([1.0] * 4, [5.0] * 4, [25.0], [INF]), {}),
        "equality_qp": (
            JNLP(cost=lambda x, p: 0.5 * x @ jnp.asarray(H) @ x
                 + jnp.asarray(hv) @ x, n=2,
                 eq=lambda x, p: jnp.array([x[0] + x[1] - 1.0]), ne=1),
            NLP(cost=lambda x, p: 0.5 * ((x @ _t(H)) * x).sum(1)
                + x @ _t(hv), n=2,
                eq=lambda x, p: x.sum(1, keepdim=True) - 1.0, ne=1),
            [[0.5, 0.5]], ([0.0, 0.0], [0.7, 0.7], [], []), {}),
    }


def run_pair(name, x0s=None, settings=None):
    jn, tn, xs, bnd, kw = cases()[name]
    xs = np.asarray(xs if x0s is None else x0s, np.float64)
    tb = jb = None
    if bnd is not None:
        tb = NLPBounds(*(_t(v) for v in bnd))
        jb = JNLPBounds(*(jnp.asarray(np.asarray(v, np.float64))
                          for v in bnd))
    sol = nlp_ip_solve(tn, _t(xs), bounds=tb,
                       settings=settings or IPNLPSettings(**kw))
    jsols = [j_ip(jn, jnp.asarray(x), bounds=jb,
                  settings=JIPNLPSettings(**kw)) for x in xs]
    for b, js in enumerate(jsols):
        assert int(sol.status[b]) == int(js.status), b
        assert int(sol.iters[b]) == int(js.iters), b
        for f in ("x", "lam", "lam_box"):
            np.testing.assert_allclose(getattr(sol, f)[b].numpy(),
                                       np.asarray(getattr(js, f)),
                                       err_msg=f, **TOL)
        for f in ("cost", "mu"):
            np.testing.assert_allclose(getattr(sol, f)[b].item(),
                                       float(getattr(js, f)), err_msg=f,
                                       rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(sol.kkt_error[b].item(),
                                   float(js.kkt_error), rtol=1e-3,
                                   atol=1e-10)
    return sol


@pytest.mark.parametrize("name", ["rosenbrock", "circle",
                                  "simple_constrained", "hs071",
                                  "equality_qp"])
def test_ip_matches_jax(name):
    sol = run_pair(name)
    assert int(sol.status[0]) == st.SOLVED
    want = {"rosenbrock": ([1.0, 1.0], 1e-4),
            "circle": ([0.7864, 0.6177], 1e-2),
            "simple_constrained": ([1.0, 1.0], 1e-2),
            "hs071": ([1.0, 4.743, 3.821, 1.379], 1e-2),
            "equality_qp": ([0.3, 0.7], 1e-5)}[name]
    np.testing.assert_allclose(sol.x[0].numpy(), want[0], atol=want[1])
    if name == "hs071":
        assert float(sol.violation[0]) < 1e-6


def test_ip_batch_of_starts_matches_jax_per_lane():
    """Several starts of the circle problem in one batch, and a max_iter cut
    that stops some lanes at the cap: each lane keeps its own count."""
    starts = np.random.default_rng(1).normal(size=(6, 2))
    run_pair("circle", x0s=starts)
    jn, tn, _, _, _ = cases()["circle"]
    sol = nlp_ip_solve(tn, _t(starts), settings=IPNLPSettings(max_iter=5))
    for b, x in enumerate(starts):
        js = j_ip(jn, jnp.asarray(x), settings=JIPNLPSettings(max_iter=5))
        assert int(sol.status[b]) == int(js.status)
        assert int(sol.iters[b]) == int(js.iters)
        np.testing.assert_allclose(sol.x[b].numpy(), np.asarray(js.x), **TOL)
    assert (sol.status == st.MAX_ITER_EXCEEDED).any()
    assert (sol.status == st.SOLVED).any()


def test_ip_per_lane_parameter_runs_lane_by_lane():
    """tests/test_nlp_ip.py's vmap over a per-lane p: the port's p is shared
    by the lanes of a call, so each lane is its own call."""
    jn = JNLP(cost=lambda x, p: jnp.sum((x - p) ** 2), n=2,
              eq=lambda x, p: jnp.array([x[0] + x[1] - 1.0]), ne=1)
    tn = NLP(cost=lambda x, p: ((x - p) ** 2).sum(1), n=2,
             eq=lambda x, p: x.sum(1, keepdim=True) - 1.0, ne=1)
    x0s = np.random.default_rng(1).normal(size=(6, 2))
    for i, a in enumerate(np.linspace(-1, 1, 6)):
        p = np.full(2, a)
        sol = nlp_ip_solve(tn, _t(x0s[i:i + 1]), p=_t(p))
        js = j_ip(jn, jnp.asarray(x0s[i]), p=jnp.asarray(p))
        assert int(sol.status[0]) == int(js.status) == st.SOLVED
        assert int(sol.iters[0]) == int(js.iters)
        np.testing.assert_allclose(sol.x[0].numpy(), [0.5, 0.5], atol=1e-4)
        np.testing.assert_allclose(sol.x[0].numpy(), np.asarray(js.x), **TOL)


def test_ip_warm_start_duals_matches_jax():
    jn = JNLP(cost=lambda x, p: (x[0] - 2.0) ** 2 + (x[1] + 1.0) ** 2, n=2,
              eq=lambda x, p: jnp.array([x[0] - x[1] - 4.0]), ne=1)
    tn = NLP(cost=lambda x, p: (x[:, 0] - 2.0) ** 2 + (x[:, 1] + 1.0) ** 2,
             n=2, eq=lambda x, p: (x[:, 0] - x[:, 1] - 4.0)[:, None], ne=1)
    s1 = nlp_ip_solve(tn, torch.zeros((1, 2), dtype=torch.float64))
    s2 = nlp_ip_solve(tn, s1.x, lam0=s1.lam)
    j1 = j_ip(jn, jnp.zeros(2))
    j2 = j_ip(jn, j1.x, lam0=j1.lam)
    assert int(s1.iters[0]) == int(j1.iters)
    assert int(s2.iters[0]) == int(j2.iters) <= int(j1.iters)
    assert int(s2.status[0]) == st.SOLVED


@pytest.fixture(scope="module")
def kite_pair():
    """Two lanes of the kite IP batch (bench_x0s(512)[:2]) through both
    packages, float64, default settings."""
    from polympc_torch import solvers_point as sp
    x0s = tp.headline.bench_x0s(512)[:2]
    tr, bounds, prm, _ = tp.torch_kite(torch.float64)
    z0, bnd = sp.kite_ip_start(tr, bounds, tp.t64(x0s))
    with tp.one_thread():
        sol = nlp_ip_solve(tr.nlp, z0, p=prm, bounds=bnd)
    jtr, jbounds, jprm, _ = tp.jax_kite(jnp.float64)
    nx = jtr.ocp.nx
    sx = np.asarray(jtr.x_scale, np.float64)
    solve = jax.jit(lambda z, lb, ub: j_ip(
        jtr.nlp, z, p=jprm, bounds=jbounds._replace(lbx=lb, ubx=ub)))
    jsols = []
    for x0 in x0s.astype(np.float64):
        x0sc = x0 / sx
        z = np.array(jtr.initial_guess(dtype=jnp.float64))
        z[:nx] = x0sc
        lb = np.array(jbounds.lbx, np.float64)
        ub = np.array(jbounds.ubx, np.float64)
        lb[:nx] = ub[:nx] = x0sc
        jsols.append(solve(jnp.asarray(z), jnp.asarray(lb), jnp.asarray(ub)))
    return sol, jsols


def test_kite_two_lanes_match_jax(kite_pair):
    sol, jsols = kite_pair
    for b, js in enumerate(jsols):
        assert int(sol.status[b]) == int(js.status)
        assert int(sol.iters[b]) == int(js.iters)
        np.testing.assert_allclose(sol.cost[b].item(), float(js.cost),
                                   rtol=1e-8)
        np.testing.assert_allclose(sol.x[b].numpy(), np.asarray(js.x),
                                   rtol=1e-6, atol=1e-6)


def test_mpc_with_ip_backend_matches_jax():
    """tests/test_nlp_ip.py::test_mpc_with_ip_backend in both packages:
    the IP route SOLVED, within 1e-3 of the SQP route, its warm re-solve
    SOLVED, and the port's IP solves equal to the JAX package's."""
    from polympc_tpu.basis import Chebyshev as JCheb
    from polympc_tpu.basis import SegmentedBasis as JSeg
    from polympc_tpu.control import MPC as JMPC
    from polympc_tpu.models import robot_ocp as j_robot_ocp
    from polympc_torch.basis import Chebyshev, SegmentedBasis
    from polympc_torch.control import MPC
    from polympc_torch.models import robot_ocp

    def build(cls, ocp, mesh, solver, **kw):
        m = cls(ocp(), mesh, t0=0.0, tf=2.0, solver=solver, **kw)
        m.set_static_parameters([2.0])
        m.control_bounds([-1.5, -0.75], [1.5, 0.75])
        m.initial_conditions([0.5, 0.5, 0.5])
        m.x_guess([0.5, 0.5, 0.5])
        return m

    ip = build(MPC, robot_ocp, SegmentedBasis(Chebyshev(5), 2), "ip",
               device="cpu")
    jip = build(JMPC, j_robot_ocp, JSeg(JCheb(5), 2), "ip")
    sqp = build(MPC, robot_ocp, SegmentedBasis(Chebyshev(5), 2), "sqp",
                device="cpu")
    assert isinstance(ip.settings, IPNLPSettings)
    for step in range(2):
        if step:
            ip.initial_conditions([0.51, 0.49, 0.5])
            jip.initial_conditions([0.51, 0.49, 0.5])
        s, js = ip.solve(), jip.solve()
        assert int(s.status) == int(js.status) == st.SOLVED
        assert int(s.iters) == int(js.iters)
        np.testing.assert_allclose(ip.solution_x().numpy(),
                                   np.asarray(jip.solution_x()), atol=1e-8)
        if not step:
            ssqp = sqp.solve()
            assert int(ssqp.status) == st.SOLVED
            np.testing.assert_allclose(ip.solution_x().numpy(),
                                       sqp.solution_x().numpy(), atol=1e-3)
