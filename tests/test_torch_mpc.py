"""Parity of the port's MPC layer (polympc_torch.control: MPC, NMPC, NMPF;
polympc_torch.models: robot_ocp, cstr_ocp; rk4_integrate; the warm-state
checkpoint) with the JAX package's, in float64 on the CPU.

Each case is tests/test_control.py's, tests/test_nmpc_collocation.py's or
tests/test_nmpf.py's, built in both packages from the same numbers.  On
the robot and the kite (NMPF) the status, SQP iteration count and cost of
every solve (cold and warm-started) equal the JAX facade's, the solution
within 1e-8, the Lagrange interpolation ``solution_x_at`` within 1e-10.

The CSTR (|lambda| ~ 1e5) amplifies rounding: the first SQP iteration's
record agrees to 5e-12 - 2e-8 relative, but the iterates part by iteration 7-11
and the packages stop up to six iterations apart (both SOLVED, at the same
optimum within the SQP's tolerances).  Its cases hold the status, the
first iteration's trace row of a cold solve at 1e-6, the cost at 1e-5 relative, the
solution and the first control within 1e-2 (scaled units; the SQP stops
on steps of 1e-3) and
the reference's optimum 12262.6 (rtol 1e-3), not the iteration count.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import single_thread  # noqa: E402,F401
from polympc_tpu.basis import Chebyshev as JCheb  # noqa: E402
from polympc_tpu.basis import SegmentedBasis as JSeg  # noqa: E402
from polympc_tpu.control import MPC as JMPC  # noqa: E402
from polympc_tpu.control import NMPC as JNMPC  # noqa: E402
from polympc_tpu.control import NMPF as JNMPF  # noqa: E402
from polympc_tpu.models import cstr_ocp as j_cstr_ocp  # noqa: E402
from polympc_tpu.models import kite_dynamics as j_kite_dyn  # noqa: E402
from polympc_tpu.models import kite_output as j_kite_out  # noqa: E402
from polympc_tpu.models import kite_path as j_kite_path  # noqa: E402
from polympc_tpu.models import robot_ocp as j_robot_ocp  # noqa: E402
from polympc_tpu.models.cstr import _cstr_rhs as j_cstr_rhs  # noqa: E402
from polympc_tpu.nlp import SQPSettings as JSQP  # noqa: E402
from polympc_tpu.ocp import rk4_integrate as j_rk4  # noqa: E402
from polympc_tpu.qp.types import ADMMSettings as JADMM  # noqa: E402
from polympc_torch.basis import Chebyshev, SegmentedBasis  # noqa: E402
from polympc_torch.control import MPC, NMPC, NMPF  # noqa: E402
from polympc_torch.models import (  # noqa: E402
    CSTR_ULB, CSTR_US, CSTR_UUB, CSTR_X0, CSTR_XS, cstr_ocp, kite_dynamics,
    kite_output, kite_path, robot_ocp)
from polympc_torch.models.cstr import _cstr_rhs  # noqa: E402
from polympc_torch.nlp import SQPSettings  # noqa: E402
from polympc_torch.ocp import rk4_integrate  # noqa: E402
from polympc_torch.qp.types import ADMMSettings  # noqa: E402
from polympc_torch.utils import status as st  # noqa: E402

QP = dict(eps_abs=1e-6, eps_rel=1e-6, max_epochs=40)
CSTR_QP = dict(rho=1.0, eps_abs=1e-5, eps_rel=1e-5, max_epochs=40,
               equil_iters=4)
CSTR_SCALES = dict(x_scale=[2.0, 1.0, 100.0, 100.0], u_scale=[15.0, 2000.0])
CSTR_XB = ([0.0, 0.0, 50.0, 50.0], [6.0, 4.0, 150.0, 150.0])


def _pair(kind, hessian, max_iter, qp, guess=True, trace=0):
    """(JAX MPC, port MPC) of tests/test_control.py's set-up."""
    out = []
    for pkg in ("jax", "torch"):
        Mpc, Seg, Cheb = (JMPC, JSeg, JCheb) if pkg == "jax" else \
            (MPC, SegmentedBasis, Chebyshev)
        Set, Adm = (JSQP, JADMM) if pkg == "jax" else (SQPSettings,
                                                        ADMMSettings)
        kw = {} if pkg == "jax" else {"device": "cpu"}
        settings = Set(hessian=hessian, max_iter=max_iter, qp=Adm(**qp),
                       trace_iters=trace)
        if kind == "robot":
            ocp = j_robot_ocp() if pkg == "jax" else robot_ocp()
            m = Mpc(ocp, Seg(Cheb(5), 2), t0=0.0, tf=2.0, settings=settings,
                    **kw)
            m.set_static_parameters([2.0])
            m.control_bounds([-1.5, -0.75], [1.5, 0.75])
            m.initial_conditions([0.5, 0.5, 0.5])
            if guess:
                m.x_guess([0.5, 0.5, 0.5])
        else:
            ocp = j_cstr_ocp() if pkg == "jax" else cstr_ocp()
            m = Mpc(ocp, Seg(Cheb(5), 2), t0=0.0, tf=100.0,
                    settings=settings, **CSTR_SCALES, **kw)
            m.control_bounds(CSTR_ULB, CSTR_UUB)
            m.state_bounds(*CSTR_XB)
            m.initial_conditions(CSTR_X0)
            m.x_guess(CSTR_X0)
            m.u_guess([14.19, -1113.5])
        out.append(m)
    return out


def _np(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _same_solve(js, ts, x_atol=1e-8):
    assert int(ts.status) == int(js.status)
    assert int(ts.iters) == int(js.iters)
    assert int(ts.qp_iters) == int(js.qp_iters)
    np.testing.assert_allclose(float(ts.cost), float(js.cost), rtol=1e-10)
    np.testing.assert_allclose(_np(ts.x), _np(js.x), rtol=0, atol=x_atol)


def _same_optimum(js, ts, cold):
    """The CSTR's hold (see the module docstring); a cold solve's first
    iteration too (a warm one starts from its package's last optimum)."""
    assert int(ts.status) == int(js.status) == st.SOLVED
    if cold:
        np.testing.assert_allclose(_np(ts.trace)[0], _np(js.trace)[0],
                                   rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(float(ts.cost), float(js.cost), rtol=1e-5)
    np.testing.assert_allclose(_np(ts.x), _np(js.x), rtol=0, atol=1e-2)


def _cold_warm(kind, hessian, max_iter, qp, x1, trace=0):
    jm, tm = _pair(kind, hessian, max_iter, qp, trace=trace)
    sols = [(jm.solve(), tm.solve())]
    for m in (jm, tm):
        m.initial_conditions(x1)
    sols.append((jm.solve(), tm.solve()))
    return jm, tm, sols


@pytest.fixture(scope="module")
def robot_exact():
    return _cold_warm("robot", "exact", 100, QP, [0.51, 0.49, 0.5])


@pytest.fixture(scope="module")
def cstr_block_bfgs():
    return _cold_warm("cstr", "block_bfgs", 150, CSTR_QP,
                      [1.1, 0.508, 100.5, 100.1], trace=1)


def test_mpc_robot_matches_jax(robot_exact):
    jm, tm, sols = robot_exact
    for js, ts in sols:
        assert int(ts.status) == st.SOLVED
        _same_solve(js, ts)
    assert int(sols[1][1].iters) <= int(sols[0][1].iters)
    X = _np(tm.solution_x())
    np.testing.assert_allclose(X, _np(jm.solution_x()), atol=1e-8)
    np.testing.assert_allclose(X[0], [0.51, 0.49, 0.5], atol=1e-6)
    t = [0.0, 0.123, 1.0, 1.456, 2.0]
    np.testing.assert_allclose(_np(tm.solution_x_at(t)),
                               _np(jm.solution_x_at(t)), rtol=0, atol=1e-10)
    np.testing.assert_allclose(_np(tm.solution_u_at(t)),
                               _np(jm.solution_u_at(t)), rtol=0, atol=1e-10)
    nodes = tm.tr.tau * 2.0
    np.testing.assert_allclose(_np(tm.solution_x_at(nodes)), X, atol=1e-10)


def test_mpc_robot_bfgs_matches_jax():
    """tests/test_control.py's test_mpc_bfgs_warm_start, and the default
    settings of ``sqp_solve`` (dense BFGS) through the facade."""
    jm, tm, sols = _cold_warm("robot", "bfgs", 100, QP, [0.52, 0.48, 0.5])
    for js, ts in sols:
        assert int(ts.status) == st.SOLVED
        _same_solve(js, ts)
    assert int(sols[1][1].iters) <= int(sols[0][1].iters)


def test_mpc_warm_start_carries_box_duals():
    """test_mpc_warm_start_carries_box_duals: a re-solve from the converged
    point with default QP settings stops within 3 iterations."""
    jm, tm = _pair("robot", "exact", 50, {}, guess=False)
    sols = [(jm.solve(), tm.solve()), (jm.solve(), tm.solve())]
    for js, ts in sols:
        assert int(ts.status) == st.SOLVED
        _same_solve(js, ts)
    assert int(sols[1][1].iters) <= 3


def test_mpc_cstr_exact_matches_jax():
    jm, tm, sols = _cold_warm("cstr", "exact", 100, CSTR_QP,
                              [1.1, 0.508, 100.5, 100.1], trace=1)
    for k, (js, ts) in enumerate(sols):
        _same_optimum(js, ts, k == 0)
    np.testing.assert_allclose(float(sols[0][1].cost), 12262.6, rtol=1e-3)
    assert int(sols[1][1].iters) <= int(sols[0][1].iters)


def test_mpc_cstr_block_bfgs_matches_jax(cstr_block_bfgs):
    jm, tm, sols = cstr_block_bfgs
    for k, (js, ts) in enumerate(sols):
        _same_optimum(js, ts, k == 0)
    np.testing.assert_allclose(float(sols[0][1].cost), 12262.6, rtol=1e-3)
    assert int(sols[1][1].iters) <= int(sols[0][1].iters)


def test_mpc_state_round_trip(robot_exact, tmp_path):
    """save_state / load_state in the port, and a file the JAX package
    wrote for the same MPC's warm state."""
    jm, tm, _ = robot_exact
    tm.save_state(tmp_path / "port")
    fresh = _pair("robot", "exact", 100, QP)[1]
    fresh.load_state(tmp_path / "port")
    for a, b in zip(fresh.warm_state(), tm.warm_state()):
        assert torch.equal(a, b)
    jm.save_state(str(tmp_path / "jax"))
    fresh.load_state(tmp_path / "jax.npz")
    for a, b in zip(fresh.warm_state(), jm.warm_state()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="shape"):
        _pair("cstr", "exact", 1, CSTR_QP)[1].load_state(tmp_path / "jax")


def test_nmpc_tracks_cstr_setpoint_matches_jax():
    """tests/test_nmpc_collocation.py's test_nmpc_tracks_cstr_setpoint."""
    ctrls = []
    for pkg in ("jax", "torch"):
        Nm, Set, Adm, rhs = (JNMPC, JSQP, JADMM, j_cstr_rhs) if pkg == "jax" \
            else (NMPC, SQPSettings, ADMMSettings, _cstr_rhs)
        kw = {} if pkg == "jax" else {"device": "cpu"}
        c = Nm(lambda x, u, d, t, rhs=rhs: rhs(x, u), nx=4, nu=2, tf=100.0,
               Q=np.diag([0.2, 1.0, 0.5, 0.2]), R=np.diag([0.5, 5e-7]),
               x_scale=[2.0, 1.0, 100.0, 100.0], u_scale=[35.0, 9000.0],
               settings=Set(hessian="exact", max_iter=80, trace_iters=1,
                            qp=Adm(rho=1.0, eps_abs=1e-6, eps_rel=1e-6,
                                   max_epochs=40, equil_iters=4)), **kw)
        c.set_reference(CSTR_XS, CSTR_US)
        c.control_bounds(CSTR_ULB, CSTR_UUB)
        ctrls.append(c)
    for k, x in enumerate((CSTR_X0,
                           CSTR_X0 + np.array([0.1, 0.008, 0.5, 0.1]))):
        (ju, js), (tu, ts) = (c.compute_control(x) for c in ctrls)
        _same_optimum(js, ts, k == 0)
        us = np.array([35.0, 9000.0])
        np.testing.assert_allclose(tu / us, np.asarray(ju) / us, rtol=0,
                                   atol=1e-2)
    assert int(ts.iters) <= 10
    X = _np(ctrls[1].optimal_trajectory())
    assert abs(X[-1, 0] - CSTR_XS[0]) / CSTR_XS[0] < 0.05


def _nmpf(pkg, **kw):
    Nf, dyn, out, path = (JNMPF, j_kite_dyn, j_kite_out, j_kite_path) \
        if pkg == "jax" else (NMPF, kite_dynamics, kite_output, kite_path)
    if pkg == "torch":
        kw["device"] = "cpu"
        if "settings" in kw:
            kw["settings"] = SQPSettings(
                hessian=kw["settings"], max_iter=100,
                qp=ADMMSettings(rho=1.0, eps_abs=1e-6, eps_rel=1e-6,
                                max_epochs=40, equil_iters=4))
    elif "settings" in kw:
        kw["settings"] = JSQP(
            hessian=kw["settings"], max_iter=100,
            qp=JADMM(rho=1.0, eps_abs=1e-6, eps_rel=1e-6, max_epochs=40,
                     equil_iters=4))
    c = Nf(lambda x, u, dyn=dyn: dyn(x, u), out, path, nx=3, nu=1, ny=2,
           tf=2.0, **kw)
    c.control_bounds([-5, -10], [5, 10])
    c.state_bounds([0, -np.pi / 2, -np.pi, -100, -100],
                   [np.pi / 2, np.pi / 2, np.pi, 100, 100])
    c.set_reference_velocity(0.05)
    return c


@pytest.fixture(scope="module")
def nmpf_pair():
    return _nmpf("jax"), _nmpf("torch")


def test_nmpf_path_projection_matches_jax(nmpf_pair):
    jc, tc = nmpf_pair
    for point in ([0.6, 0.1], [0.3, -0.7], [np.pi / 4, 0.0]):
        np.testing.assert_allclose(
            tc.find_closest_point_on_path(np.array(point)),
            jc.find_closest_point_on_path(np.array(point)), rtol=0,
            atol=1e-12)


def test_nmpf_compute_control_and_warm_start_match_jax(nmpf_pair):
    """test_nmpf.py's test_nmpf_compute_control, then its warm start from
    the next node of the optimal trajectory."""
    jc, tc = nmpf_pair
    x = np.array([np.pi / 4, 0.0, 0.0])
    (ju, js), (tu, ts) = jc.compute_control(x), tc.compute_control(x)
    assert int(ts.status) == st.SOLVED and tu.shape == (2,)
    _same_solve(js, ts)
    np.testing.assert_allclose(tu, np.asarray(ju), rtol=0, atol=1e-8)
    xa = _np(tc.optimal_trajectory())[1]
    np.testing.assert_allclose(xa, _np(jc.optimal_trajectory())[1],
                               atol=1e-8)
    (ju, js), (tu, ts) = jc.compute_control(xa), tc.compute_control(xa)
    assert int(ts.status) == st.SOLVED and int(ts.iters) <= 8
    _same_solve(js, ts)


def test_nmpf_wrap_shifts_the_warm_start(nmpf_pair):
    """A state past the path period wraps s into [0, period) and shifts
    the warm start's s column by the period, in both packages."""
    jc, tc = nmpf_pair
    xa = _np(tc.optimal_trajectory())[1].copy()
    xa[3] += 2.0 * np.pi
    (ju, js), (tu, ts) = jc.compute_control(xa), tc.compute_control(xa)
    _same_solve(js, ts)
    assert int(ts.status) == st.SOLVED


def test_nmpf_block_bfgs_matches_jax():
    x = np.array([np.pi / 4, 0.0, 0.0])
    (ju, js), (tu, ts) = (_nmpf(p, settings="block_bfgs").compute_control(x)
                          for p in ("jax", "torch"))
    assert int(ts.status) == st.SOLVED
    _same_solve(js, ts)
    np.testing.assert_allclose(tu, np.asarray(ju), rtol=0, atol=1e-8)


def test_rk4_integrate_matches_jax():
    """The CSTR plant of examples/cstr_nmpc.py: 20 RK4 steps over 10 s
    under a constant control, a (20, nu) control sequence, and no
    control."""
    rng = np.random.default_rng(2)
    x0 = CSTR_X0 * (1.0 + 0.05 * rng.uniform(-1, 1, 4))
    U = CSTR_US + rng.normal(size=(20, 2)) * [1.0, 50.0]
    for u in (np.asarray(CSTR_US), U):
        want = j_rk4(lambda x, uu, t: j_cstr_rhs(x, uu), jnp.asarray(x0),
                     0.0, 10.0, 20, u=jnp.asarray(u))
        got = rk4_integrate(lambda x, uu, t: _cstr_rhs(x, uu),
                            torch.tensor(x0), 0.0, 10.0, 20,
                            u=torch.tensor(u))
        assert got.shape == (21, 4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13)
    decay = lambda x, u, t: -x * (1.0 + t)
    want = j_rk4(lambda x, u, t: decay(x, u, t), jnp.ones(3), 0.0, 1.0, 8)
    got = rk4_integrate(decay, torch.ones(3, dtype=torch.float64), 0.0, 1.0,
                        8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-14)
