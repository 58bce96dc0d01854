"""The port's long-horizon Newton engine (``parallel/long_horizon.py``)
against the JAX package's, in float64 on the CPU:

  * twins of tests/test_long_horizon.py: the linear and the nonlinear
    problem converge; the step on a one-rank gloo ``horizon_mesh(1)``
    equals the mesh-less step bit for bit and the JAX package's step
    sharded over ``horizon_mesh(8)`` within its test's 1e-7; the solution
    integrates the dynamics (scipy's ``solve_ivp`` oracle);
  * one Newton step on the same numpy inputs, with the pendulum and with
    ``kite_ocp`` (a Mayer term on the last segment, static data d): Z,
    LAM and the continuity residual each within 1e-10 of its largest entry
    (at least 1): the head pin's weight 1e6 and delta 1e-8 make the KKT
    ill-conditioned, and the kite's multipliers reach 1e3..1e4;
  * 12 iterations: every hist entry within 1e-9, Z within 1e-8;
  * B = 3 lanes equal three single calls bit for bit;
  * the damping branch on a lane whose full step overflows: the lane
    takes half steps as in the JAX package, and the other lane of the
    batch is untouched;
  * ``NotImplementedError`` when ``ocp.np_`` is set;
  * the card path's harness (``long_horizon_point``) at S = 16, B = 2 on
    the record's lane 0 and lane 1 x0s, against the JAX package solved
    here, and the record itself (tests/data/long_horizon_jax_cpu.npz).
"""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_parity as tp  # noqa: E402
from _torch_parity import single_thread  # noqa: E402,F401
from polympc_tpu.basis import Chebyshev as JChebyshev  # noqa: E402
from polympc_tpu.models import kite_ocp as j_kite_ocp  # noqa: E402
from polympc_tpu.ocp.ocp import OCP as JOCP  # noqa: E402
from polympc_tpu.parallel import long_horizon as jl  # noqa: E402
from polympc_tpu.parallel.horizon import horizon_mesh as j_mesh  # noqa: E402
from polympc_torch import long_horizon_point as lp  # noqa: E402
from polympc_torch.basis import Chebyshev  # noqa: E402
from polympc_torch.models import kite_ocp  # noqa: E402
from polympc_torch.ocp.ocp import OCP  # noqa: E402
from polympc_torch.parallel import long_horizon as tl  # noqa: E402

RECORD = Path(__file__).resolve().parent / "data" / \
    "long_horizon_jax_cpu.npz"
STEP_TOL = 1e-10
HIST_TOL = 1e-9
Z_TOL = 1e-8
SHARDED_TOL = 1e-7
# the blow-up lane's control sentinel: 1e-300 cosh(BLOW u) overflows to
# inf where |u| > 710 / BLOW, and is below 1e-80 elsewhere on the path
BLOW = 17.5


def _j_pend(blow=False):
    def dyn(x, u, p, d, t):
        extra = 1e-300 * jnp.cosh(BLOW * u[0]) if blow else 0.0
        return jnp.array([x[1], -jnp.sin(x[0]) - 0.2 * x[1] + u[0] + extra])

    def lag(x, u, p, d, t):
        return x @ x + 0.1 * (u @ u)

    return JOCP(nx=2, nu=1, dynamics=dyn, lagrange=lag)


def _t_pend(blow=False):
    def dyn(x, u, p, d, t):
        extra = 1e-300 * torch.cosh(BLOW * u[0]) if blow else 0.0
        return torch.stack([x[1], -torch.sin(x[0]) - 0.2 * x[1] + u[0]
                            + extra])

    def lag(x, u, p, d, t):
        return x @ x + 0.1 * (u @ u)

    return OCP(nx=2, nu=1, dynamics=dyn, lagrange=lag)


def _t_lqr():
    A = torch.tensor([[0.0, 1.0], [-1.0, -0.5]], dtype=torch.float64)
    B = torch.tensor([[0.0], [1.0]], dtype=torch.float64)

    def dyn(x, u, p, d, t):
        return A.to(x.dtype) @ x + B.to(x.dtype) @ u

    def lag(x, u, p, d, t):
        return x @ x + 0.1 * (u @ u)

    return OCP(nx=2, nu=1, dynamics=dyn, lagrange=lag)


def _pair(j_ocp, t_ocp, order, S, t0, tf):
    return (jl.LongHorizon(j_ocp, JChebyshev(order), S=S, t0=t0, tf=tf),
            tl.LongHorizon(t_ocp, Chebyshev(order), S=S, t0=t0, tf=tf))


def _solve(lh, x0, iters, **kw):
    return tl.solve_long_horizon(lh, x0, iters=iters, device="cpu", **kw)


def test_long_horizon_linear_converges():
    lh = tl.LongHorizon(_t_lqr(), Chebyshev(4), S=4, t0=0.0, tf=4.0)
    Z, LAM, hist = _solve(lh, [1.0, 0.0], 6)
    assert Z.shape == (4, lh.nz) and LAM.shape == (4, lh.ne)
    assert hist[-1]["defect"] < 1e-7, hist
    assert hist[-1]["continuity"] < 1e-6, hist
    X, _ = lh.split(Z)
    np.testing.assert_allclose(X[0, 0].numpy(), [1.0, 0.0], atol=1e-4)


def test_long_horizon_nonlinear_converges():
    lh = tl.LongHorizon(_t_pend(), Chebyshev(4), S=8, t0=0.0, tf=4.0)
    Z, LAM, hist = _solve(lh, [2.0, 0.0], 12)
    assert hist[-1]["defect"] < 1e-6, hist[-3:]
    assert hist[-1]["continuity"] < 1e-5, hist[-3:]


def test_long_horizon_sharded_matches_local():
    """The step on a one-rank gloo horizon_mesh(1) (this process builds
    every block and gathers over a group of one) equals the mesh-less step
    bit for bit; both are within 1e-7 of the JAX package's step sharded
    over horizon_mesh(8)."""
    import torch.distributed as dist
    from polympc_torch.multichip_point import free_port
    from polympc_torch.parallel import horizon_mesh, initialize_multihost
    jlh, tlh = _pair(_j_pend(), _t_pend(), 4, 8, 0.0, 4.0)
    x0 = np.array([1.5, 0.0])
    Z = tlh.initial_guess(x0, device="cpu")
    LAM = torch.zeros((8, tlh.ne), dtype=torch.float64)
    local = tl.long_horizon_newton_step(tlh, Z, LAM, tp.t64(x0))
    initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0, device="cpu")
    try:
        assert dist.get_backend() == "gloo"
        sharded = tl.long_horizon_newton_step(tlh, Z, LAM, tp.t64(x0),
                                              mesh=horizon_mesh(1))
    finally:
        dist.destroy_process_group()
    for a, b in zip(sharded, local):
        assert torch.equal(a, b)
    mesh = j_mesh(8)
    jZ = jlh.initial_guess(jnp.asarray(x0))
    want = jax.jit(lambda Z, L: jl.long_horizon_newton_step(
        jlh, Z, L, jnp.asarray(x0), mesh=mesh))(jZ, jnp.zeros((8, jlh.ne)))
    for a, b in zip(sharded, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=SHARDED_TOL)


def test_long_horizon_matches_trajectory_oracle():
    """The defect-free solution integrates the dynamics: the state
    trajectory against scipy's ODE solve under the recovered control,
    interpolated with each segment's Lagrange basis."""
    from scipy.integrate import solve_ivp
    lh = tl.LongHorizon(_t_pend(), Chebyshev(5), S=4, t0=0.0, tf=2.0)
    Z, _, hist = _solve(lh, [1.0, 0.0], 12)
    assert hist[-1]["defect"] < 1e-7
    X, U = (a.numpy() for a in lh.split(Z))
    times = lh.times

    def u_of_t(t):
        s = min(int((t - lh.t0) / ((lh.tf - lh.t0) / lh.S)), lh.S - 1)
        t0s, tfs = times[s, 0], times[s, -1]
        tau = 2.0 * (t - t0s) / (tfs - t0s) - 1.0
        P = lh.basis.interp_matrix([np.clip(tau, -1.0, 1.0)])
        return float((P @ U[s, :, 0]).item())

    def dyn(t, x):
        return [x[1], -np.sin(x[0]) - 0.2 * x[1] + u_of_t(t)]

    sol = solve_ivp(dyn, [0.0, 2.0], X[0, 0], rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(X[-1, -1], sol.y[:, -1], atol=5e-3)


def _kite_pair():
    return _pair(j_kite_ocp(), kite_ocp(), 4, 4, 0.0, 2.0)


@pytest.mark.parametrize("problem", ["pendulum", "kite"])
def test_newton_step_matches_jax(problem):
    """One step from the constant guess perturbed by 0.3 N(0, 1) with
    multipliers 0.3 N(0, 1), on the same numpy inputs."""
    if problem == "pendulum":
        jlh, tlh = _pair(_j_pend(), _t_pend(), 4, 8, 0.0, 4.0)
        x0, d = np.array([1.5, 0.2]), None
    else:
        jlh, tlh = _kite_pair()
        x0, d = np.array([0.5, 0.2, 0.1]), np.array([0.6, 0.3])
    rng = np.random.default_rng(2)
    S = tlh.S
    Z = tlh.initial_guess(x0, device="cpu").numpy() + \
        0.3 * rng.normal(size=(S, tlh.nz))
    LAM = 0.3 * rng.normal(size=(S, tlh.ne))
    jd = None if d is None else jnp.asarray(d)
    want = jl.long_horizon_newton_step(jlh, jnp.asarray(Z), jnp.asarray(LAM),
                                       jnp.asarray(x0), jd)
    got = tl.long_horizon_newton_step(tlh, tp.t64(Z), tp.t64(LAM),
                                      tp.t64(x0),
                                      None if d is None else tp.t64(d))
    for name, g, w in zip(("Z", "LAM", "cont"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=STEP_TOL * max(np.abs(w).max(), 1.0),
                                   err_msg=name)


@pytest.mark.parametrize("problem", ["pendulum", "kite"])
def test_twelve_iterations_match_jax(problem):
    if problem == "pendulum":
        jlh, tlh = _pair(_j_pend(), _t_pend(), 4, 8, 0.0, 4.0)
        x0, d = [2.0, 0.0], None
    else:
        jlh, tlh = _kite_pair()
        x0, d = [0.5, 0.2, 0.1], [0.6, 0.3]
    Zj, Lj, hj = jl.solve_long_horizon(
        jlh, x0=x0, iters=12, d=None if d is None else jnp.asarray(d))
    Zt, Lt, ht = _solve(tlh, x0, 12, d=d)
    assert len(ht) == 12
    for a, b in zip(ht, hj):
        assert isinstance(a["defect"], float)
        for k in ("defect", "continuity"):
            assert abs(a[k] - b[k]) <= HIST_TOL, (k, a, b)
    np.testing.assert_allclose(Zt.numpy(), np.asarray(Zj), rtol=0,
                               atol=Z_TOL)


def test_lanes_equal_single_calls():
    lh = tl.LongHorizon(_t_pend(), Chebyshev(4), S=8, t0=0.0, tf=4.0)
    x0s = np.array([[2.0, 0.0], [1.0, -0.5], [-1.5, 0.7]])
    Zb, Lb, hb = _solve(lh, x0s, 12)
    assert Zb.shape == (3, 8, lh.nz) and hb[0]["defect"].shape == (3,)
    for i, x0 in enumerate(x0s):
        Z, L, h = _solve(lh, x0, 12)
        assert torch.equal(Z, Zb[i]) and torch.equal(L, Lb[i])
        for k in ("defect", "continuity"):
            assert [e[k] for e in h] == [e[k][i] for e in hb], k


def test_damping_on_a_lane_that_blows_up():
    """Lane 1 starts at (20, 0): its full Newton steps ask for controls
    near -57, where the sentinel cosh(17.5 u) overflows and the defect is
    inf.  The solver then takes half the step, as the JAX package does:
    after one iteration the lane sits halfway (finite), its second half
    step still overflows and NaN follows; the port's hist and Z of the
    lane follow the JAX package's, inf and NaN included.  Lane 0 at
    (2, 0) never blows up and equals its single call bit for bit."""
    jlh, tlh = _pair(_j_pend(True), _t_pend(True), 4, 4, 0.0, 2.0)
    x0s = np.array([[2.0, 0.0], [20.0, 0.0]])
    Z = tlh.initial_guess(x0s, device="cpu")
    L = torch.zeros((2, 4, tlh.ne), dtype=torch.float64)
    Z2, L2, _ = tl.long_horizon_newton_step(tlh, Z, L, tp.t64(x0s))
    full = tl._defect_norm(tlh, Z2, torch.zeros(0, dtype=torch.float64))
    assert torch.isfinite(full[0]) and not torch.isfinite(full[1])
    Z1, L1, h1 = _solve(tlh, x0s, 1)
    assert torch.equal(Z1[0], Z2[0]) and torch.equal(L1[0], L2[0])
    assert torch.equal(Z1[1], 0.5 * (Z[1] + Z2[1]))
    assert np.isfinite(h1[0]["defect"]).all()
    Zj, _, _ = jl.solve_long_horizon(jlh, x0=x0s[1], iters=1)
    np.testing.assert_allclose(Z1[1].numpy(), np.asarray(Zj), rtol=0,
                               atol=Z_TOL)
    Zb, Lb, hb = _solve(tlh, x0s, 3)
    _, _, hj = jl.solve_long_horizon(jlh, x0=x0s[1], iters=3)
    got = [h["defect"][1] for h in hb]
    want = [h["defect"] for h in hj]
    assert np.isfinite(got[0]) and not np.isfinite(got[1:]).any()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=HIST_TOL)
    Z0, L0, h0 = _solve(tlh, x0s[0], 3)
    assert torch.equal(Z0, Zb[0]) and torch.equal(L0, Lb[0])
    assert [h["defect"] for h in h0] == [h["defect"][0] for h in hb]


def test_global_parameters_are_refused():
    ocp = OCP(nx=2, nu=1, np_=1, dynamics=lambda x, u, p, d, t: x)
    with pytest.raises(NotImplementedError, match="global parameters"):
        tl.LongHorizon(ocp, Chebyshev(4), S=4, t0=0.0, tf=1.0)


def test_record_holds_the_harness_draw():
    """The committed JAX record: the harness's x0s, its shapes, under 1 MB,
    and the card path's gates hold on it."""
    assert RECORD.stat().st_size < 1024 * 1024
    rec = np.load(RECORD)
    B, S, it = lp.LANES, lp.SEGMENTS, lp.ITERS
    np.testing.assert_array_equal(rec["x0s"], lp.lane_x0s())
    np.testing.assert_array_equal(rec["x0s"][0], [2.0, 0.0])
    assert rec["defect"].shape == rec["continuity"].shape == (it, B)
    assert rec["boundary"].shape == (B, S, 2)
    assert rec["Z01"].shape == (2, S, lp.long_horizon(S).nz)
    assert rec["defect"][-1].max() <= 1e-7
    assert rec["continuity"][-1].max() <= 1e-10
    np.testing.assert_array_equal(
        rec["Z01"][:, :, (lp.ORDER) * 2:(lp.ORDER + 1) * 2],
        rec["boundary"][:2])


def test_split_timer_raises_when_a_half_is_not_called():
    """The harness's split reads the engine's two halves; a block in which
    either was not called (the engine renamed or fused it) raises instead
    of reporting 0 s."""
    with pytest.raises(RuntimeError, match="no call of"):
        with lp.split_timer("cpu"):
            pass


def test_harness_matches_jax_on_record_lanes():
    """long_horizon_point.run at S = 16, B = 2 from the record's lane 0
    and lane 1 x0s, against the JAX package on the same pendulum: hist
    within 1e-9, boundary states and Z within 1e-8."""
    rec = np.load(RECORD)
    x0s = rec["x0s"][:2]
    summary, lanes = lp.run(2, 16, "cpu", reps=1, warmup=False, x0s=x0s)
    assert summary["batch"] == 2 and summary["segments"] == 16
    assert summary["interface_unknowns"] == 30
    assert 0.0 < summary["interface_share"] < 1.0
    assert 0.0 < summary["blocks_share"] < 1.0
    jlh = jl.LongHorizon(_j_pend(), JChebyshev(lp.ORDER), S=16, t0=0.0,
                         tf=lp.SEG_LEN * 16)
    for b, x0 in enumerate(x0s):
        Z, _, hist = jl.solve_long_horizon(jlh, x0=x0, iters=lp.ITERS)
        for k in ("defect", "continuity"):
            np.testing.assert_allclose(lanes[k][:, b], [h[k] for h in hist],
                                       rtol=0, atol=HIST_TOL, err_msg=k)
        np.testing.assert_allclose(lanes["Z"][b], np.asarray(Z), rtol=0,
                                   atol=Z_TOL)
        X = np.asarray(Z)[:, :jlh.ne].reshape(16, jlh.N, 2)
        np.testing.assert_allclose(lanes["boundary"][b], X[:, -1], rtol=0,
                                   atol=Z_TOL)
