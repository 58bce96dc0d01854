"""The OCP extras' card paths: multiple shooting, Radau meshes, soft
defects, trajectory hooks, identification and the integrators, each as a
user's entry point would run it.

  * :func:`kite_ms` (the path ``kite_ms_b512``): bench's kite problem
    (``headline.kite_ocp``: nx=5, nu=2, d=[0.05], [0, 2]) transcribed by
    multiple shooting, ``transcribe_ms(ocp, 10, 4)`` (n=75, ne=50, ni=0:
    ten segments for the ten node intervals of bench's Chebyshev(5) x 2),
    bench's bounds through ``ms_bounds``, B initial conditions from
    ``bench_x0s``, each lane starting from ``initial_guess(x0)`` with node 0
    pinned; bench's float32 SQP (exact Hessian by ``torch.func`` over the
    whole vector, ``reg="mirror"``, l1 merit, ``max_iter=9``) with 3 x 50
    boxADMM iterations through the dense epoch kernel (a KKT of K=125 with
    no BBT structure: ``epoch_route`` "dense_kernel"), then bench's
    three-stage float64 certify (``headline.certify_pinned``: float32
    LDL^T solves at K=125);
  * :func:`ocp_extras`: one float64 call each of the JAX tests' cases —
    the robot by multiple shooting against its collocation cost, the
    soft-defect robot, the stiff OCP where Radau beats Lobatto, a rate
    constraint through a trajectory hook, ``identify`` on the noise-free
    pendulum, ``adaptive_integrate`` against closed forms and on a step
    exhaustion, and ``ps_integrate`` on the logistic equation.

``chip_smoke.py`` drives both on the card and holds them against
``tests/data/ocp_extras_jax_cpu.npz`` (written by
``tests/data/make_ocp_extras_reference.py``).  Every function runs on
``device`` ("cuda" unless the caller asks for the CPU).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from polympc_torch.headline import KKT_TOL, bench_x0s, certify_pinned, \
    kite_ocp
from polympc_torch.nlp import SQPSettings, sqp_solve
from polympc_torch.ocp import ms_bounds, transcribe_ms
from polympc_torch.qp.box_admm import epoch_route
from polympc_torch.qp.types import ADMMSettings
from polympc_torch.utils import status as st

__all__ = ["MAX_ITER", "ROBOT_X0", "kite_ms_problem", "pin_ms", "batch_fn",
           "kite_ms", "first_epoch", "certify_system", "pendulum_data",
           "ocp_extras"]

MAX_ITER = 9
KITE_XL = [0.0, -np.pi / 2, -np.pi, -100.0, -100.0]
KITE_XU = [np.pi / 2, np.pi / 2, np.pi, 100.0, 100.0]
ROBOT_X0 = [0.5, 0.5, 0.5]


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _card(device):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("ocp_extras_point: no CUDA card (pass "
                           "device='cpu' to run the plain versions)")
    return device


def kite_ms_problem(device="cuda", dtype=torch.float32,
                    max_iter: int = MAX_ITER):
    """The kite by multiple shooting: (tr, bounds, prm, settings), bench's
    settings with the inner QPs on the dense epoch kernel."""
    tr = transcribe_ms(kite_ocp(), num_segments=10, steps_per_segment=4)
    prm = tr.params(d=[0.05], t0=0.0, tf=2.0, dtype=dtype, device=device)
    bounds = ms_bounds(tr, ul=[-5.0, -10.0], uu=[5.0, 10.0], xl=KITE_XL,
                       xu=KITE_XU, dtype=dtype, device=device)
    settings = SQPSettings(
        hessian="exact", max_iter=max_iter, reg="mirror",
        eps_prim=1e-3, eps_dual=1e-3, eps_viol=1e-3, eps_stat=1e-2,
        qp=ADMMSettings(rho=1.0, eps_abs=1e-4, eps_rel=1e-4,
                        max_epochs=3, check_every=50, equil_iters=0,
                        kkt_solver="kernel", polish=False))
    return tr, bounds, prm, settings


def pin_ms(tr, bounds, x0s):
    """Per-lane bounds with node 0 pinned to each lane's x0 (B, nx) (the
    MS layout is unscaled)."""
    B, n, nx = x0s.shape[0], tr.nlp.n, tr.ocp.nx
    lbx = bounds.lbx.to(x0s.dtype).expand(B, n).clone()
    ubx = bounds.ubx.to(x0s.dtype).expand(B, n).clone()
    lbx[:, :nx] = x0s
    ubx[:, :nx] = x0s
    return bounds._replace(lbx=lbx, ubx=ubx)


def batch_fn(B: int = 512, device="cuda", x0s=None,
             max_iter: int = MAX_ITER):
    """The timed unit of ``kite_ms_b512``: a function of no arguments that
    solves (float32) and certifies (float64) the batch and returns
    ``(sols, residuals)`` after a synchronise.  Raises without a card
    (unless ``device`` is the CPU) and where the inner QP would not take
    the dense epoch kernel."""
    device = _card(device)
    tr, bounds, prm, settings = kite_ms_problem(device, max_iter=max_iter)
    route = epoch_route(tr.nlp.n, tr.nlp.m, settings.qp)
    if route != "dense_kernel":
        raise RuntimeError(f"kite_ms: the inner QP (K={tr.nlp.n + tr.nlp.m})"
                           f" takes the {route!r} epoch, not the dense "
                           "epoch kernel")
    prm64 = tr.params(d=[0.05], t0=0.0, tf=2.0, dtype=torch.float64,
                      device=device)
    b64 = bounds._replace(**{f: getattr(bounds, f).to(torch.float64)
                             for f in bounds._fields})
    x0 = torch.as_tensor(bench_x0s(B) if x0s is None else x0s,
                         dtype=torch.float32, device=device)
    bnd = pin_ms(tr, bounds, x0)
    bnd64 = pin_ms(tr, b64, x0.to(torch.float64))
    z0 = tr.initial_guess(x0, dtype=torch.float32, device=device)

    def once():
        sols = sqp_solve(tr.nlp, z0, p=prm, bounds=bnd, settings=settings)
        kkt = certify_pinned(tr.nlp, bnd64, sols, prm64)
        _sync(device)
        return sols, kkt
    return once


def kite_ms(B: int = 512, device="cuda", reps: int = 3, x0s=None,
            warmup: int = 8):
    """Solve and certify the MS kite batch: a warm-up of ``warmup`` lanes
    (0: none), then ``reps`` timed repetitions (synchronised wall clock).

    Returns ``(extra, lanes)``: ``extra`` holds batch, certified,
    status_solved, mean_sqp_iters, kkt_residual_max, wall_s_per_batch (the
    median), walls and certified_per_s; ``lanes`` the per-lane numpy arrays
    residual, certified, status, iters, cost, x and lam."""
    x0 = np.asarray(bench_x0s(B) if x0s is None else x0s, np.float32)
    if warmup:
        batch_fn(warmup, device, x0[:warmup])()
    once = batch_fn(B, device, x0)
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        sols, kkt = once()
        walls.append(time.perf_counter() - t0)
    res = kkt.cpu().numpy()
    ok = res <= KKT_TOL
    wall = float(np.median(walls))
    lanes = {"residual": res, "certified": ok,
             "status": sols.status.cpu().numpy(),
             "iters": sols.iters.cpu().numpy(),
             "cost": sols.cost.double().cpu().numpy(),
             "x": sols.x.cpu().numpy(), "lam": sols.lam.cpu().numpy()}
    extra = {"batch": B, "certified": int(ok.sum()),
             "status_solved": int((lanes["status"] == st.SOLVED).sum()),
             "mean_sqp_iters": float(lanes["iters"].mean()),
             "kkt_residual_max": float(res[ok].max()) if ok.any() else None,
             "wall_s_per_batch": wall, "walls": walls,
             "certified_per_s": float(ok.sum()) / wall}
    return extra, lanes


def first_epoch(B: int = 512, device="cuda", x0s=None):
    """The MS kite batch's first boxADMM epoch as the path runs it
    (``nlp.sqp.first_epoch``): from ``initial_guess(x0)`` with node 0
    pinned and zero multipliers.  Returns (settings.qp, the 13 epoch
    arguments of ``ops.admm_epoch``) in float32."""
    from polympc_torch.nlp import sqp
    device = _card(device)
    tr, bounds, prm, settings = kite_ms_problem(device)
    x0 = torch.as_tensor(bench_x0s(B) if x0s is None else x0s,
                         dtype=torch.float32, device=device)
    z0 = tr.initial_guess(x0, dtype=torch.float32, device=device)
    return settings.qp, sqp.first_epoch(
        tr.nlp, z0, prm, pin_ms(tr, bounds, x0), settings=settings)


def certify_system(x, lam, x0s, device="cuda"):
    """The MS certify's first Newton-KKT matrices (float64, equilibrated;
    K = 125) at a float32 solution (x, lam) of the path, with the Hessian
    evaluated in float32 as the certify does: (Ms, rs)."""
    from polympc_torch.nlp.refine import newton_system
    device = _card(device)
    tr, bounds, _, _ = kite_ms_problem(device)
    prm64 = tr.params(d=[0.05], t0=0.0, tf=2.0, dtype=torch.float64,
                      device=device)
    b64 = bounds._replace(**{f: getattr(bounds, f).to(torch.float64)
                             for f in bounds._fields})
    x0 = torch.as_tensor(x0s, dtype=torch.float64, device=device)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return newton_system(tr.nlp, f32(x), f32(lam), pin_ms(tr, b64, x0),
                         prm64, matrix_dtype=torch.float32)


# ---- the ocp_extras cases (float64, one call each) ----

def _robot_settings(**kw):
    qp = ADMMSettings(eps_abs=1e-6, eps_rel=1e-6, max_epochs=40)
    return SQPSettings(**{"hessian": "exact", "max_iter": 100, "qp": qp,
                          **kw})


def _solve1(tr, prm, bounds, settings, x0=ROBOT_X0):
    dev = prm["tf"].device
    z0 = tr.initial_guess(x0, dtype=torch.float64, device=dev)[None]
    sol = sqp_solve(tr.nlp, z0, p=prm, bounds=bounds, settings=settings)
    return {"status": int(sol.status[0]), "iters": int(sol.iters[0]),
            "cost": float(sol.cost[0])}, sol


def _ms_robot(dev):
    """tests/test_ms.py: the robot by multiple shooting (NS=10, 4 RK4 steps
    a segment) against its collocation cost, and the soft-defect robot."""
    from polympc_torch.basis import Chebyshev, SegmentedBasis
    from polympc_torch.models import robot_ocp
    from polympc_torch.ocp import ocp_bounds, transcribe
    tr = transcribe_ms(robot_ocp(), num_segments=10, steps_per_segment=4)
    prm = tr.params(d=[2.0], t0=0.0, tf=2.0, device=dev)
    b = ms_bounds(tr, ul=[-1.5, -0.75], uu=[1.5, 0.75], x0=ROBOT_X0,
                  device=dev)
    ms, sol = _solve1(tr, prm, b, _robot_settings())
    X = tr.split(sol.x[0])[0]
    ms["x0_error"] = float((X[0] - torch.as_tensor(
        ROBOT_X0, dtype=X.dtype, device=X.device)).abs().max())
    ms["max_abs_eq"] = float(tr.nlp.eq(sol.x, prm).abs().max())
    mesh = lambda: SegmentedBasis(Chebyshev(5), 2)
    tc = transcribe(robot_ocp(), mesh())
    pc = tc.params(d=[2.0], t0=0.0, tf=2.0, device=dev)
    bnd = lambda t: ocp_bounds(t, ul=[-1.5, -0.75], uu=[1.5, 0.75],
                               x0=ROBOT_X0, device=dev)
    col, _ = _solve1(tc, pc, bnd(tc), _robot_settings())
    ms["collocation_cost"] = col["cost"]
    soft = transcribe(robot_ocp(), mesh(), soft_defects=1e4)
    sr, _ = _solve1(soft, pc, bnd(soft), _robot_settings(
        max_iter=150, eps_prim=5e-3, eps_stat=0.5))
    sr["ne"] = soft.nlp.ne
    return ms, sr


def _stiff_solve(basis, NS, dev):
    """tests/test_schemes.py's stiff actuator tracking OCP on a mesh."""
    from polympc_torch.basis import SegmentedBasis
    from polympc_torch.ocp import OCP, ocp_bounds, transcribe
    lam = -50.0
    ocp = OCP(dynamics=lambda x, u, p, d, t: (lam * (x[0] - u[0]))[None],
              nx=1, nu=1,
              lagrange=lambda x, u, p, d, t: (x[0] - 1.0) ** 2
              + 0.1 * u[0] ** 2)
    tr = transcribe(ocp, SegmentedBasis(basis, NS))
    s = SQPSettings(hessian="exact", max_iter=60,
                    qp=ADMMSettings(eps_abs=1e-9, eps_rel=1e-9,
                                    max_epochs=80))
    out, sol = _solve1(tr, tr.params(t0=0.0, tf=1.0, device=dev),
                       ocp_bounds(tr, x0=[0.0], device=dev), s, x0=[0.0])
    tq = np.linspace(0.0, 1.0, 101)
    X = tr.mesh.interp_matrix(tq, 0.0, 1.0) @ sol.x[0, :tr.N].cpu().numpy()
    return out, X


def _stiff(dev):
    """Radau(3) x 4 against Lobatto(3) x 4, each against the
    Legendre(8) x 16 oracle: trajectory and cost errors."""
    from polympc_torch.basis import Legendre, LegendreRadau
    oracle, Xo = _stiff_solve(Legendre(8), 16, dev)
    out = {"oracle": oracle}
    for name, basis in (("lobatto", Legendre(3)),
                        ("radau", LegendreRadau(3))):
        r, X = _stiff_solve(basis, 4, dev)
        r["traj_err"] = float(np.abs(X - Xo).max())
        r["cost_err"] = abs(r["cost"] - oracle["cost"])
        out[name] = r
    return out


def _rate(dev):
    """tests/test_trajectory_hooks.py: the robot with |du/dt| <= 1.2 at
    every node through a trajectory hook, and without it."""
    from polympc_torch.basis import Chebyshev, SegmentedBasis
    from polympc_torch.models import robot_ocp
    from polympc_torch.ocp import ocp_bounds, transcribe
    base = robot_ocp()
    rmax, N = 1.2, 11
    hooked = dataclasses.replace(
        base, trajectory_ineq=lambda X, U, P, d, t, ops: (
            ops.D @ U).reshape(-1), ntg=N * base.nu)
    qp = ADMMSettings(rho=1.0, eps_abs=1e-6, eps_rel=1e-6, max_epochs=40,
                      equil_iters=2)
    out = {}
    for name, ocp, tg in (("rate", hooked, [rmax] * (N * base.nu)),
                          ("free", base, None)):
        tr = transcribe(ocp, SegmentedBasis(Chebyshev(5), 2))
        prm = tr.params(d=[2.0], t0=0.0, tf=2.0, device=dev)
        b = ocp_bounds(tr, ul=[-1.5, -0.75], uu=[1.5, 0.75], x0=ROBOT_X0,
                       tgl=None if tg is None else [-v for v in tg],
                       tgu=tg, device=dev)
        r, sol = _solve1(tr, prm, b, SQPSettings(hessian="exact",
                                                 max_iter=60, qp=qp))
        _, U, _ = tr.unpack(sol.x[0])
        D = tr.Dg_unit / (2.0 / (2.0 * tr.mesh.num_segments))
        r["max_rate"] = float(np.abs(D @ U.cpu().numpy()).max())
        r["bbt_structure_is_none"] = tr.bbt_structure() is None
        out[name] = r
    return out


def pendulum_data(device="cuda"):
    """tests/test_identification.py's noise-free pendulum record: the RK4
    trajectory (301 samples on [0, 3]) of p = (4, 0.3) from (1, 0), and
    x_data(t), its cubic-spline interpolant on ``device``."""
    from polympc_torch.basis.splines import fit_cubic_spline
    from polympc_torch.ocp import rk4_integrate
    p = torch.tensor([4.0, 0.3], dtype=torch.float64)
    f = lambda x, u, t: torch.stack([x[1], -p[0] * torch.sin(x[0])
                                     - p[1] * x[1]])
    xs = rk4_integrate(f, torch.tensor([1.0, 0.0], dtype=torch.float64),
                       0.0, 3.0, 300).numpy()
    h = 3.0 / (xs.shape[0] - 1)
    sp0 = fit_cubic_spline(0.0, h, xs[:, 0], device=device)
    sp1 = fit_cubic_spline(0.0, h, xs[:, 1], device=device)
    return xs, lambda t: torch.stack([sp0(t), sp1(t)])


def _pendulum(x, u, p, d, t):
    return torch.stack([x[1], -p[0] * torch.sin(x[0]) - p[1] * x[1]])


def _ident(dev):
    """identify on the noise-free pendulum (Chebyshev(5) x 6, p0 = (1, 1),
    bounds (0.1, 0) - (20, 5))."""
    from polympc_torch.basis import Chebyshev, SegmentedBasis
    from polympc_torch.ocp import identify
    _, xdata = pendulum_data(dev)
    res = identify(_pendulum, SegmentedBasis(Chebyshev(5), 6), xdata, None,
                   0.0, 3.0, n_params=2, nx=2, p0=[1.0, 1.0],
                   pl=[0.1, 0.0], pu=[20.0, 5.0], device=dev)
    return {"p": res.p.cpu().tolist(), "p_init": res.p_init.cpu().tolist(),
            "status": int(res.status), "iters": int(res.iters),
            "cost": float(res.cost)}


def _integrators(dev):
    """adaptive_integrate on x' = -x over [0, 2] (rtol 1e-8, atol 1e-12),
    on the harmonic oscillator's save grid (rtol 1e-8, atol 1e-10), and
    with max_steps=5 on [0, 1e6]; ps_integrate on the logistic equation
    (Chebyshev(10) x 3, [0, 4])."""
    from polympc_torch.basis import Chebyshev, SegmentedBasis
    from polympc_torch.ocp import adaptive_integrate, ps_integrate
    t64 = lambda v: torch.as_tensor(v, dtype=torch.float64, device=dev)
    stats = lambda s: [int(s[0]), int(s[1]), int(s[2])]
    x, s1 = adaptive_integrate(lambda x, u, t: -x, t64([1.0]), 0.0, 2.0,
                               rtol=1e-8, atol=1e-12)
    ts = np.linspace(0.5, 6.0, 7)
    xs, s2 = adaptive_integrate(lambda x, u, t: torch.stack([x[1], -x[0]]),
                                t64([1.0, 0.0]), 0.0, 6.0, rtol=1e-8,
                                atol=1e-10, ts=ts)
    _, s3 = adaptive_integrate(lambda x, u, t: -x, t64([1.0]), 0.0, 1e6,
                               rtol=1e-10, atol=1e-14, max_steps=5)
    X, t = ps_integrate(lambda x, u, t: x * (1 - x), t64([0.1]), 0.0, 4.0,
                        SegmentedBasis(Chebyshev(10), 3))
    tt = t.cpu().numpy()
    return {"device": str(X.device),
            "exp": {"x": float(x[0]), "stats": stats(s1),
                    "error": abs(float(x[0]) - np.exp(-2.0))},
            "oscillator": {"stats": stats(s2), "error": float(np.abs(
                xs.cpu().numpy() - np.stack([np.cos(ts), -np.sin(ts)],
                                            1)).max())},
            "exhausted": {"stats": stats(s3)},
            "ps": {"X": X[:, 0].cpu().tolist(), "error": float(np.abs(
                X[:, 0].cpu().numpy() - 1.0 / (1.0 + 9.0 * np.exp(-tt))
            ).max())}}


def ocp_extras(device="cuda"):
    """One float64 call of each case on ``device``; returns a dict of each
    case's key numbers (statuses, iterations, costs, errors against the
    JAX tests' oracles) and its seconds."""
    dev = _card(device)
    out = {}
    for name, fn in (("ms_soft_robot", _ms_robot), ("stiff", _stiff),
                     ("rate", _rate), ("identify", _ident),
                     ("integrators", _integrators)):
        t0 = time.perf_counter()
        r = fn(dev)
        _sync(dev)
        if name == "ms_soft_robot":
            out["ms_robot"], out["soft_robot"] = r
        else:
            out[name] = r
        out.setdefault("seconds", {})[name] = time.perf_counter() - t0
    return out
