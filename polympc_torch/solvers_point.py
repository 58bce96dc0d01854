"""The solver layer's card paths: the interior points, the other QP solvers,
the implicit VJP, LQR/CARE (BASELINE config 2) and the small NLP solvers,
each as the user's entry point would run it.

  * :func:`kite_ip`: bench's kite transcription (``headline.kite_problem``)
    through ``nlp_ip_solve`` in float64 with default ``IPNLPSettings``:
    B initial conditions (``bench_x0s``), each pinned into node 0 of the
    transcription's initial guess;
  * :func:`mpc_ip`: ``MPC(solver="ip")`` on the robot quick start
    (BASELINE config 1) against the SQP route, float64;
  * :func:`qp_solvers`: the headline spline-fit QPs (B=4096 from
    ``default_rng(1)``, n=32, m=15) through ``qp_ip_solve`` (float64),
    ``admm_solve`` (float32, the box stacked into A: m=47, through the
    dense epoch kernel), ``qp_active_set_solve`` (host, first lanes) and
    the implicit VJP of ``box_admm_solve`` (float32 forward through the
    dense epoch kernel) for d(w'x*)/d(h, al, au, xl, xu) with w from
    ``default_rng(7)``;
  * :func:`lqr_batch`: the 12x4 quadrotor-like system of
    tests/test_control.py at B=1 and a batch of B linearisation points, A's
    nonzero entries scaled by (1 + 0.05 U(-1, 1)) from ``default_rng(5)``;
  * :func:`nlp_extras`: ``psarc_solve``, ``trust_region_solve``,
    ``projected_gradient_solve`` and ``project`` on the JAX tests' cases.

``chip_smoke.py`` drives these on the card and holds them against
``tests/data/solvers_jax_cpu.npz`` (written by
``tests/data/make_solvers_reference.py``).  Every function runs on
``device`` ("cuda" unless the caller asks for the CPU).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from polympc_torch.headline import bench_x0s, kite_problem
from polympc_torch.headline_table import spline_batch, spline_settings
from polympc_torch.nlp.ip import IPNLPSettings, nlp_ip_solve
from polympc_torch.parallel import pin_initial_state
from polympc_torch.utils import status as st

__all__ = ["VJP_SEED", "VJP_FIELDS", "LQR_SEED", "kite_ip_start", "kite_ip",
           "mpc_ip", "vjp_weights", "qp_solvers", "quadrotor",
           "quadrotor_batch", "lqr_batch", "nlp_extras"]

VJP_SEED = 7
# the QP fields the VJP path differentiates w'x* by
VJP_FIELDS = ("h", "al", "au", "xl", "xu")
LQR_SEED = 5


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device):
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def kite_ip_start(tr, bounds, x0s):
    """Per-lane start point and bounds of the kite IP batch: the
    transcription's initial guess with node 0 set to each lane's scaled x0
    (B, nx), and the bounds with node 0 pinned there."""
    bnd, x0sc = pin_initial_state(tr, bounds, x0s)
    z0 = tr.initial_guess(dtype=x0s.dtype, device=x0s.device)[None].repeat(
        x0s.shape[0], 1)
    z0[:, :tr.ocp.nx] = x0sc
    return z0, bnd


def kite_ip(B: int = 512, device="cuda", x0s=None, warmup: int = 8):
    """The kite batch through the interior point in float64, after a
    warm-up of ``warmup`` lanes cut to 2 iterations (0: none).

    Returns ``(extra, lanes)``: ``extra`` holds batch, status_solved,
    mean_iters, wall_s and solved_per_s; ``lanes`` the per-lane numpy
    status, iters, cost and kkt_error."""
    device = torch.device(device)
    tr, bounds, prm, _ = kite_problem(device, torch.float64)
    x0 = np.asarray(bench_x0s(B) if x0s is None else x0s, np.float32)
    x0 = torch.as_tensor(x0, dtype=torch.float64, device=device)
    if warmup:
        z0, bnd = kite_ip_start(tr, bounds, x0[:warmup])
        nlp_ip_solve(tr.nlp, z0, p=prm, bounds=bnd,
                     settings=IPNLPSettings(max_iter=2))
        _sync(device)
    z0, bnd = kite_ip_start(tr, bounds, x0)
    sol, wall = _timed(lambda: nlp_ip_solve(tr.nlp, z0, p=prm, bounds=bnd),
                       device)
    lanes = {k: getattr(sol, k).cpu().numpy()
             for k in ("status", "iters", "cost", "kkt_error")}
    solved = int((lanes["status"] == st.SOLVED).sum())
    extra = {"batch": B, "status_solved": solved,
             "mean_iters": float(lanes["iters"].mean()), "wall_s": wall,
             "solved_per_s": solved / wall}
    return extra, lanes


def mpc_ip(device="cuda", reps: int = 10):
    """``MPC(solver="ip")`` on the robot quick start (tests/test_nlp_ip.py's
    case) in float64, beside the SQP route on the same problem: the cold
    solves, the warm re-solve, and the mean latency of ``reps`` further
    warm re-solves.  Returns a dict of the statuses, counts, walls and the
    largest difference of the two routes' state trajectories."""
    from polympc_torch.basis import Chebyshev, SegmentedBasis
    from polympc_torch.control import MPC
    from polympc_torch.models import robot_ocp

    def build(solver):
        m = MPC(robot_ocp(), SegmentedBasis(Chebyshev(5), 2), t0=0.0,
                tf=2.0, solver=solver, device=device)
        m.set_static_parameters([2.0])
        m.control_bounds([-1.5, -0.75], [1.5, 0.75])
        m.initial_conditions([0.5, 0.5, 0.5])
        m.x_guess([0.5, 0.5, 0.5])
        return m

    ip = build("ip")
    cold, t_cold = _timed(ip.solve, device)
    x_ip = ip.solution_x().cpu().numpy()
    sqp = build("sqp")
    sol_sqp = sqp.solve()
    x_sqp = sqp.solution_x().cpu().numpy()
    ip.initial_conditions([0.51, 0.49, 0.5])
    warm, t_warm = _timed(ip.solve, device)
    lat, solved = [], 0
    for k in range(reps):
        ip.initial_conditions([0.51 - 0.002 * k, 0.49, 0.5])
        s, t = _timed(ip.solve, device)
        lat.append(t)
        solved += int(s.status) == st.SOLVED
    res = {"cold_status": int(cold.status), "cold_iters": int(cold.iters),
           "sqp_status": int(sol_sqp.status),
           "warm_status": int(warm.status), "warm_iters": int(warm.iters),
           "cold_s": t_cold, "warm_s": t_warm,
           "resolve_latency_ms_mean": 1e3 * float(np.mean(lat)),
           "resolves": reps, "resolves_solved": solved,
           "max_abs_dx_vs_sqp": float(np.abs(x_ip - x_sqp).max())}
    return res


def vjp_weights(B: int, n: int):
    """The seeded weights w (B, n) of the VJP path's loss w'x*."""
    return np.random.default_rng(VJP_SEED).standard_normal((B, n))


def qp_solvers(device="cuda", batch: int = 4096, active_lanes: int = 256):
    """The spline-fit QP batch through every QP solver of the port.

    Returns ``(extra, lanes)``: ``extra`` the counts and the batch time of
    each solver; ``lanes`` the per-lane numpy arrays: ip_status, ip_iters,
    ip_x (float64), admm_status, admm_iters, admm_x, as_status, as_x (the
    first ``active_lanes``), and the VJP's cotangents vjp_h, vjp_al,
    vjp_au, vjp_xl, vjp_xu, the forward's vjp_x and vjp_status."""
    from polympc_torch.qp import (
        admm_solve, box_admm_solve, qp_active_set_solve, qp_ip_solve)
    from polympc_torch.qp.types import QPData
    device = torch.device(device)
    qp64 = spline_batch(batch, device, torch.float64)[1]
    qp32 = QPData(*(t.to(torch.float32) for t in qp64))
    kernel = spline_settings("kernel")
    # warm-up: the libraries' handles, the kernels' first load and the
    # active set's first build (g++)
    qp_ip_solve(QPData(*(t[:2] for t in qp64)))
    admm_solve(QPData(*(t[:2] for t in qp32)), settings=kernel)
    qp_active_set_solve(QPData(*(t[:1] for t in qp64)))
    _sync(device)
    ip, t_ip = _timed(lambda: qp_ip_solve(qp64), device)
    admm, t_admm = _timed(lambda: admm_solve(qp32, settings=kernel), device)
    sub = QPData(*(t[:active_lanes] for t in qp64))
    act, t_as = _timed(lambda: qp_active_set_solve(sub), device)

    leaves = QPData(*(t.clone() for t in qp32))
    wrt = [getattr(leaves, f).requires_grad_(True) for f in VJP_FIELDS]
    w = torch.as_tensor(vjp_weights(batch, qp32.h.shape[1]),
                        dtype=torch.float32, device=device)

    def vjp():
        sol = box_admm_solve(leaves, settings=kernel)
        g = torch.autograd.grad(torch.sum(w * sol.x), wrt)
        return sol, g
    (vsol, grads), t_vjp = _timed(vjp, device)

    np_ = lambda t: t.detach().cpu().numpy()
    lanes = {"ip_status": np_(ip.status), "ip_iters": np_(ip.iters),
             "ip_x": np_(ip.x), "admm_status": np_(admm.status),
             "admm_iters": np_(admm.iters), "admm_x": np_(admm.x),
             "as_status": np_(act.status), "as_x": np_(act.x),
             "vjp_x": np_(vsol.x), "vjp_status": np_(vsol.status)}
    for name, g in zip(VJP_FIELDS, grads):
        lanes[f"vjp_{name}"] = np_(g)
    extra = {"batch": batch, "n": int(qp64.h.shape[1]),
             "m": int(qp64.al.shape[1]),
             "ip_solved": int((lanes["ip_status"] == st.SOLVED).sum()),
             "ip_mean_iters": float(lanes["ip_iters"].mean()),
             "admm_solved": int((lanes["admm_status"] == st.SOLVED).sum()),
             "admm_mean_iters": float(lanes["admm_iters"].mean()),
             "active_set_lanes": active_lanes,
             "active_set_solved": int((lanes["as_status"]
                                       == st.SOLVED).sum()),
             "ip_batch_s": t_ip, "admm_batch_s": t_admm,
             "active_set_s": t_as, "vjp_forward_backward_s": t_vjp}
    return extra, lanes


def quadrotor():
    """tests/test_control.py::test_lqr_quadrotor_like's 12x4 system
    (A, B, Q, R) as numpy float64."""
    n, m = 12, 4
    A = np.zeros((n, n))
    A[0, 3] = A[1, 4] = A[2, 5] = 1.0
    A[3, 7] = 19.62
    A[4, 6] = -19.62
    A[6, 9] = A[7, 10] = A[8, 11] = 0.5
    B = np.zeros((n, m))
    B[3, 0] = 9.81
    B[4, 1] = -9.81
    B[5, 2] = 0.214791
    B[9, 1] = -49.4854
    B[10, 0] = -46.0828
    B[11, 3] = 21.43
    Q = np.diag([1, 1, 5, .1, .1, .5, 2, 2, 1e-10, 2, 2, 5.0])
    R = np.diag([5, 5, .01, .01])
    return A, B, Q, R


def quadrotor_batch(B: int, seed: int = LQR_SEED):
    """B linearisation points: the quadrotor's A with each nonzero entry
    scaled by (1 + 0.05 U(-1, 1)), (B, 12, 12)."""
    A = quadrotor()[0]
    scale = 1.0 + 0.05 * np.random.default_rng(seed).uniform(
        -1.0, 1.0, (B,) + A.shape)
    return np.where(A != 0, A * scale, 0.0)


def lqr_batch(device="cuda", batch: int = 4096, reps: int = 50):
    """LQR on the quadrotor at B=1 (mean latency of ``reps`` solves) and on
    a batch of ``batch`` linearisation points, float64.  Returns
    ``(extra, lanes)``: lanes holds the batch's A, K and P and the B=1
    K and P as numpy arrays, and the per-lane relative CARE residual
    ||A'P + PA - PBR^-1B'P + Q||_F / (||A'P||_F + ||Q||_F)."""
    from polympc_torch.control.lqr import lqr
    device = torch.device(device)
    A, Bm, Q, R = (torch.as_tensor(a, dtype=torch.float64, device=device)
                   for a in quadrotor())
    K1, P1 = lqr(A, Bm, Q, R)
    _sync(device)
    ts = []
    for _ in range(reps):
        (K1, P1), t = _timed(lambda: lqr(A, Bm, Q, R), device)
        ts.append(t)
    As = torch.as_tensor(quadrotor_batch(batch), dtype=torch.float64,
                         device=device)
    (K, P), wall = _timed(lambda: lqr(As, Bm, Q, R), device)
    At = As.transpose(1, 2)
    res = At @ P + P @ As - P @ Bm @ torch.linalg.inv(R) @ Bm.T @ P + Q
    rel = torch.linalg.matrix_norm(res) / (
        torch.linalg.matrix_norm(At @ P) + torch.linalg.matrix_norm(Q))
    np_ = lambda t: t.detach().cpu().numpy()
    lanes = {"A": np_(As), "K": np_(K), "P": np_(P), "rel_residual": np_(rel),
             "K1": np_(K1), "P1": np_(P1)}
    extra = {"batch": batch, "b1_latency_ms_mean": 1e3 * float(np.mean(ts)),
             "batch_wall_s": wall,
             "worst_rel_residual": float(lanes["rel_residual"].max())}
    return extra, lanes


def nlp_extras(device="cuda"):
    """One float64 call each of the small solvers, on the JAX tests'
    cases: psarc on test_cubic_continuation's F, the trust region on
    Rosenbrock from (0, 0), projected gradient on test_gradproj_box_qp's
    box QP, and the Chebyshev(12) projection of exp(-t) sin(3t) on [0, 2].
    Returns a dict of each result's key numbers."""
    from polympc_torch.basis import Chebyshev
    from polympc_torch.basis.projection import project
    from polympc_torch.nlp.psarc import psarc_solve
    from polympc_torch.nlp.tr import (
        projected_gradient_solve, trust_region_solve)
    dev = torch.device(device)
    t64 = lambda v: torch.as_tensor(v, dtype=torch.float64, device=dev)

    def F(x):
        return torch.stack([x[0] ** 3 - 3 * x[0] - x[1], x[1] - 2.0])
    ps = psarc_solve(F, t64([0.5, 0.0]))
    rosen = lambda x: (1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2
    tr = trust_region_solve(rosen, t64([[0.0, 0.0]]), max_iter=200)
    H, h = t64([[10.0, 0.0], [0.0, 0.1]]), t64([-1.0, -2.0])
    qp_f = lambda x: 0.5 * x @ (H @ x) + h @ x
    gp = projected_gradient_solve(qp_f, t64([[0.0, 0.0]]), lb=[-1.0, -1.0],
                                  ub=[1.0, 1.0], max_iter=500)
    f = lambda t: np.exp(-t) * np.sin(3 * t)
    proj = project(f, Chebyshev(12), a=0.0, b=2.0)
    tq = np.linspace(0.0, 2.0, 33)
    ev = proj.eval(t64(tq))
    return {
        "psarc": {"converged": bool(ps.converged), "steps": ps.steps,
                  "x": ps.x.cpu().tolist(),
                  "residual": float(F(ps.x).abs().max()),
                  "lambda_first_last": [float(ps.lambda_log[0]),
                                        float(ps.lambda_log[-1])]},
        "trust_region": {"status": int(tr.status[0]),
                         "iters": int(tr.iters[0]),
                         "x": tr.x[0].cpu().tolist()},
        "projected_gradient": {"status": int(gp.status[0]),
                               "iters": int(gp.iters[0]),
                               "x": gp.x[0].cpu().tolist()},
        "projection": {"device": str(ev.device),
                       "max_error": float(np.abs(
                           ev.cpu().numpy() - f(tq)).max())}}
