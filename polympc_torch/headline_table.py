"""The reference's headline benchmark table on the port — the port of
``benchmarks/headline.py``: its three workloads with the same settings,
seeds, warm starts and certify recipe, each as a warm-started
single-instance latency and a batched throughput.

  * :func:`spline_qp`: the spline-fitting QP (n=32, m=15), boxADMM with
    Ruiz equilibration and polish, its epochs through the dense fused epoch
    (ops/admm_epoch.py); B=1 and a batch of jittered fits (``default_rng(1)``);
  * :func:`frame_transform`: the projection of a point onto the wave
    track, six clipped Newton steps; B=1 warm-started and a batch of points
    (``default_rng(2)``);
  * :func:`race_car`: the race-car path-following NMPC (Chebyshev(5) x 2
    segments, n=99, m=66), a cold solve, the warm re-solve at B=1, and a
    warm-started batch of jittered states (``default_rng(3)``) with the
    two-stage fp64 Newton-KKT certify inside the timed loop.

Each function returns ``(result, lanes)``: ``result`` holds the harness's
keys (without ``reference_ms``) and names the device; ``lanes`` the
per-lane numpy arrays of the batch.  On "cuda" a missing card raises; the
plain versions run with ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from polympc_torch.basis import Chebyshev, SegmentedBasis
from polympc_torch.basis.splines import cubic_spline_eval_np
from polympc_torch.control.path import (
    _spline_fit_arrays, project_on_path_newton, spline_fit_qp_data,
    track_from_curvature,
)
from polympc_torch.models.race_car import make_wave_track, race_car_ocp
from polympc_torch.nlp import SQPSettings
from polympc_torch.nlp.refine import refine_solution
from polympc_torch.ocp import ocp_bounds, transcribe
from polympc_torch.parallel import make_batch_solver, pin_initial_state
from polympc_torch.qp import box_admm_solve
from polympc_torch.qp.types import ADMMSettings, QPData
from polympc_torch.utils import status as st

__all__ = ["KKT_TOL", "spline_qp", "frame_transform", "race_car",
           "spline_settings", "spline_batch", "frame_batch",
           "race_car_problem", "race_car_x0s", "race_car_certify"]

KKT_TOL = 1e-6


def _device(device):
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card: the headline table runs on the "
                               "card, or on the CPU with device='cpu'")
        return dev, torch.cuda.get_device_name(dev)
    return dev, dev.type


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _latency(fn, dev, reps):
    """Mean / max wall ms of a synchronised call, after one warm-up."""
    out = fn()
    _sync(dev)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.mean(ts)), float(np.max(ts)), out


def _throughput(fn, dev, reps):
    """Median wall seconds of a synchronised batched call, after one
    warm-up."""
    out = fn()
    _sync(dev)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), out


# --------------------------------------------------------------------------
# 1. spline-fitting QP (applications.rst:404-484)
# --------------------------------------------------------------------------
SPLINE_S = np.linspace(0.0, 10.0, 81)
SPLINE_Y = np.sin(0.7 * SPLINE_S) + 0.1 * SPLINE_S


def spline_settings(kkt_solver: str = "kernel") -> ADMMSettings:
    """The harness's QP settings (headline.py:88-90)."""
    return ADMMSettings(rho=0.1, eps_abs=1e-4, eps_rel=1e-4, max_epochs=10,
                        check_every=25, equil_iters=4, kkt_solver=kkt_solver)


def spline_batch(batch: int, device="cuda", dtype=torch.float32):
    """The one-instance spline QP and the batch of ``batch`` jittered fits
    (same QP, a fresh linear term per lane from ``default_rng(1)``)."""
    qp64, _ = spline_fit_qp_data(SPLINE_S, SPLINE_Y, n_segments=8,
                                 dtype=torch.float64, device=device)
    qp = QPData(*(t.to(dtype) for t in qp64))
    rng = np.random.default_rng(1)
    ys = SPLINE_Y[None] + 0.05 * rng.standard_normal((batch, len(SPLINE_S)))
    hs = torch.as_tensor(np.stack([_spline_fit_arrays(SPLINE_S, yy, 8)[1]
                                   for yy in ys]), dtype=dtype,
                         device=device)
    big = QPData(*(t.expand(batch, *t.shape[1:]) for t in qp))
    return qp, big._replace(h=hs)


def spline_qp(device="cuda", batch: int = 4096, reps: int = 50,
              batch_reps: int = 10):
    """The spline-fitting QP: B=1 latency and batched throughput."""
    dev, name = _device(device)
    settings = spline_settings()
    qp, big = spline_batch(batch, dev)
    mean_ms, max_ms, sol = _latency(
        lambda: box_admm_solve(qp, settings=settings), dev, reps)
    if int(sol.status[0]) != st.SOLVED:
        raise RuntimeError("spline QP did not converge")
    dt, sols = _throughput(lambda: box_admm_solve(big, settings=settings),
                           dev, batch_reps)
    status = sols.status.cpu().numpy()
    result = {
        "workload": "spline_fit_qp",
        "n": int(qp.H.shape[-1]), "m": int(qp.A.shape[-2]),
        "latency_ms_mean": mean_ms, "latency_ms_max": max_ms,
        "batch": batch, "batch_solved": int((status == st.SOLVED).sum()),
        "throughput_us_per_solve": dt / batch * 1e6,
        "solves_per_s": batch / dt, "device": name,
    }
    return result, {"status": status, "iters": sols.iters.cpu().numpy()}


# --------------------------------------------------------------------------
# 2. frame transform (applications.rst:489-510)
# --------------------------------------------------------------------------
def frame_batch(batch: int, device="cuda", dtype=torch.float32):
    """The wave track, the B=1 warm-started point (s = 120, guess s - 0.8)
    and the batch: true arc lengths, points and guesses from
    ``default_rng(2)``."""
    kappa = make_wave_track(length=200.0, amplitude=0.02, waves=3,
                            device=device)
    path = track_from_curvature(kappa, s_max=200.0, device=device)
    s_true = 120.0
    pt = torch.as_tensor([float(cubic_spline_eval_np(path.Xc, s_true)),
                          float(cubic_spline_eval_np(path.Yc, s_true))],
                         dtype=dtype, device=device)
    one = (pt, torch.as_tensor(s_true - 0.8, dtype=dtype, device=device),
           s_true)
    rng = np.random.default_rng(2)
    s_b = rng.uniform(5.0, 195.0, batch)
    pts = torch.as_tensor(np.stack([cubic_spline_eval_np(path.Xc, s_b),
                                    cubic_spline_eval_np(path.Yc, s_b)],
                                   axis=1), dtype=dtype, device=device)
    s0s = torch.as_tensor(s_b + rng.uniform(-1.0, 1.0, batch), dtype=dtype,
                          device=device)
    return path, one, (pts, s0s, s_b)


def frame_transform(device="cuda", batch: int = 4096, reps: int = 50,
                    batch_reps: int = 10):
    """The frame-transform projection: B=1 latency and batched
    throughput; a lane counts as solved within 1e-3 of its true s."""
    dev, name = _device(device)
    dtype = torch.float32
    path, (pt, s_prev, s_true), (pts, s0s, s_b) = frame_batch(batch, dev)
    mean_ms, max_ms, s_sol = _latency(
        lambda: project_on_path_newton(path, pt, s0=s_prev, dtype=dtype),
        dev, reps)
    if not abs(float(s_sol) - s_true) < 1e-2:
        raise RuntimeError("frame transform missed the point")
    dt, sols = _throughput(
        lambda: project_on_path_newton(path, pts, s0=s0s, dtype=dtype),
        dev, batch_reps)
    s = sols.cpu().numpy()
    err = np.abs(s - s_b)
    result = {
        "workload": "frame_transform_nlp",
        "latency_ms_mean": mean_ms, "latency_ms_max": max_ms,
        "batch": batch, "batch_solved": int((err < 1e-3).sum()),
        "batch_max_s_err": float(err.max()),
        "throughput_us_per_solve": dt / batch * 1e6,
        "solves_per_s": batch / dt, "device": name,
    }
    return result, {"s": s}


# --------------------------------------------------------------------------
# 3. race-car path-following NMPC OCP
# --------------------------------------------------------------------------
RACE_X0 = np.asarray([10.0, 0.0, 0.0, 0.0, 0.4, 0.05], np.float32)
RACE_DX_SCALE = np.array([0.3, 0.02, 0.02, 0.5, 0.05, 0.02])


def race_car_problem(device="cuda", dtype=torch.float32):
    """The harness's race-car problem (headline.py:198-232):
    (tr, bounds, prm, settings_cold, settings_warm).  The track coordinate
    s is unbounded below: kappa(s) is periodic."""
    kappa = make_wave_track(length=200.0, amplitude=0.02, waves=3,
                            device=device)
    tr = transcribe(race_car_ocp(kappa), SegmentedBasis(Chebyshev(5), 2),
                    x_scale=[10.0, 1.0, 1.0, 30.0, 1.0, 1.0],
                    u_scale=[0.4, 1e4, 1e4])
    prm = tr.params(d=[15.0], t0=0.0, tf=2.0, dtype=dtype, device=device)
    bounds = ocp_bounds(
        tr, ul=[-0.4, -2e4, -2e4], uu=[0.4, 2e4, 2e4],
        xl=[1.0, -5.0, -3.0, -1e3, -2.0, -1.0],
        xu=[40.0, 5.0, 3.0, 1e3, 2.0, 1.0], dtype=dtype, device=device)
    qp = ADMMSettings(rho=1.0, eps_abs=1e-5, eps_rel=1e-5, max_epochs=10,
                      check_every=50, equil_iters=0, kkt_solver="kernel",
                      structure=tr.bbt_structure(), polish=False)
    cold = SQPSettings(hessian="exact", max_iter=120, reg="mirror",
                       eps_prim=1e-3, eps_dual=1e-3, eps_viol=1e-3,
                       eps_stat=1e-2, qp=qp)
    return tr, bounds, prm, cold, dataclasses.replace(cold, max_iter=16)


def race_car_x0s(batch: int):
    """The batch's jittered initial states (``default_rng(3)``), float32."""
    rng = np.random.default_rng(3)
    dx = rng.standard_normal((batch, 6)) * RACE_DX_SCALE
    return (RACE_X0[None] + dx).astype(np.float32)


def race_car_certify(tr, x0s, sols, bounds64, prm64):
    """The harness's two-stage fp64 Newton-KKT certify: 6 iterations for
    every lane, then the 64 worst lanes restart from the fp32 point with 10
    iterations and ``act_tol=1e-4``.  Returns the residual per lane (B,)."""
    bnd, _ = pin_initial_state(tr, bounds64, x0s.to(torch.float64))

    def one(idx, z, lam, lam_box, **kw):
        b = bnd if idx is None else bnd._replace(lbx=bnd.lbx[idx],
                                                 ubx=bnd.ubx[idx])
        return refine_solution(tr.nlp, z, lam, lam_box, b, prm64,
                               solve_dtype=torch.float32,
                               matrix_dtype=torch.float32,
                               return_residual=True, **kw)[3]

    r1 = one(None, sols.x, sols.lam, sols.lam_box, iters=6)
    idx = torch.topk(r1, min(64, r1.shape[0])).indices
    r2 = one(idx, sols.x[idx], sols.lam[idx], sols.lam_box[idx], iters=10,
             act_tol=1e-4, solve_ir=6)
    r = r1.clone()
    r[idx] = torch.minimum(r1[idx], r2)
    return r


def race_car_cold(device="cuda"):
    """The harness's problem and its cold solve at ``RACE_X0`` from the
    constant guess (not the zero-control rollout, headline.py:263-266):
    (tr, bounds, prm, warm-start solver, cold solution)."""
    dev = torch.device(device)
    tr, bounds, prm, cold, warm = race_car_problem(dev)
    n, m = tr.nlp.n, tr.nlp.m
    x0 = torch.as_tensor(RACE_X0, device=dev)[None]
    z_cold = tr.initial_guess(RACE_X0, dtype=torch.float32, device=dev)[None]
    sol = make_batch_solver(tr, bounds, prm, cold)(
        x0, z_cold, torch.zeros((1, m), device=dev),
        torch.zeros((1, n), device=dev))
    if int(sol.status[0]) != st.SOLVED:
        raise RuntimeError("race-car cold solve failed")
    return tr, bounds, prm, make_batch_solver(tr, bounds, prm, warm), sol


def race_car_batch_fn(tr, bounds, solve, sol, batch: int):
    """The batch's timed unit: a function of no arguments that solves the
    ``batch`` jittered states (``default_rng(3)``) warm-started from the
    cold solution ``sol`` and certifies them; returns
    ``(sols, residuals)``."""
    dev = sol.x.device
    prm64 = tr.params(d=[15.0], t0=0.0, tf=2.0, dtype=torch.float64,
                      device=dev)
    bounds64 = bounds._replace(**{f: getattr(bounds, f).to(torch.float64)
                                  for f in bounds._fields})
    x0s = torch.as_tensor(race_car_x0s(batch), device=dev)
    zs, lams, lbs = (t.expand(batch, -1)
                     for t in (sol.x, sol.lam, sol.lam_box))

    def once():
        sols = solve(x0s, zs, lams, lbs)
        return sols, race_car_certify(tr, x0s, sols, bounds64, prm64)
    return once


def race_car(device="cuda", batch: int = 512, reps: int = 50,
             batch_reps: int = 10):
    """The race-car NMPC: cold solve, B=1 warm re-solve latency, and the
    warm-started batch with the certify inside the timed loop."""
    dev, name = _device(device)
    tr, bounds, prm, solve, sol = race_car_cold(dev)
    n, m = tr.nlp.n, tr.nlp.m

    # warm-started re-solve from a perturbed state (nmpf.hpp:467-470)
    x1 = torch.as_tensor(RACE_X0 + np.array([0.2, 0.01, 0.0, 0.5, -0.02,
                                             0.0], np.float32),
                         device=dev)[None]
    mean_ms, max_ms, sol1 = _latency(
        lambda: solve(x1, sol.x, sol.lam, sol.lam_box), dev, reps)
    if int(sol1.status[0]) != st.SOLVED:
        raise RuntimeError("race-car warm re-solve failed")

    once = race_car_batch_fn(tr, bounds, solve, sol, batch)
    dt, (sols, kkt) = _throughput(once, dev, batch_reps)
    kk = kkt.cpu().numpy()
    status = sols.status.cpu().numpy()
    ok = (status == st.SOLVED) & (kk <= KKT_TOL)
    certified = int(ok.sum())
    result = {
        "workload": "race_car_nmpc_ocp", "n": n, "m": m,
        "latency_ms_mean": mean_ms, "latency_ms_max": max_ms,
        "warm_iters": int(sol1.iters[0]),
        "batch": batch, "batch_solved": int((status == st.SOLVED).sum()),
        "batch_certified_1e-6": certified, "kkt_tol": KKT_TOL,
        "certified_kkt_max": float(kk[ok].max()) if certified else None,
        "throughput_us_per_solve": dt / batch * 1e6,
        "solves_per_s": batch / dt, "certified_solves_per_s": certified / dt,
        "device": name,
    }
    lanes = {"residual": kk, "certified": ok, "status": status,
             "iters": sols.iters.cpu().numpy()}
    return result, lanes
