"""The certified horizon-partitioned kite batch: the distributed SQP's path
on one card, end to end.

The port of ``benchmarks/scaling.py``'s ``run_dist_point`` (one instance,
``kkt_solver`` "lu" against the kernel route) together with the batched
regime the JAX docs name as the one where the kernel route pays
(docs/parallel.md): the augmented kite NMPF on ``dist_transcribe(ocp,
Chebyshev(5), 8, 0.0, 2.0)`` (kz=42, ml=30, p_if=7: per-segment KKT k=72,
49 interface unknowns, no parameter border) with scaling.py's bounds;
B=128 lanes (scaling.py's batch rule ``max(128, 1024 // S)``) from
bench.py's x0 draw at that batch size, each pinned into segment 0's head
and started from its own rollout guess; the float32 SQP with
``DistSQPSettings(max_iter=60, admm_iters=400, eps_stat=1e-2,
kkt_solver="kernel")``; then the float64 certify of tests/test_dist_sqp.py,
``dist_refine(iters=4)`` and ``dist_kkt_residual``: a lane counts only if
its certified KKT residual is at most 1e-6.  ``chip_smoke.py`` drives
:func:`run` on the card.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from polympc_torch.basis import Chebyshev
from polympc_torch.control.nmpf import augment_ocp
from polympc_torch.headline import KITE_BOUNDS, KKT_TOL, bench_x0s
from polympc_torch.models import kite_dynamics, kite_output, kite_path
from polympc_torch.parallel.batch import local_rows
from polympc_torch.parallel.dist_sqp import (
    DistSQPSettings, dist_bounds, dist_kkt_residual, dist_refine,
    dist_transcribe)
from polympc_torch.parallel.multihost import (
    make_batch_dist_solver, pin_segment_head)
from polympc_torch.utils import status as st

__all__ = ["S", "B1_X0", "D", "dist_problem", "certify", "batch_fn",
           "b1_point", "run", "summarize"]

S = 8
B1_X0 = [0.6, 0.4, 0.0, 0.0, 0.05]
D = [0.05]
SOL_KEYS = ("W", "P", "lam_loc", "lam_if", "lam_bw", "lam_bp")


def dist_problem(device="cuda", dtype=torch.float32, kkt_solver="kernel",
                 max_iter: int = 60):
    """scaling.py's dist point: (dtr, bounds, settings); the bounds are
    shared by the lanes (each lane pins its own x0)."""
    ocp = augment_ocp(lambda x, u: kite_dynamics(x, u), kite_output,
                      kite_path, nx=3, nu=1, ny=2)
    dtr = dist_transcribe(ocp, Chebyshev(5), S, 0.0, 2.0)
    bounds = dist_bounds(dtr, dtype=dtype, device=device, **KITE_BOUNDS)
    # eps_stat=1e-2: the float32 stationarity tolerance of bench.py's fused
    # path (the dist default 1e-3 is below float32 reach)
    settings = DistSQPSettings(max_iter=max_iter, admm_iters=400,
                               eps_stat=1e-2, kkt_solver=kkt_solver)
    return dtr, bounds, settings


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def certify(dtr, bounds, x0s, out, mesh=None):
    """The float64 certify of every lane: dist_refine(iters=4) from the
    float32 solution (its segments split over ``mesh``'s "seg" group where
    one is given), then the KKT residual (B,) float64."""
    b64 = pin_segment_head(dtr, bounds._replace(
        **{f: getattr(bounds, f).double() for f in bounds._fields}),
        x0s.double())
    args = [out[k].double() for k in SOL_KEYS]
    ref = dist_refine(dtr, b64, *args, d=D, iters=4, mesh=mesh)
    return dist_kkt_residual(dtr, b64, *ref, d=D)


def batch_fn(B: int = 128, device="cuda", x0s=None, max_iter: int = 60,
             mesh=None):
    """The timed unit: a function of no arguments that solves the batch
    (bench's x0 draw at B, or ``x0s``) in float32 through the kernel route
    and certifies it in float64, and returns ``(out, residual, solve_s,
    certify_s)`` after a synchronise.  ``max_iter`` cuts the SQP (the
    warm-up and the trace).  With a ("dp", "seg") ``mesh`` the solve is
    ``make_batch_dist_solver``'s on it and the certify refines on it;
    ``out`` then holds this process's rows."""
    device = torch.device(device)
    dtr, bounds, settings = dist_problem(device, torch.float32, "kernel",
                                         max_iter)
    solve = make_batch_dist_solver(dtr, bounds, settings, d=D, mesh=mesh)
    x0 = torch.as_tensor(bench_x0s(B) if x0s is None else x0s,
                         dtype=torch.float32, device=device)

    def once():
        t0 = time.perf_counter()
        W0, P0 = dtr.rollout_guess(x0, d=D)
        out = solve(x0, W0, P0)
        if mesh is not None:
            out = {k: None if v is None else v.to_local()
                   for k, v in out.items()}
        _sync(device)
        t1 = time.perf_counter()
        res = certify(dtr, bounds, x0 if mesh is None else
                      local_rows(x0, mesh), out, mesh=mesh)
        _sync(device)
        return out, res, t1 - t0, time.perf_counter() - t1
    return once


def b1_point(device="cuda", kkt_solver="kernel"):
    """scaling.py's single-instance point (x0 = [0.6, 0.4, 0, 0, 0.05]):
    status, iters and violation of the float32 solve, and the wall in ms
    of one synchronised solve after a two-iteration warm-up."""
    device = torch.device(device)
    dtr, bounds, settings = dist_problem(device, torch.float32, kkt_solver)
    x0 = torch.tensor([B1_X0], dtype=torch.float32, device=device)

    def once(max_iter):
        W0, P0 = dtr.rollout_guess(x0, d=D)
        solve = make_batch_dist_solver(
            dtr, bounds, dataclasses.replace(settings, max_iter=max_iter),
            d=D)
        out = solve(x0, W0, P0)
        _sync(device)
        return out
    once(2)
    t0 = time.perf_counter()
    out = once(settings.max_iter)
    wall = time.perf_counter() - t0
    return {"status": int(out["status"][0]), "iters": int(out["iters"][0]),
            "qp_iters": int(out["qp_iters"][0]),
            "violation": float(out["violation"][0]), "ms": wall * 1e3}


def run(B: int = 128, device="cuda", x0s=None):
    """Warm up on a small batch (B=4, two SQP iterations), then solve and
    certify the batch once and time the single-instance point through "lu"
    and "kernel".

    Returns ``(extra, lanes)``: ``extra`` holds batch, certified,
    status_solved, kkt_residual_max, kkt_tol, wall_s_per_batch (solve +
    certify), solve_s, certify_s, mean_sqp_iters, mean_qp_iters, devices,
    platform and b1 (per route: status, iters, qp_iters, violation, ms);
    ``lanes`` the per-lane numpy arrays residual, certified, status, iters,
    qp_iters and the solution W."""
    device = torch.device(device)
    batch_fn(4, device, max_iter=2)()
    out, res_t, solve_s, cert_s = batch_fn(B, device, x0s)()
    extra, lanes = summarize(out, res_t)
    on_gpu = device.type == "cuda"
    extra.update({
        "wall_s_per_batch": solve_s + cert_s, "solve_s": solve_s,
        "certify_s": cert_s,
        "devices": torch.cuda.device_count() if on_gpu else 1,
        "platform": "gpu" if on_gpu else device.type,
        "b1": {r: b1_point(device, r) for r in ("lu", "kernel")}})
    return extra, lanes


def summarize(out, res_t):
    """The counts of one solved and certified batch: ``(extra, lanes)`` as
    :func:`run` returns them, without the walls."""
    res = res_t.cpu().numpy()
    ok = res <= KKT_TOL
    status = out["status"].cpu().numpy()
    iters = out["iters"].cpu().numpy()
    qp_iters = out["qp_iters"].cpu().numpy()
    extra = {
        "batch": int(res.shape[0]), "certified": int(ok.sum()),
        "status_solved": int((status == st.SOLVED).sum()),
        "kkt_residual_max": float(res[ok].max()) if ok.any() else None,
        "kkt_tol": KKT_TOL, "mean_sqp_iters": float(iters.mean()),
        "mean_qp_iters": float(qp_iters.mean())}
    lanes = {"residual": res, "certified": ok, "status": status,
             "iters": iters, "qp_iters": qp_iters,
             "W": out["W"].cpu().numpy()}
    return extra, lanes
