"""The certified kite path-following batch: the port's main path, end to end.

This is ``bench.py``'s pipeline on the port: B augmented-kite NMPF OCPs
(Chebyshev(5) x 2 segments) solved by the batched fp32 SQP (exact Hessian,
``reg="mirror"``, l1 line search, ``max_iter=9``, 3 x 50 boxADMM iterations
per QP through the BBT epoch), then the three-stage fp64 Newton-KKT certify
with fp32 LDL^T solves.  A lane counts only if its certified fp64 KKT
residual is at most 1e-6.  ``chip_smoke.py`` drives :func:`run` on the card.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from polympc_torch.basis import Chebyshev, SegmentedBasis
from polympc_torch.control.nmpf import augment_ocp
from polympc_torch.models import kite_dynamics, kite_output, kite_path
from polympc_torch.nlp import SQPSettings
from polympc_torch.nlp.refine import refine_solution
from polympc_torch.ocp import transcribe, ocp_bounds
from polympc_torch.parallel import make_batch_solver, pin_initial_state
from polympc_torch.qp.types import ADMMSettings
from polympc_torch.utils import status as st

__all__ = ["KITE_BOUNDS", "KKT_TOL", "bench_x0s", "kite_ocp",
           "kite_problem", "certify", "certify_pinned", "run"]

KKT_TOL = 1e-6


def bench_x0s(B: int, seed: int = 0):
    """bench.py's initial conditions, (B, 5) float32 (its draw order)."""
    rng = np.random.default_rng(seed)
    s0 = rng.uniform(0.0, 2 * np.pi, B)
    theta0 = np.pi / 6 + 0.2 * np.sin(2 * s0) + rng.normal(0, 0.05, B)
    phi0 = 0.8 * np.cos(s0) + rng.normal(0, 0.05, B)
    gamma0 = rng.uniform(-0.5, 0.5, B)
    return np.stack([np.clip(theta0, 0.05, 1.5), np.clip(phi0, -1.5, 1.5),
                     gamma0, s0, np.full(B, 0.05)], axis=1).astype(np.float32)


def kite_ocp():
    """bench.py's OCP: the kite NMPF with the path-state augmentation
    (nx=5, nu=2, d = [v_ref])."""
    return augment_ocp(lambda x, u: kite_dynamics(x, u), kite_output,
                       kite_path, nx=3, nu=1, ny=2)


# the kite's input and state bounds (bench.py's)
KITE_BOUNDS = dict(ul=[-5.0, -10.0], uu=[5.0, 10.0],
                   xl=[0.0, -np.pi / 2, -np.pi, -100.0, -100.0],
                   xu=[np.pi / 2, np.pi / 2, np.pi, 100.0, 100.0])


def kite_problem(device="cuda", dtype=torch.float32):
    """bench.py's problem and solver settings: (tr, bounds, prm, settings)."""
    tr = transcribe(kite_ocp(), SegmentedBasis(Chebyshev(5), 2))
    prm = tr.params(d=[0.05], t0=0.0, tf=2.0, dtype=dtype, device=device)
    bounds = ocp_bounds(tr, dtype=dtype, device=device, **KITE_BOUNDS)
    settings = SQPSettings(
        hessian="exact", max_iter=9, reg="mirror",
        eps_prim=1e-3, eps_dual=1e-3, eps_viol=1e-3, eps_stat=1e-2,
        qp=ADMMSettings(rho=1.0, eps_abs=1e-4, eps_rel=1e-4,
                        max_epochs=3, check_every=50, equil_iters=0,
                        kkt_solver="kernel", structure=tr.bbt_structure(),
                        polish=False))
    return tr, bounds, prm, settings


def certify(tr, x0s, sols, bounds64, prm64):
    """bench.py's adaptive three-stage fp64 refinement; returns the
    certified KKT residual per lane (B,) float64 (:func:`certify_pinned`
    on the bounds with node 0 pinned to each lane's x0)."""
    bnd, _ = pin_initial_state(tr, bounds64, x0s.to(torch.float64))
    return certify_pinned(tr.nlp, bnd, sols, prm64)


def certify_pinned(nlp, bnd, sols, prm64):
    """bench.py's three stages on per-lane float64 bounds ``bnd``.

    Stage 1: two Newton-KKT steps for every lane.  Stage 2: two more for
    the 64 worst lanes, continuing from the last iterate.  Stage 3: a heavy
    restart (10 steps, act_tol=1e-4) for the 16 still-worst lanes from the
    fp32 point.  Every solve is an fp32 LDL^T with fp64 residuals."""
    B = sols.x.shape[0]

    def one(idx, z, lam, lam_box, **kw):
        b = bnd if idx is None else bnd._replace(
            lbx=bnd.lbx[idx], ubx=bnd.ubx[idx])
        return refine_solution(nlp, z, lam, lam_box, b, prm64,
                               solve_dtype=torch.float32,
                               matrix_dtype=torch.float32,
                               return_residual=True, **kw)

    o = one(None, sols.x, sols.lam, sols.lam_box, iters=2, return_last=True)
    r1, zl, laml, lambl = o[3], o[4], o[5], o[6]
    i2 = torch.topk(r1, min(64, B)).indices
    o2 = one(i2, zl[i2], laml[i2], lambl[i2], iters=2)
    r = r1.clone()
    r[i2] = torch.minimum(r1[i2], o2[3])
    i3 = torch.topk(r, min(16, B)).indices
    o3 = one(i3, sols.x[i3], sols.lam[i3], sols.lam_box[i3], iters=10,
             act_tol=1e-4, solve_ir=6)
    r[i3] = torch.minimum(r[i3], o3[3])
    return r


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def batch_fn(B: int = 512, device="cuda", x0s=None):
    """bench's timed unit: a function of no arguments that solves and
    certifies the batch (bench's x0s, or ``x0s``) and returns
    ``(sols, residuals)`` after a synchronise."""
    device = torch.device(device)
    tr, bounds, prm, settings = kite_problem(device)
    solve = make_batch_solver(tr, bounds, prm, settings, rollout_guess=True)
    prm64 = tr.params(d=[0.05], t0=0.0, tf=2.0, dtype=torch.float64,
                      device=device)
    bounds64 = bounds._replace(**{f: getattr(bounds, f).to(torch.float64)
                                  for f in bounds._fields})
    x0 = torch.as_tensor(bench_x0s(B) if x0s is None else x0s,
                         dtype=torch.float32, device=device)

    def once():
        sols = solve(x0)
        kkt = certify(tr, x0, sols, bounds64, prm64)
        _sync(device)
        return sols, kkt
    return once


def run(B: int = 512, device="cuda", reps: int = 5, x0s=None):
    """Solve and certify bench's batch: one warm-up, then ``reps`` timed
    repetitions (wall clock, synchronised).

    Returns ``(extra, lanes)``: ``extra`` holds ``bench.py``'s ``extra`` keys
    (batch, solved, status_solved, kkt_residual_max, kkt_tol,
    wall_s_per_batch, devices, platform, mean_sqp_iters); ``lanes`` the
    per-lane numpy arrays residual, certified, status and iters."""
    device = torch.device(device)
    once = batch_fn(B, device, x0s)
    once()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        sols, kkt = once()
        walls.append(time.perf_counter() - t0)
    dt = float(np.median(walls))
    res = kkt.cpu().numpy()
    ok = res <= KKT_TOL
    status = sols.status.cpu().numpy()
    iters = sols.iters.cpu().numpy()
    solved = int(ok.sum())
    on_gpu = device.type == "cuda"
    extra = {
        "batch": B, "solved": solved,
        "status_solved": int((status == st.SOLVED).sum()),
        "kkt_residual_max": float(res[ok].max()) if solved else None,
        "kkt_tol": KKT_TOL,
        "wall_s_per_batch": dt,
        "devices": torch.cuda.device_count() if on_gpu else 1,
        "platform": "gpu" if on_gpu else device.type,
        "mean_sqp_iters": float(iters.mean()),
    }
    lanes = {"residual": res, "certified": ok, "status": status,
             "iters": iters}
    return extra, lanes

