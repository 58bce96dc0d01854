"""The certified CSTR batch (BASELINE config 3): setpoint-tracking NMPC with
boxADMM QP subproblems over a batch of initial conditions, end to end.

The reference's CSTR NMPC (tests/test_control.py's ``test_cstr_nmpc``):
``cstr_ocp()`` on a Chebyshev(5) x 2-segment mesh with x_scale
(2, 1, 100, 100) and u_scale (15, 2000), t in [0, 100] s, the CSTR control
bounds and the state bounds (0, 0, 50, 50) - (6, 4, 150, 150) that keep
the Arrhenius terms finite.  B=256 initial conditions
x0 = CSTR_X0 (1 + 0.02 U(-1, 1)) from ``default_rng(4)`` in float32, each
pinned into node 0 and started from the transcription's initial guess;
the batched float32 SQP with the exact Hessian (``max_iter=150``) and
boxADMM QPs (rho 1, eps 1e-5, 40 epochs of 25 iterations, 4 Ruiz sweeps)
through the BBT epoch (the transcription's structure: S=2 blocks of
k=64); then ``bench.py``'s three-stage float64 Newton-KKT certify
(``headline.certify``).  ``chip_smoke.py`` drives :func:`run` on the card;
``tests/data/make_cstr_reference.py`` writes the JAX package's record of
the same batch.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from polympc_torch.basis import Chebyshev, SegmentedBasis
from polympc_torch.headline import KKT_TOL, certify
from polympc_torch.models import CSTR_ULB, CSTR_UUB, CSTR_X0, cstr_ocp
from polympc_torch.nlp import SQPSettings
from polympc_torch.ocp import ocp_bounds, transcribe
from polympc_torch.parallel import make_batch_solver
from polympc_torch.qp.types import ADMMSettings
from polympc_torch.utils import status as st

__all__ = ["X_SCALE", "U_SCALE", "XL", "XU", "TF", "cstr_x0s",
           "cstr_problem", "batch_fn", "run"]

X_SCALE = [2.0, 1.0, 100.0, 100.0]
U_SCALE = [15.0, 2000.0]
XL = [0.0, 0.0, 50.0, 50.0]
XU = [6.0, 4.0, 150.0, 150.0]
TF = 100.0


def cstr_x0s(B: int, seed: int = 4, spread: float = 0.02):
    """B initial conditions CSTR_X0 (1 + spread U(-1, 1)), (B, 4) float32."""
    rng = np.random.default_rng(seed)
    return (CSTR_X0[None] * (1.0 + spread * rng.uniform(-1.0, 1.0, (B, 4)))
            ).astype(np.float32)


def cstr_problem(device="cuda", dtype=torch.float32, kkt_solver="kernel",
                 max_iter: int = 150):
    """The batch's problem and solver settings: (tr, bounds, prm,
    settings); ``kkt_solver="lu"`` takes the LU epoch instead of the BBT
    kernel, ``max_iter`` cuts the SQP (for a warm-up or a trace)."""
    tr = transcribe(cstr_ocp(), SegmentedBasis(Chebyshev(5), 2),
                    x_scale=X_SCALE, u_scale=U_SCALE)
    prm = tr.params(t0=0.0, tf=TF, dtype=dtype, device=device)
    bounds = ocp_bounds(tr, ul=CSTR_ULB, uu=CSTR_UUB, xl=XL, xu=XU,
                        dtype=dtype, device=device)
    settings = SQPSettings(
        hessian="exact", max_iter=max_iter,
        qp=ADMMSettings(rho=1.0, eps_abs=1e-5, eps_rel=1e-5, max_epochs=40,
                        equil_iters=4, kkt_solver=kkt_solver,
                        structure=(tr.bbt_structure()
                                   if kkt_solver == "kernel" else None)))
    return tr, bounds, prm, settings


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def batch_fn(B: int = 256, device="cuda", x0s=None, kkt_solver="kernel",
             max_iter: int = 150):
    """The timed unit: a function of no arguments that solves the batch
    (:func:`cstr_x0s`, or ``x0s``) in float32, certifies it, and returns
    ``(sols, residuals, solve_s, certify_s)``, each wall ending in a
    synchronise."""
    device = torch.device(device)
    tr, bounds, prm, settings = cstr_problem(device, torch.float32,
                                             kkt_solver, max_iter)
    solve = make_batch_solver(tr, bounds, prm, settings)
    prm64 = tr.params(t0=0.0, tf=TF, dtype=torch.float64, device=device)
    bounds64 = bounds._replace(**{f: getattr(bounds, f).to(torch.float64)
                                  for f in bounds._fields})
    x0 = torch.as_tensor(cstr_x0s(B) if x0s is None else x0s,
                         dtype=torch.float32, device=device)

    def once():
        t0 = time.perf_counter()
        sols = solve(x0)
        _sync(device)
        t1 = time.perf_counter()
        kkt = certify(tr, x0, sols, bounds64, prm64)
        _sync(device)
        return sols, kkt, t1 - t0, time.perf_counter() - t1
    return once


def run(B: int = 256, device="cuda", x0s=None, kkt_solver="kernel",
        warmup: int = 8):
    """Solve and certify the batch once after a warm-up batch of
    ``warmup`` lanes cut to 2 SQP iterations (0: none; it loads the
    kernels and the libraries' handles: the eager solver compiles
    nothing).

    Returns ``(extra, lanes)``: ``extra`` holds batch, status_solved,
    certified, kkt_residual_max (over the certified lanes), mean_sqp_iters,
    solve_s, certify_s and wall_s_per_batch; ``lanes`` the per-lane numpy
    arrays status, iters, cost, residual and certified, and the solution
    (x, lam, lam_box) the certify started from."""
    device = torch.device(device)
    x0 = cstr_x0s(B) if x0s is None else np.asarray(x0s, np.float32)
    if warmup:
        batch_fn(warmup, device, x0[:warmup], kkt_solver, max_iter=2)()
    sols, kkt, solve_s, certify_s = batch_fn(B, device, x0, kkt_solver)()
    res = kkt.cpu().numpy()
    ok = res <= KKT_TOL
    status = sols.status.cpu().numpy()
    iters = sols.iters.cpu().numpy()
    extra = {
        "batch": B, "status_solved": int((status == st.SOLVED).sum()),
        "certified": int(ok.sum()),
        "kkt_residual_max": float(res[ok].max()) if ok.any() else None,
        "mean_sqp_iters": float(iters.mean()),
        "solve_s": solve_s, "certify_s": certify_s,
        "wall_s_per_batch": solve_s + certify_s,
    }
    lanes = {"status": status, "iters": iters,
             "cost": sols.cost.cpu().numpy().astype(np.float64),
             "residual": res, "certified": ok,
             **{k: getattr(sols, k).cpu().numpy()
                for k in ("x", "lam", "lam_box")}}
    return extra, lanes
