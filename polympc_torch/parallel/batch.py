"""Batched MPC solving — the port of ``make_batch_solver`` in
polympc_tpu/parallel/batch.py (without a mesh: one device).

B independent MPC instances (initial conditions) solve in one batch-first
SQP call; per-instance iteration counts become per-lane stopping, and
per-instance status vectors replace the status enum.
"""
from __future__ import annotations

import torch

from polympc_torch.nlp.sqp import sqp_solve
from polympc_torch.nlp.types import NLPBounds, SQPSettings
from polympc_torch.ocp.transcription import Transcription

__all__ = ["make_batch_solver", "pin_initial_state"]


def pin_initial_state(tr: Transcription, bounds: NLPBounds, x0s):
    """Per-lane bounds with the first state node pinned to each lane's x0
    (physical (B, nx)); the other bounds are shared."""
    nx, n = tr.ocp.nx, tr.nlp.n
    B = x0s.shape[0]
    x0sc = x0s / torch.as_tensor(tr.x_scale, dtype=x0s.dtype,
                                 device=x0s.device)
    lbx = bounds.lbx.to(x0s.dtype).expand(B, n).clone()
    ubx = bounds.ubx.to(x0s.dtype).expand(B, n).clone()
    lbx[:, :nx] = x0sc
    ubx[:, :nx] = x0sc
    return bounds._replace(lbx=lbx, ubx=ubx), x0sc


def make_batch_solver(tr: Transcription, base_bounds: NLPBounds, prm,
                      settings: SQPSettings, rollout_guess: bool = False):
    """Build a solver for a batch of initial conditions.

    Returns solve(x0s (B, nx), z0s (B, n) | None, lam0s (B, m) | None,
    lam_box0s (B, n) | None) -> batched SQPSolution.  Each instance pins its
    own x0; everything else is shared.  Feed a previous solution's
    x/lam/lam_box back in for warm-started receding-horizon re-solves.

    With ``rollout_guess=True`` the start point is the RK4 dynamics rollout
    from each x0, and a caller's ``z0s`` is overwritten, as the JAX package
    does (a known fault there, kept for parity).
    """
    def solve(x0s, z0s=None, lam0s=None, lam_box0s=None):
        B = x0s.shape[0]
        dt, dev = x0s.dtype, x0s.device
        bounds, x0sc = pin_initial_state(tr, base_bounds, x0s)
        if rollout_guess:
            z0 = tr.rollout_guess(x0s, prm)
        elif z0s is None:
            z0 = tr.initial_guess(dtype=dt, device=dev)[None].repeat(B, 1)
        else:
            z0 = z0s.to(dt).clone()
        z0[:, :tr.ocp.nx] = x0sc
        return sqp_solve(tr.nlp, z0, p=prm, bounds=bounds, lam0=lam0s,
                         lam_box0=lam_box0s, settings=settings)

    return solve
