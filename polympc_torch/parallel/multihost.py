"""The batched horizon-partitioned solver — the port of
``make_batch_dist_solver`` in polympc_tpu/parallel/multihost.py, on one card
(no device mesh).

B independent horizon-partitioned SQP instances solve in one batch-first
``dist_sqp_solve`` call; each lane pins its own initial state into segment
0's head (the distributed analogue of MPC::initial_conditions).  Sharding
the lanes and the segments over several cards (the JAX package's
``mesh_2d``, ``initialize_multihost`` and ``process_local_batch``) waits for
the multi-card slice.
"""
from __future__ import annotations

from polympc_torch.parallel.dist_sqp import (
    DistBounds, DistSQPSettings, DistTranscription, dist_sqp_solve)

__all__ = ["make_batch_dist_solver", "pin_segment_head"]


def pin_segment_head(dtr: DistTranscription, bounds: DistBounds, x0s):
    """Per-lane bounds with segment 0's head state pinned to each lane's x0
    (B, nx); the other bounds are shared."""
    nx = dtr.ocp.nx
    B = x0s.shape[0]
    lbw = bounds.lbw.to(x0s.dtype).expand(B, dtr.S, dtr.kz).clone()
    ubw = bounds.ubw.to(x0s.dtype).expand(B, dtr.S, dtr.kz).clone()
    lbw[:, 0, :nx] = x0s
    ubw[:, 0, :nx] = x0s
    return bounds._replace(lbw=lbw, ubw=ubw)


def make_batch_dist_solver(dtr: DistTranscription, base_bounds: DistBounds,
                           settings: DistSQPSettings, d=None):
    """Returns solve(x0s (B, nx), W0s (B, S, kz), P0s (B, np)) -> dict (the
    batched ``dist_sqp_solve`` output).  Each lane pins its own x0; the
    bounds, ``d`` and the settings are shared."""
    def solve(x0s, W0s, P0s):
        bounds = pin_segment_head(dtr, base_bounds, x0s.to(W0s.dtype))
        return dist_sqp_solve(dtr, bounds, W0s, P0s, d=d, settings=settings)

    return solve
