"""Batched MPC solving — the port of polympc_tpu/parallel/batch.py.

B independent MPC instances (initial conditions) solve in one batch-first
SQP call; per-instance iteration counts become per-lane stopping, and
per-instance status vectors replace the status enum.

Across processes the batch axis is split over a data-parallel ("dp")
``torch.distributed`` device mesh (:func:`batch_mesh`): each process solves
its own rows, and the outputs are ``DTensor``s sharded over "dp" (the JAX
package's ``out_shardings``).  No lane talks to another, so the solve
itself runs no collective.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from polympc_torch.nlp.sqp import sqp_solve
from polympc_torch.nlp.types import NLPBounds, SQPSettings
from polympc_torch.ocp.transcription import Transcription, _host_constant
from polympc_torch.parallel.mesh import mesh_device_type
from polympc_torch.utils.timing import span

__all__ = ["make_batch_solver", "pin_initial_state", "batch_mesh",
           "shard_batch"]


def pin_initial_state(tr: Transcription, bounds: NLPBounds, x0s):
    """Per-lane bounds with the first state node pinned to each lane's x0
    (physical (B, nx)); the other bounds are shared."""
    nx, n = tr.ocp.nx, tr.nlp.n
    B = x0s.shape[0]
    x0sc = x0s / _host_constant(tr.x_scale, x0s.dtype, x0s.device)
    lbx = bounds.lbx.to(x0s.dtype).expand(B, n).clone()
    ubx = bounds.ubx.to(x0s.dtype).expand(B, n).clone()
    lbx[:, :nx] = x0sc
    ubx[:, :nx] = x0sc
    return bounds._replace(lbx=lbx, ubx=ubx), x0sc


def _row_placements(mesh, dp_axis):
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(0) if name == dp_axis else Replicate()
                 for name in mesh.mesh_dim_names)


def local_rows(t, mesh, dp_axis: str = "dp"):
    """This process's rows of a batched input: the local part of a
    ``DTensor`` sharded by rows over ``dp_axis`` (and replicated over the
    mesh's other dimensions), or the process's block of B / n consecutive
    rows of a tensor every process holds whole.  None stays None."""
    from torch.distributed.tensor import DTensor
    if t is None:
        return None
    if isinstance(t, DTensor):
        if tuple(t.placements) != _row_placements(mesh, dp_axis):
            raise ValueError(f"a DTensor input must be sharded by rows over "
                             f"{dp_axis!r}, got {t.placements}")
        return t.to_local()
    n = dist.get_world_size(mesh.get_group(dp_axis))
    if t.shape[0] % n:
        raise ValueError(f"a batch of {t.shape[0]} over a {dp_axis!r} group "
                         f"of {n} processes: B must be a multiple of it")
    b = t.shape[0] // n
    r = mesh.get_local_rank(dp_axis)
    return t[r * b:(r + 1) * b]


def shard_rows(t, mesh, dp_axis: str = "dp"):
    """A ``DTensor`` sharded by rows over ``dp_axis`` from this process's
    rows ``t`` (no communication).  None stays None."""
    from torch.distributed.tensor import DTensor
    if t is None:
        return None
    return DTensor.from_local(t, mesh, _row_placements(mesh, dp_axis),
                              run_check=False)


def make_batch_solver(tr: Transcription, base_bounds: NLPBounds, prm,
                      settings: SQPSettings, mesh=None,
                      rollout_guess: bool = False):
    """Build a solver for a batch of initial conditions.

    Returns solve(x0s (B, nx), z0s (B, n) | None, lam0s (B, m) | None,
    lam_box0s (B, n) | None) -> batched SQPSolution.  Each instance pins its
    own x0; everything else is shared.  Feed a previous solution's
    x/lam/lam_box back in for warm-started receding-horizon re-solves.

    With a ``mesh`` (:func:`batch_mesh`) each process solves its rows of the
    batch (inputs whole on every process, or ``DTensor``s sharded by rows
    over "dp") and every field of the SQPSolution is a ``DTensor`` sharded
    by rows over "dp"; B must be a multiple of the mesh's size.

    With ``rollout_guess=True`` the start point is the RK4 dynamics rollout
    from each x0, and a caller's ``z0s`` is overwritten, as the JAX package
    does (a known fault there, kept for parity).
    """
    def solve_rows(x0s, z0s, lam0s, lam_box0s):
        B = x0s.shape[0]
        dt, dev = x0s.dtype, x0s.device
        with span("batch.start"):
            bounds, x0sc = pin_initial_state(tr, base_bounds, x0s)
            if rollout_guess:
                z0 = tr.rollout_guess(x0s, prm)
            elif z0s is None:
                z0 = tr.initial_guess(dtype=dt, device=dev)[None].repeat(
                    B, 1)
            else:
                z0 = z0s.to(dt).clone()
            z0[:, :tr.ocp.nx] = x0sc
        return sqp_solve(tr.nlp, z0, p=prm, bounds=bounds, lam0=lam0s,
                         lam_box0=lam_box0s, settings=settings)

    def solve(x0s, z0s=None, lam0s=None, lam_box0s=None):
        with span("batch.solve", B=x0s.shape[0]):
            if mesh is None:
                return solve_rows(x0s, z0s, lam0s, lam_box0s)
            sol = solve_rows(*(local_rows(t, mesh)
                               for t in (x0s, z0s, lam0s, lam_box0s)))
            return type(sol)(*(shard_rows(t, mesh) for t in sol))

    return solve


def batch_mesh(devices=None):
    """1-D data-parallel ("dp") ``torch.distributed`` device mesh over the
    processes of the default group (every rank, or the ranks ``devices``;
    every process calls it)."""
    from torch.distributed.device_mesh import DeviceMesh
    ranks = list(range(dist.get_world_size()) if devices is None
                 else devices)
    return DeviceMesh(mesh_device_type(), ranks, mesh_dim_names=("dp",))


def shard_batch(arr, mesh):
    """A batched tensor (whole on every process) as a ``DTensor`` sharded by
    rows over the mesh's "dp" dimension."""
    return shard_rows(local_rows(arr, mesh), mesh)
