"""Multi-process bootstrap and the composed (batch x horizon) solver — the
port of polympc_tpu/parallel/multihost.py on ``torch.distributed``.

  * :func:`initialize_multihost`: ``init_process_group`` from arguments or
    the ``POLYMPC_COORDINATOR`` / ``POLYMPC_NUM_PROCESSES`` /
    ``POLYMPC_PROCESS_ID`` environment (NCCL on cards, gloo on the CPU), a
    no-op for one process, idempotent;
  * :func:`mesh_2d`: a ("dp", "seg") device mesh, "seg" the inner,
    fastest-varying dimension, so a segment group is consecutive ranks
    (one host's cards) and "dp" spans hosts;
  * :func:`process_local_batch`: a global batch as a ``DTensor`` from each
    process's local rows (``make_array_from_process_local_data``);
  * :func:`make_batch_dist_solver`: B independent horizon-partitioned SQP
    instances in one batch-first ``dist_sqp_solve`` call, each lane pinning
    its own initial state into segment 0's head (the distributed analogue
    of MPC::initial_conditions); given a mesh, the lanes split over "dp"
    and each lane's segments over "seg".
"""
from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.distributed as dist

from polympc_torch.parallel.batch import local_rows, shard_rows
from polympc_torch.parallel.dist_sqp import (
    DistBounds, DistSQPSettings, DistTranscription, dist_sqp_solve)
from polympc_torch.parallel.mesh import mesh_device_type

__all__ = ["initialize_multihost", "mesh_2d", "process_local_batch",
           "make_batch_dist_solver", "pin_segment_head"]


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device="cuda") -> bool:
    """Join an N-process ``torch.distributed`` job.

    Reads ``POLYMPC_COORDINATOR`` ("host:port"), ``POLYMPC_NUM_PROCESSES``
    and ``POLYMPC_PROCESS_ID`` where the arguments are omitted.  The group
    runs NCCL, each process on card ``process_id % device_count``, where
    CUDA is present and ``device`` is not "cpu"; gloo otherwise.  Returns
    True when it initialised a process group, False for the
    single-process no-op; a second call (or a group already initialised)
    initialises nothing and returns whether that group has several
    processes.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "POLYMPC_COORDINATOR")
    if num_processes is None and "POLYMPC_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["POLYMPC_NUM_PROCESSES"])
    if process_id is None and "POLYMPC_PROCESS_ID" in os.environ:
        process_id = int(os.environ["POLYMPC_PROCESS_ID"])
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if num_processes in (None, 1) and coordinator_address is None:
        return False                      # single process: nothing to do
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("initialize_multihost needs the coordinator's "
                         "address, the number of processes and this "
                         "process's id")
    nccl = (torch.device(device).type == "cuda"
            and torch.cuda.is_available())
    if nccl:
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group("nccl" if nccl else "gloo",
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def mesh_2d(dp: int, seg: int, devices=None, dp_axis: str = "dp",
            seg_axis: str = "seg"):
    """A (dp, seg) device mesh over the default group's ranks (or the
    ranks ``devices``), rank r at (r // seg, r % seg): "seg" on the inner
    dimension keeps each segment group on consecutive ranks, one host's
    cards, for the interface ``all_gather``s, while "dp" (no collective)
    spans hosts.  Every process calls it."""
    from torch.distributed.device_mesh import DeviceMesh
    ranks = list(range(dist.get_world_size()) if devices is None
                 else devices)
    if len(ranks) < dp * seg:
        raise ValueError(f"need {dp * seg} processes, have {len(ranks)}")
    grid = torch.tensor(ranks[:dp * seg]).reshape(dp, seg)
    return DeviceMesh(mesh_device_type(), grid,
                      mesh_dim_names=(dp_axis, seg_axis))


def process_local_batch(global_shape, mesh, placements, local_data):
    """A global batch as a ``DTensor`` on ``mesh`` with ``placements`` (one
    per mesh dimension, e.g. ``(Shard(0), Replicate())`` for rows over
    "dp") from this process's local part only: every process holds just
    its own rows (no communication)."""
    from torch.distributed.tensor import DTensor
    shape = tuple(int(s) for s in global_shape)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(torch.as_tensor(local_data), mesh,
                              placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


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
                           settings: DistSQPSettings, d=None, mesh=None,
                           dp_axis: str = "dp", seg_axis: str = "seg"):
    """Returns solve(x0s (B, nx), W0s (B, S, kz), P0s (B, np)) -> dict (the
    batched ``dist_sqp_solve`` output).  Each lane pins its own x0; the
    bounds, ``d`` and the settings are shared.

    With a ``mesh`` (:func:`mesh_2d`) the lanes split over ``dp_axis``
    (each process solves its rows: inputs whole on every process, or
    ``DTensor``s sharded by rows over "dp") and each lane's segments over
    ``seg_axis`` (``dist_sqp_solve`` on the mesh); every output is a
    ``DTensor`` sharded by rows over "dp" and whole on each process of a
    segment group (the JAX package lays W out over (dp, seg); here the
    segment group gathers it).  B must be a multiple of the "dp" size and
    S of the "seg" size.
    """
    if mesh is not None and not {dp_axis, seg_axis} <= set(
            mesh.mesh_dim_names or ()):
        raise ValueError(f"make_batch_dist_solver: the mesh needs the "
                         f"dimensions {dp_axis!r} and {seg_axis!r}")

    def solve_rows(x0s, W0s, P0s):
        bounds = pin_segment_head(dtr, base_bounds, x0s.to(W0s.dtype))
        return dist_sqp_solve(dtr, bounds, W0s, P0s, d=d, settings=settings,
                              mesh=mesh, axis=seg_axis)

    def solve(x0s, W0s, P0s):
        if mesh is None:
            return solve_rows(x0s, W0s, P0s)
        out = solve_rows(*(local_rows(t, mesh, dp_axis)
                           for t in (x0s, W0s, P0s)))
        return {k: shard_rows(v, mesh, dp_axis) for k, v in out.items()}

    return solve
