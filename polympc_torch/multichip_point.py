"""The multi-process dry run: the port's twin of
``__graft_entry__.dryrun_multichip``, every mesh path once at small
shapes, each held against the same solve without a mesh.

    python -m polympc_torch.multichip_point 4 --device cpu   # 4 gloo ranks
    python -m polympc_torch.multichip_point 4                # 4 cards, NCCL

:func:`run` starts n processes (:func:`launch`), one ``torch.distributed``
rank each (one card each under NCCL, gloo on the CPU), and every rank runs
three stages:

  1. dp: the batched kite solve (Chebyshev(5) x 2, two SQP iterations of
     one ADMM epoch) of B = 2n lanes over a 1-D "dp" mesh
     (``make_batch_solver(mesh=batch_mesh())``): each rank solves its two
     rows, the solution a ``DTensor`` sharded over "dp";
  2. seg: the constrained kite on ``dist_transcribe(..., Chebyshev(3), n)``,
     one segment per rank, through ``dist_sqp_solve(mesh=horizon_mesh())``
     (each rank eliminates its segment, the condensed blocks gathered);
  3. dp x seg: where n // 2 >= 2, a batch of 4 horizon-partitioned kites
     on ``mesh_2d(2, n // 2)`` (``make_batch_dist_solver(mesh=...)``).

Rank 0 returns, per stage, the shapes, the ranks the result is spread
over and the largest difference from the solve without a mesh.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import queue
import socket
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from polympc_torch.headline import KITE_BOUNDS, kite_ocp

__all__ = ["free_port", "launch", "run", "stages"]

KITE_X0 = [0.6, 0.4, 0.0, 0.0, 0.05]


def free_port() -> int:
    """A free TCP port on localhost for the group's rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, nprocs, device, port, results, args):
    from polympc_torch.parallel.multihost import initialize_multihost
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        initialize_multihost(f"127.0.0.1:{port}", nprocs, rank,
                             device=device)
        results.put((rank, True, fn(rank, nprocs, *args)))
    except BaseException:             # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn, nprocs: int, device="cuda", args=(), timeout: float = 600.0):
    """Run ``fn(rank, nprocs, *args)`` in ``nprocs`` spawned processes, each
    a rank of one process group on a free localhost port (NCCL, a card
    each, for a CUDA ``device``; gloo for "cpu", one intra-op thread each).
    ``fn`` is a module-level function and returns something picklable.
    Returns every rank's result by rank.  A rank that raises, or a run
    past ``timeout`` seconds, kills every process and raises."""
    if torch.device(device).type == "cuda" and \
            torch.cuda.device_count() < nprocs:
        raise RuntimeError(f"launch: {nprocs} ranks need {nprocs} cards, "
                           f"have {torch.cuda.device_count()}")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(
        fn, r, nprocs, device, port, results, tuple(args)), daemon=True)
        for r in range(nprocs)]
    for p in procs:
        p.start()
    out, deadline = {}, time.monotonic() + timeout
    try:
        while len(out) < nprocs:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"launch: {nprocs} ranks of {fn.__name__}"
                                   f" not done after {timeout} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"launch: a rank exited with {dead}")
                continue
            if not ok:
                raise RuntimeError(f"launch: rank {rank} raised:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    return [out[r] for r in range(nprocs)]


def _dist_kite(S, dev):
    from polympc_torch.basis import Chebyshev
    from polympc_torch.parallel import dist_bounds, dist_transcribe
    dtr = dist_transcribe(kite_ocp(), Chebyshev(3), S, 0.0, 2.0)
    db = dist_bounds(dtr, x0=KITE_X0, dtype=torch.float32, device=dev,
                     **KITE_BOUNDS)
    return dtr, db


def _spread(t):
    """(global shape, ranks the DTensor's mesh spans)."""
    return list(t.shape), int(t.device_mesh.mesh.numel())


def _stage_dp(n, dev):
    from polympc_torch.basis import Chebyshev, SegmentedBasis
    from polympc_torch.nlp import SQPSettings
    from polympc_torch.ocp import ocp_bounds, transcribe
    from polympc_torch.parallel import batch_mesh, make_batch_solver
    from polympc_torch.qp.types import ADMMSettings
    tr = transcribe(kite_ocp(), SegmentedBasis(Chebyshev(5), 2))
    prm = tr.params(d=[0.05], t0=0.0, tf=2.0, dtype=torch.float32,
                    device=dev)
    bounds = ocp_bounds(tr, dtype=torch.float32, device=dev, **KITE_BOUNDS)
    settings = SQPSettings(hessian="exact", max_iter=2, qp=ADMMSettings(
        rho=1.0, eps_abs=1e-4, eps_rel=1e-4, max_epochs=1, check_every=10))
    B = 2 * n
    rng = np.random.default_rng(0)
    x0s = torch.as_tensor(np.stack(
        [rng.uniform(0.3, 0.8, B), rng.uniform(-0.5, 0.5, B), np.zeros(B),
         rng.uniform(0, 6.0, B), np.full(B, 0.05)], axis=1),
        dtype=torch.float32, device=dev)
    sols = make_batch_solver(tr, bounds, prm, settings,
                             mesh=batch_mesh())(x0s)
    ref = make_batch_solver(tr, bounds, prm, settings)(x0s)
    x = sols.x.full_tensor()
    if sols.x.to_local().shape != (2, tr.nlp.n) or x.shape != (B, tr.nlp.n):
        raise RuntimeError("dp stage: a solution of the wrong shape")
    shape, ranks = _spread(sols.x)
    return {"x": shape, "ranks": ranks,
            "max_abs_diff_vs_meshless": float((x - ref.x).abs().max())}


def _stage_seg(n, dev):
    from polympc_torch.parallel import (
        DistSQPSettings, dist_sqp_solve, horizon_mesh)
    dtr, db = _dist_kite(n, dev)
    x0 = torch.tensor([KITE_X0], dtype=torch.float32, device=dev)
    W0, P0 = dtr.initial_guess(x0)
    kw = dict(d=[0.05], settings=DistSQPSettings(max_iter=2, admm_iters=20))
    out = dist_sqp_solve(dtr, db, W0, P0, mesh=horizon_mesh(n), **kw)
    ref = dist_sqp_solve(dtr, db, W0, P0, **kw)
    if out["W"].shape != (1, n, dtr.kz):
        raise RuntimeError("seg stage: a solution of the wrong shape")
    return {"W": list(out["W"].shape), "segments": n, "ranks": n,
            "max_abs_diff_vs_meshless": float(
                (out["W"] - ref["W"]).abs().max())}


def _stage_dp_seg(n, dev):
    from polympc_torch.parallel import (
        DistSQPSettings, make_batch_dist_solver, mesh_2d)
    dp, seg = 2, n // 2
    dtr, db = _dist_kite(seg, dev)
    B = 2 * dp
    rng = np.random.default_rng(1)
    x0b = torch.as_tensor(np.stack(
        [rng.uniform(0.4, 0.8, B), rng.uniform(-0.4, 0.4, B), np.zeros(B),
         rng.uniform(0, 6, B), np.full(B, 0.05)], axis=1),
        dtype=torch.float32, device=dev)
    W0b, P0b = dtr.initial_guess(x0b)
    st = DistSQPSettings(max_iter=2, admm_iters=20)
    out = make_batch_dist_solver(dtr, db, st, d=[0.05],
                                 mesh=mesh_2d(dp, seg))(x0b, W0b, P0b)
    ref = make_batch_dist_solver(dtr, db, st, d=[0.05])(x0b, W0b, P0b)
    W = out["W"].full_tensor()
    if W.shape != (B, seg, dtr.kz):
        raise RuntimeError("dp x seg stage: a solution of the wrong shape")
    shape, ranks = _spread(out["W"])
    return {"W": shape, "dp": dp, "seg": seg, "ranks": ranks,
            "max_abs_diff_vs_meshless": float(
                (W - ref["W"]).abs().max())}


def stages(rank, n, device="cuda"):
    """The three stages on this rank (see the module docstring); a dict by
    stage, the composed stage left out where n // 2 < 2."""
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if torch.device(device).type == "cuda" else torch.device("cpu")
    out = {"dp": _stage_dp(n, dev), "seg": _stage_seg(n, dev)}
    if n // 2 >= 2:
        out["dp_seg"] = _stage_dp_seg(n, dev)
    return out


def run(n: int, device="cuda", timeout: float = 900.0):
    """The dry run over ``n`` ranks (gloo processes for ``device="cpu"``,
    one NCCL rank per card otherwise): rank 0's :func:`stages` report and
    the seconds the whole run took."""
    t0 = time.perf_counter()
    out = launch(stages, n, device, (device,), timeout)[0]
    return out, time.perf_counter() - t0


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("n", type=int)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    report, secs = run(a.n, a.device)
    print(json.dumps({"stages": report, "seconds": secs}))
