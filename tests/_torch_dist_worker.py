"""The ranks of tests/test_torch_multihost.py: one gloo process group of
four ranks computes every sharded result of the port from the test's numpy
inputs and writes it to the test's directory.

Imports only ``polympc_torch`` (and torch, numpy): the ranks are spawned
processes that never load JAX.  ``main`` runs on every rank, in one order,
every call that takes a mesh (each a collective over its group): first
those that need nothing from the test, then, once the test has written its
inputs (the JAX package's dist solution, which it computes while the ranks
start), the dist SQP and refine.  Then each rank computes one of the
mesh-less references the test holds the sharded results against, so those
run side by side.
"""
import os
import time

import numpy as np
import torch

from polympc_torch.headline import KITE_BOUNDS, kite_ocp
from polympc_torch.multichip_point import KITE_X0

NPROCS = 4
KITE_KW = KITE_BOUNDS
D = [0.05]
SOL_KEYS = ("W", "P", "lam_loc", "lam_if", "lam_bw", "lam_bp")
# the Schur cases: S = 4 segments (one a rank), k = 12, p = 3, border a
SCHUR = {"plain": (4, 12, 3, 0), "border": (4, 12, 3, 2)}
SCHUR_LANES = 2
# the dist SQP of tests/test_dist_sqp.py's mesh tests: kite, Chebyshev(5)
# x 8 segments (two a rank); 4 SQP iterations of 50 ADMM iterations (those
# tests take 8 of 150: the iterations cost the ranks' gathers, and fewer
# hold the same code to the same tolerance)
DIST_S = 8
DIST_SETTINGS = dict(max_iter=4, admm_iters=50)
# how long a rank waits for the test's inputs (within the 120 s join)
INPUTS_WAIT_S = 100.0
# the composed solver: kite, Chebyshev(3) x 4 segments on a (2, 2) mesh
COMPOSED_S, COMPOSED_B = 4, 4
COMPOSED_SETTINGS = dict(max_iter=6, admm_iters=100)
BATCH_B = 8
# the long-horizon Newton step: the card path's pendulum
# (long_horizon_point.long_horizon) on 8 segments (two a rank), t in [0, 4]
LH_S = 8
LH_X0 = (1.5, 0.0)


def schur_lane(S, k, p, a, seed):
    """One lane of quasi-definite segment blocks [[H, A'], [A, -D]], picks
    on the primal part, G = -0.1 I and a border when a > 0 (the generator
    of tests/test_torch_horizon.py); numpy float64."""
    rng = np.random.default_rng(seed)
    nz = k - 4
    Hh = rng.normal(size=(S, nz, nz))
    H = Hh @ Hh.transpose(0, 2, 1) / nz + np.eye(nz)
    A = rng.normal(size=(S, k - nz, nz))
    K = np.zeros((S, k, k))
    K[:, :nz, :nz] = H
    K[:, :nz, nz:] = A.transpose(0, 2, 1)
    K[:, nz:, :nz] = A
    K[:, nz:, nz:] = -np.eye(k - nz) * rng.uniform(0.5, 2.0, (S, 1, 1))
    E = np.zeros((p, k))
    F = np.zeros((p, k))
    E[:, nz - p:nz] = np.eye(p)
    F[:, :p] = -np.eye(p)
    lane = {"K": K, "b": rng.normal(size=(S, k)),
            "c": rng.normal(size=(S - 1, p)) * 0.1,
            "G": np.tile(-0.1 * np.eye(p)[None], (S - 1, 1, 1)),
            "E": E, "F": F}
    if a:
        Dh = rng.normal(size=(a, a))
        lane.update(C=rng.normal(size=(S, k, a)) * 0.3,
                    Dg=Dh @ Dh.T + 0.5 * np.eye(a),
                    bg=rng.normal(size=(a,)))
    return lane


def schur_lanes(case):
    S, k, p, a = SCHUR[case]
    return [schur_lane(S, k, p, a, seed=100 + 10 * a + i)
            for i in range(SCHUR_LANES)]


def kite_x0s(B, seed):
    """B kite initial states (the dry run's draw), float64."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0.4, 0.8, B), rng.uniform(-0.4, 0.4, B),
                     np.zeros(B), rng.uniform(0, 6, B), np.full(B, 0.05)],
                    axis=1)


def _schur(mesh):
    """The sharded Schur results: solve, and factor + apply through both
    KKT routes, without and with a border."""
    from polympc_torch.parallel import horizon as th
    out = {}
    for case in SCHUR:
        lanes = schur_lanes(case)
        t = {n: torch.tensor(np.stack([ln[n] for ln in lanes]))
             for n in ("K", "b", "c", "G", "C", "Dg", "bg") if n in lanes[0]}
        E, F = lanes[0]["E"], lanes[0]["F"]
        border = {n: t[n] for n in ("C", "Dg", "bg") if n in t}
        got = th.schur_horizon_solve(t["K"], t["b"], E, F, t["c"], G=t["G"],
                                     mesh=mesh, **border)
        for name, v in zip(("w", "mu", "g"), got):
            out[f"schur_{case}_solve_{name}"] = v.numpy()
        for solver in ("lu", "kernel"):
            fac = th.schur_horizon_factor(
                t["K"], E, F, G=t["G"], C=border.get("C"),
                Dg=border.get("Dg"), kkt_solver=solver, mesh=mesh)
            got = th.schur_horizon_apply(fac, t["b"], t["c"],
                                         bg=border.get("bg"))
            for name, v in zip(("w", "mu", "g"), got):
                out[f"schur_{case}_{solver}_{name}"] = v.numpy()
    return out


def _dist_problem(S, order, x0=None):
    from polympc_torch.basis import Chebyshev
    from polympc_torch.parallel import dist_bounds, dist_transcribe
    dtr = dist_transcribe(kite_ocp(), Chebyshev(order), S, 0.0, 2.0)
    return dtr, dist_bounds(dtr, x0=x0, device="cpu", **KITE_KW)


def _dist(inp, mesh):
    """The kite dist SQP from the test's W0 and dist_refine from the JAX
    package's solution, each on ``mesh`` (or without one)."""
    from polympc_torch.parallel import (
        DistSQPSettings, dist_refine, dist_sqp_solve)
    dtr, b = _dist_problem(DIST_S, 5, KITE_X0)
    out = dist_sqp_solve(dtr, b, torch.tensor(inp["dist_W0"]),
                         torch.tensor(inp["dist_P0"]), d=D,
                         settings=DistSQPSettings(**DIST_SETTINGS),
                         mesh=mesh)
    res = {f"dist_{k}": out[k].numpy() for k in
           SOL_KEYS + ("status", "iters", "qp_iters")}
    ref = dist_refine(dtr, b, *(torch.tensor(inp[f"refine_in_{k}"])
                                for k in SOL_KEYS), d=D, iters=2, mesh=mesh)
    res.update({f"refine_{k}": v.numpy() for k, v in zip(SOL_KEYS, ref)})
    return res


def _composed(mesh):
    """make_batch_dist_solver on a (2, 2) mesh (or without one): B=4 kite
    lanes, each from its own rollout guess."""
    from polympc_torch.parallel import DistSQPSettings, make_batch_dist_solver
    dtr, b = _dist_problem(COMPOSED_S, 3)
    x0 = torch.tensor(kite_x0s(COMPOSED_B, 1))
    W0, P0 = dtr.rollout_guess(x0, d=D)
    out = make_batch_dist_solver(dtr, b, DistSQPSettings(**COMPOSED_SETTINGS),
                                 d=D, mesh=mesh)(x0, W0, P0)
    whole = lambda v: v.full_tensor() if mesh is not None else v
    return {f"composed_{k}": whole(out[k]).numpy()
            for k in ("W", "P", "status", "iters", "qp_iters")}


def _batch(mesh):
    """make_batch_solver over a "dp" mesh (or without one): bench's kite,
    B=8 lanes, two SQP iterations, in float64."""
    import dataclasses
    from polympc_torch.headline import kite_problem
    from polympc_torch.parallel import make_batch_solver
    tr, bounds, prm, settings = kite_problem("cpu", torch.float64)
    settings = dataclasses.replace(settings, max_iter=2)
    x0 = torch.tensor(kite_x0s(BATCH_B, 2))
    sol = make_batch_solver(tr, bounds, prm, settings, mesh=mesh,
                            rollout_guess=True)(x0)
    whole = lambda v: v.full_tensor() if mesh is not None else v
    out = {f"batch_{k}": whole(getattr(sol, k)).numpy()
           for k in ("x", "lam", "status", "iters")}
    if mesh is not None:
        out["batch_local_rows"] = np.int64(sol.x.to_local().shape[0])
    return out


def _errors(mesh):
    """The error a segment count that is not a multiple of the group size
    raises (before any collective)."""
    from polympc_torch.parallel import horizon as th
    lane = schur_lane(6, 12, 3, 0, seed=7)
    t = {n: torch.tensor(lane[n])[None] for n in ("K", "b", "c")}
    try:
        th.schur_horizon_solve(t["K"], t["b"], lane["E"], lane["F"], t["c"],
                               mesh=mesh)
    except ValueError as err:
        return {"error_not_a_multiple": np.array(str(err))}
    return {"error_not_a_multiple": np.array("")}


def _sharding(mesh2):
    """process_local_batch and shard_batch: a DTensor from each rank's rows
    and its whole again."""
    from torch.distributed.tensor import Replicate, Shard
    from polympc_torch.parallel import (
        batch_mesh, process_local_batch, shard_batch)
    glob = torch.arange(24, dtype=torch.float64).reshape(8, 3)
    dp = mesh2.get_local_rank("dp")
    dt = process_local_batch((8, 3), mesh2, (Shard(0), Replicate()),
                             glob[4 * dp:4 * dp + 4].numpy())
    sb = shard_batch(glob, batch_mesh())
    return {"plb_whole": dt.full_tensor().numpy(),
            "plb_local_rows": np.int64(dt.to_local().shape[0]),
            "shard_batch_whole": sb.full_tensor().numpy(),
            "shard_batch_local_rows": np.int64(sb.to_local().shape[0])}


def long_horizon_inputs():
    """(Z (S, nz), LAM (S, ne), x0) of the step, numpy float64: the
    constant guess of x0 perturbed by 0.1 N(0, 1), multipliers
    0.1 N(0, 1)."""
    from polympc_torch.long_horizon_point import long_horizon
    lh = long_horizon(LH_S)
    rng = np.random.default_rng(31)
    x0 = np.asarray(LH_X0)
    Z = lh.initial_guess(x0, device="cpu").numpy() + \
        0.1 * rng.normal(size=(LH_S, lh.nz))
    return Z, 0.1 * rng.normal(size=(LH_S, lh.ne)), x0


def _long_horizon(mesh):
    """One long_horizon_newton_step on ``mesh`` (or without one): each
    rank builds its own segments' blocks."""
    from polympc_torch.long_horizon_point import long_horizon
    from polympc_torch.parallel.long_horizon import long_horizon_newton_step
    Z, LAM, x0 = (torch.tensor(a) for a in long_horizon_inputs())
    out = long_horizon_newton_step(long_horizon(LH_S), Z, LAM, x0,
                                   mesh=mesh)
    return {f"lh_{k}": v.numpy() for k, v in zip(("Z", "LAM", "cont"), out)}


def _wait_for(path):
    """The test's inputs, once it has moved them into place."""
    deadline = time.monotonic() + INPUTS_WAIT_S
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no inputs at {path}")
        time.sleep(0.05)
    return dict(np.load(path))


def main(rank, nprocs, in_path, out_dir):
    """Every rank: the sharded results (collectives, in one order), then
    this rank's mesh-less reference; writes ``rank{rank}.npz``."""
    from polympc_torch import multichip_point
    from polympc_torch.parallel import batch_mesh, horizon_mesh, mesh_2d
    seg = horizon_mesh(nprocs)
    mesh2 = mesh_2d(2, nprocs // 2)
    out = {**_schur(seg), **_composed(mesh2), **_batch(batch_mesh()),
           **_errors(seg), **_sharding(mesh2), **_long_horizon(seg)}
    stages = multichip_point.stages(rank, nprocs, "cpu")
    for stage, rep in stages.items():
        out[f"stage_{stage}_diff"] = np.float64(
            rep["max_abs_diff_vs_meshless"])
        out[f"stage_{stage}_ranks"] = np.int64(rep["ranks"])
    inp = _wait_for(in_path)
    out.update(_dist(inp, seg))
    meshless = {0: lambda: {**_schur(None), **_dist(inp, None)},
                1: lambda: _composed(None),
                2: lambda: _batch(None),
                3: lambda: _long_horizon(None)}.get(rank, dict)()
    out.update({f"meshless_{k}": v for k, v in meshless.items()})
    path = os.path.join(out_dir, f"rank{rank}.npz")
    np.savez(path, **out)
    return path
