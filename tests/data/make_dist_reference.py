"""Regenerate ``dist_kite_s8_jax_cpu.npz``: the JAX package's per-lane record
of the batched horizon-partitioned SQP, for the CUDA port to be held against
on a machine that has no JAX.

The pipeline: the augmented kite NMPF on ``dist_transcribe(ocp,
Chebyshev(5), 8, 0.0, 2.0)`` (S=8 duplicated segments, kz=42, ml=30,
p_if=7) with ``benchmarks/scaling.py``'s bounds; B=128 lanes from bench.py's
x0 draw at B=128 (``default_rng(0)``, scaling.py's batch rule
``max(128, 1024 // S)``); each lane pins its own x0 into segment 0's head
and starts from its own ``rollout_guess(x0)``, as
``polympc_tpu/parallel/multihost.py:make_batch_dist_solver``'s
``solve_one`` does, under ``jit(vmap(...))`` without a mesh; float32,
``DistSQPSettings(max_iter=60, admm_iters=400, eps_stat=1e-2,
kkt_solver="lu")``.  Then the fp64 certify of ``tests/test_dist_sqp.py``:
``dist_refine(iters=4)`` and ``dist_kkt_residual`` per lane; a lane is
certified at a residual of at most 1e-6.

The batch runs through both KKT routes of the per-segment Schur elimination:
``kkt_solver="lu"`` (``jnp.linalg.inv``) and ``"pallas"`` (the Pallas
``ldlt_inverse``, in interpret mode on a CPU: about 20 minutes for the
batch, against under 2 for "lu"). The two compute the same inverse
(tests/test_torch_horizon.py holds the port's kernel route against the JAX
package's "pallas" route, and both against the dense oracle), but in float32
the unpivoted LDL^T inverse rounds otherwise than the pivoted LU one on
these KKTs (equality rows at rho * 1e3), and every inner QP runs to its
iteration cap, so the SQP iteration counts and statuses depend on the route.
The port's kernel route is held against the "pallas" fields, its "lu" route
against the unprefixed ones.

Run from the repository root (about 25 minutes on a CPU):

    python tests/data/make_dist_reference.py [--batch 128]

The file holds ``x0s`` (B, 5) fp32; per lane and route the SQP ``status``,
``iters``, ``qp_iters`` and ``violation``, the certified fp64 KKT
``residual`` and the ``certified`` mask (the "lu" route unprefixed, the
"pallas" route prefixed ``pallas_``); and the B=1 point's (x0 =
[0.6, 0.4, 0, 0, 0.05]) ``b1_status``, ``b1_iters`` and ``b1_violation``
(and ``b1_pallas_*``).
"""
import argparse
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
sys.setrecursionlimit(100000)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402

KKT_TOL = 1e-6
B1_X0 = [0.6, 0.4, 0.0, 0.0, 0.05]
D = [0.05]


def bench_x0s(B, seed=0):
    """bench.py's initial conditions (its ``default_rng(seed)`` draw
    order), drawn at batch size B."""
    rng = np.random.default_rng(seed)
    s0 = rng.uniform(0.0, 2 * np.pi, B)
    theta0 = np.pi / 6 + 0.2 * np.sin(2 * s0) + rng.normal(0, 0.05, B)
    phi0 = 0.8 * np.cos(s0) + rng.normal(0, 0.05, B)
    gamma0 = rng.uniform(-0.5, 0.5, B)
    return np.stack([np.clip(theta0, 0.05, 1.5), np.clip(phi0, -1.5, 1.5),
                     gamma0, s0, np.full(B, 0.05)], axis=1).astype(np.float32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--out", default=os.path.join(HERE,
                                                  "dist_kite_s8_jax_cpu.npz"))
    args = ap.parse_args()

    from polympc_tpu.basis import Chebyshev
    from polympc_tpu.control.nmpf import augment_ocp
    from polympc_tpu.models import kite_dynamics, kite_output, kite_path
    from polympc_tpu.parallel import (
        DistSQPSettings, dist_transcribe, dist_bounds, dist_sqp_solve)
    from polympc_tpu.parallel.dist_sqp import dist_refine, dist_kkt_residual

    B = args.batch
    ocp = augment_ocp(lambda x, u: kite_dynamics(x, u), kite_output,
                      kite_path, nx=3, nu=1, ny=2)
    dtr = dist_transcribe(ocp, Chebyshev(5), 8, 0.0, 2.0)
    kw = dict(ul=[-5.0, -10.0], uu=[5.0, 10.0],
              xl=[0.0, -np.pi / 2, -np.pi, -100.0, -100.0],
              xu=[np.pi / 2, np.pi / 2, np.pi, 100.0, 100.0])
    bounds = dist_bounds(dtr, dtype=jnp.float32, **kw)
    nx = ocp.nx

    def pin(b, x0):
        return b._replace(lbw=b.lbw.at[0, :nx].set(x0),
                          ubw=b.ubw.at[0, :nx].set(x0))

    def solver(route):
        settings = DistSQPSettings(max_iter=60, admm_iters=400,
                                   eps_stat=1e-2, kkt_solver=route)

        def solve_one(x0):
            W0, P0 = dtr.rollout_guess(x0, d=D, dtype=jnp.float32)
            return dist_sqp_solve(dtr, pin(bounds, x0), W0, P0, d=D,
                                  settings=settings, mesh=None)
        return jax.jit(jax.vmap(solve_one))

    with jax.enable_x64():
        b64 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float64),
                                     bounds)

        def certify_one(x0, W, P, ll, li, lbw, lbp):
            b = pin(b64, x0)
            args_ = dist_refine(dtr, b, W, P, ll, li, lbw, lbp, d=D, iters=4)
            return dist_kkt_residual(dtr, b, *args_, d=D)
        certify = jax.jit(jax.vmap(certify_one))

    x0s_np = bench_x0s(B)
    fields = {"x0s": x0s_np}
    for route, pre in (("lu", ""), ("pallas", "pallas_")):
        solve = solver(route)
        t0 = time.perf_counter()
        out = jax.block_until_ready(solve(jnp.asarray(x0s_np)))
        t_solve = time.perf_counter() - t0
        b1 = jax.block_until_ready(solve(jnp.asarray([B1_X0], jnp.float32)))
        with jax.enable_x64():
            f64 = lambda k: jnp.asarray(np.asarray(out[k]), jnp.float64)
            t0 = time.perf_counter()
            res = np.asarray(jax.block_until_ready(certify(
                jnp.asarray(x0s_np, jnp.float64), f64("W"), f64("P"),
                f64("lam_loc"), f64("lam_if"), f64("lam_bw"),
                f64("lam_bp"))), np.float64)
            t_cert = time.perf_counter() - t0
        certified = res <= KKT_TOL
        status = np.asarray(out["status"], np.int32)
        fields.update({
            pre + "status": status,
            pre + "iters": np.asarray(out["iters"], np.int32),
            pre + "qp_iters": np.asarray(out["qp_iters"], np.int32),
            pre + "violation": np.asarray(out["violation"], np.float64),
            pre + "residual": res, pre + "certified": certified,
            "b1_" + pre + "status": np.asarray(b1["status"], np.int32)[0],
            "b1_" + pre + "iters": np.asarray(b1["iters"], np.int32)[0],
            "b1_" + pre + "violation": np.asarray(b1["violation"],
                                                  np.float64)[0]})
        print(f"{route}: B={B} certified={int(certified.sum())} "
              f"status_solved={int((status == 1).sum())} "
              f"mean_iters={np.asarray(out['iters']).mean():.4f} "
              f"max_res={res.max():.3e} b1_status={int(b1['status'][0])} "
              f"b1_iters={int(b1['iters'][0])} solve_s={t_solve:.1f} "
              f"certify_s={t_cert:.1f}", flush=True)
    np.savez_compressed(args.out, **fields)
    print(f"-> {args.out}")


if __name__ == "__main__":
    main()
