"""Regenerate ``scaling_jax_cpu.npz``: the JAX package's per-lane record of
the horizon sweep (``benchmarks/scaling.py``'s batched kite points, each
with bench.py's certify), for the CUDA port to be held against on a
machine that has no JAX.

For each S of the sweep the problem is scaling.py's: the augmented kite
NMPF on a Chebyshev(5) x S-segment mesh, B = max(128, 1024 // S) initial
conditions from bench.py's ``default_rng(0)`` draw, each started from its
own dynamics rollout, the batched float32 SQP with scaling.py's settings
(exact Hessian, ``reg="mirror"``, ``max_iter=12``, 3 x 50 boxADMM
iterations).  Its inner QPs take the vmapped LU epoch (``kkt_solver="lu"``):
scaling.py's own "pallas" route runs the epoch kernels in interpret mode
on a CPU, far too slowly at these sizes.  Then bench.py's three-stage
float64 Newton-KKT certify (float32 solves: the LDL^T kernel in interpret
mode where ``pallas_fits`` holds, else the LU).

Run from the repository root:

    python tests/data/make_scaling_reference.py [--segments 2 4 8 16]
    python tests/data/make_scaling_reference.py --lanes

The first writes the sweep record (about 15 minutes on a CPU, the S=16 LU
epochs dominating); the second writes only ``scaling_f64_lanes_jax_cpu.npz``
(a minute): the same SQP in float64 on the first ``LANES`` lanes of
bench's draw at S = 2 and 4, ``s{S}_x`` (LANES, n), ``s{S}_status`` and
``s{S}_iters``, which the port's CPU tests hold their float64 solves
against per lane.

The sweep record holds, for each S, ``s{S}_x0s`` (B, 5) float32 and per lane the
SQP ``s{S}_status`` and ``s{S}_iters``, the certified float64 KKT
``s{S}_residual`` and the ``s{S}_certified`` mask (residual <= 1e-6);
``segments``, ``route`` and ``max_iter``.  It prints each point's seconds.
"""
import argparse
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, HERE)
sys.setrecursionlimit(1000000)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402

from make_kite_reference import bench_x0s  # noqa: E402

KKT_TOL = 1e-6
MAX_ITER = 12
XL = [0.0, -np.pi / 2, -np.pi, -100.0, -100.0]
XU = [np.pi / 2, np.pi / 2, np.pi, 100.0, 100.0]


def batch_of(S):
    """scaling.py's batch rule."""
    return max(128, 1024 // S)


def problem(S, dtype):
    """(tr, bounds, prm, settings) of scaling.py's point at S segments,
    through the "lu" epoch."""
    from polympc_tpu.basis import Chebyshev, SegmentedBasis
    from polympc_tpu.control.nmpf import augment_ocp
    from polympc_tpu.models import kite_dynamics, kite_output, kite_path
    from polympc_tpu.nlp import SQPSettings
    from polympc_tpu.ocp import ocp_bounds, transcribe
    from polympc_tpu.qp.types import ADMMSettings

    ocp = augment_ocp(lambda x, u: kite_dynamics(x, u), kite_output,
                      kite_path, nx=3, nu=1, ny=2)
    tr = transcribe(ocp, SegmentedBasis(Chebyshev(5), S))
    prm = tr.params(d=[0.05], t0=0.0, tf=2.0, dtype=dtype)
    bounds = ocp_bounds(tr, ul=[-5.0, -10.0], uu=[5.0, 10.0], xl=XL, xu=XU,
                        dtype=dtype)
    settings = SQPSettings(
        hessian="exact", max_iter=MAX_ITER, reg="mirror",
        eps_prim=1e-3, eps_dual=1e-3, eps_viol=1e-3, eps_stat=1e-2,
        qp=ADMMSettings(rho=1.0, eps_abs=1e-4, eps_rel=1e-4,
                        max_epochs=3, check_every=50, equil_iters=0,
                        kkt_solver="lu", polish=False))
    return tr, bounds, prm, settings


def certify_fn(tr, bounds, B):
    """bench.py's three-stage float64 certify (jitted, vmapped)."""
    from polympc_tpu.nlp.refine import refine_solution
    prm64 = tr.params(d=[0.05], t0=0.0, tf=2.0, dtype=jnp.float64)
    bounds64 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float64),
                                      bounds)
    nx = tr.ocp.nx
    sx64 = jnp.asarray(tr.x_scale, jnp.float64)

    def one(x0, z, lam, lam_box, **kw):
        x0s_ = jnp.asarray(x0, jnp.float64) / sx64
        b = bounds64._replace(lbx=bounds64.lbx.at[:nx].set(x0s_),
                              ubx=bounds64.ubx.at[:nx].set(x0s_))
        return refine_solution(tr.nlp, z, lam, lam_box, b, prm64,
                               solve_dtype=jnp.float32,
                               matrix_dtype=jnp.float32,
                               return_residual=True, **kw)

    @jax.jit
    def certify(x0s, sx, sl, sb):
        o = jax.vmap(lambda a, b, c, d: one(a, b, c, d, iters=2,
                                            return_last=True))(
            x0s, sx, sl, sb)
        r1, zl, laml, lambl = o[3], o[4], o[5], o[6]
        _, i2 = jax.lax.top_k(r1, min(64, B))
        o2 = jax.vmap(lambda a, b, c, d: one(a, b, c, d, iters=2))(
            x0s[i2], zl[i2], laml[i2], lambl[i2])
        r = r1.at[i2].set(jnp.minimum(r1[i2], o2[3]))
        _, i3 = jax.lax.top_k(r, min(16, B))
        o3 = jax.vmap(lambda a, b, c, d: one(
            a, b, c, d, iters=10, act_tol=1e-4, solve_ir=6))(
            x0s[i3], sx[i3], sl[i3], sb[i3])
        return r.at[i3].set(jnp.minimum(r[i3], o3[3]))
    return certify


def run_point(S, B):
    """The solve and certify of one S: a dict of the per-lane arrays."""
    from polympc_tpu.parallel import make_batch_solver
    tr, bounds, prm, settings = problem(S, jnp.float32)
    solve = make_batch_solver(tr, bounds, prm, settings)
    x0s_np = bench_x0s(B)
    x0s = jnp.asarray(x0s_np, jnp.float32)
    rollout = jax.jit(jax.vmap(lambda x0: tr.rollout_guess(x0, prm)))
    t0 = time.perf_counter()
    sols = jax.block_until_ready(solve(x0s, rollout(x0s)))
    t_solve = time.perf_counter() - t0
    with jax.enable_x64():
        certify = certify_fn(tr, bounds, B)
        t0 = time.perf_counter()
        res = np.asarray(jax.block_until_ready(
            certify(x0s, sols.x, sols.lam, sols.lam_box)), np.float64)
        t_cert = time.perf_counter() - t0
    status = np.asarray(sols.status, np.int32)
    iters = np.asarray(sols.iters, np.int32)
    certified = res <= KKT_TOL
    print(f"S={S} B={B} n={tr.nlp.n} m={tr.nlp.m} "
          f"certified={int(certified.sum())} "
          f"status_solved={int((status == 1).sum())} "
          f"mean_iters={iters.mean():.4f} solve_s={t_solve:.1f} "
          f"certify_s={t_cert:.1f}", flush=True)
    return {f"s{S}_x0s": x0s_np, f"s{S}_status": status,
            f"s{S}_iters": iters, f"s{S}_residual": res,
            f"s{S}_certified": certified}


LANES = 4
LANES_SEGMENTS = (2, 4)


def float64_lanes(S, B=LANES):
    """The point's SQP in float64 on B lanes of bench's draw (no certify):
    per lane x, status and iterations."""
    from polympc_tpu.parallel import make_batch_solver
    with jax.enable_x64():
        tr, bounds, prm, settings = problem(S, jnp.float64)
        x0s = jnp.asarray(bench_x0s(B), jnp.float64)
        z0s = jax.vmap(lambda x0: tr.rollout_guess(x0, prm))(x0s)
        sols = make_batch_solver(tr, bounds, prm, settings)(x0s, z0s)
        return {f"s{S}_x": np.asarray(sols.x, np.float64),
                f"s{S}_status": np.asarray(sols.status, np.int32),
                f"s{S}_iters": np.asarray(sols.iters, np.int32)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--segments", type=int, nargs="+", default=[2, 4, 8, 16])
    ap.add_argument("--out", default=None)
    ap.add_argument("--lanes", action="store_true",
                    help="write only the float64 lanes at S = 2 and 4")
    args = ap.parse_args()
    t0 = time.perf_counter()
    if args.lanes:
        out = {"lanes": np.int32(LANES)}
        for S in LANES_SEGMENTS:
            out.update(float64_lanes(S))
        path = args.out or os.path.join(HERE,
                                        "scaling_f64_lanes_jax_cpu.npz")
        np.savez_compressed(path, **out)
        print(f"{time.perf_counter() - t0:.1f} s -> {path}", flush=True)
        return
    args.out = args.out or os.path.join(HERE, "scaling_jax_cpu.npz")
    out = {"segments": np.asarray(args.segments, np.int32),
           "route": np.array("lu"), "max_iter": np.int32(MAX_ITER)}
    for S in args.segments:
        out.update(run_point(S, batch_of(S)))
    np.savez_compressed(args.out, **out)
    print(f"{time.perf_counter() - t0:.1f} s -> {args.out}", flush=True)


if __name__ == "__main__":
    main()
