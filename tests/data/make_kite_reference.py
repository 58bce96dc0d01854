"""Regenerate ``kite_b512_jax_cpu.npz``: the JAX package's per-lane record of
the certified kite batch, for the CUDA port to be held against on a machine
that has no JAX.

The pipeline is ``bench.py``'s, step for step: the augmented kite NMPF on a
Chebyshev(5) x 2-segment mesh, the batched fp32 SQP (exact Hessian,
``reg="mirror"``, 3 x 50 boxADMM iterations through the BBT epoch kernel,
``max_iter=9``, rollout guess), then the three-stage fp64 Newton-KKT
certify with fp32 LDL^T solves.  On a CPU the Pallas kernels run in
interpret mode.

Run from the repository root:

    python tests/data/make_kite_reference.py [--batch 512]

The file holds ``x0s`` (B, 5) fp32, the certified fp64 KKT residual per
lane, the certified mask (residual <= 1e-6), and the SQP ``status`` and
``iters`` per lane.
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


def bench_x0s(B, seed=0):
    """bench.py's initial conditions (its ``default_rng(0)`` draw order)."""
    rng = np.random.default_rng(seed)
    s0 = rng.uniform(0.0, 2 * np.pi, B)
    theta0 = np.pi / 6 + 0.2 * np.sin(2 * s0) + rng.normal(0, 0.05, B)
    phi0 = 0.8 * np.cos(s0) + rng.normal(0, 0.05, B)
    gamma0 = rng.uniform(-0.5, 0.5, B)
    return np.stack([np.clip(theta0, 0.05, 1.5), np.clip(phi0, -1.5, 1.5),
                     gamma0, s0, np.full(B, 0.05)], axis=1).astype(np.float32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--out", default=os.path.join(HERE,
                                                  "kite_b512_jax_cpu.npz"))
    args = ap.parse_args()

    from polympc_tpu.basis import Chebyshev, SegmentedBasis
    from polympc_tpu.control.nmpf import augment_ocp
    from polympc_tpu.models import kite_dynamics, kite_output, kite_path
    from polympc_tpu.nlp import SQPSettings
    from polympc_tpu.nlp.refine import refine_solution
    from polympc_tpu.ocp import transcribe, ocp_bounds
    from polympc_tpu.parallel import make_batch_solver
    from polympc_tpu.qp.types import ADMMSettings

    dtype = jnp.float32
    B = args.batch
    ocp = augment_ocp(lambda x, u: kite_dynamics(x, u), kite_output,
                      kite_path, nx=3, nu=1, ny=2)
    tr = transcribe(ocp, SegmentedBasis(Chebyshev(5), 2))
    prm = tr.params(d=[0.05], t0=0.0, tf=2.0, dtype=dtype)
    bounds = ocp_bounds(tr, ul=[-5.0, -10.0], uu=[5.0, 10.0],
                        xl=[0.0, -np.pi / 2, -np.pi, -100.0, -100.0],
                        xu=[np.pi / 2, np.pi / 2, np.pi, 100.0, 100.0],
                        dtype=dtype)
    settings = SQPSettings(
        hessian="exact", max_iter=9, reg="mirror",
        eps_prim=1e-3, eps_dual=1e-3, eps_viol=1e-3, eps_stat=1e-2,
        qp=ADMMSettings(rho=1.0, eps_abs=1e-4, eps_rel=1e-4,
                        max_epochs=3, check_every=50, equil_iters=0,
                        kkt_solver="pallas", structure=tr.bbt_structure(),
                        polish=False))
    solve = make_batch_solver(tr, bounds, prm, settings, rollout_guess=True)
    x0s_np = bench_x0s(512)[:B]
    x0s = jnp.asarray(x0s_np, dtype)

    t0 = time.perf_counter()
    sols = jax.block_until_ready(solve(x0s))
    t_solve = time.perf_counter() - t0

    with jax.enable_x64():
        prm64 = tr.params(d=[0.05], t0=0.0, tf=2.0, dtype=jnp.float64)
        bounds64 = jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float64), bounds)
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

        t0 = time.perf_counter()
        res = np.asarray(jax.block_until_ready(
            certify(x0s, sols.x, sols.lam, sols.lam_box)), np.float64)
        t_cert = time.perf_counter() - t0

    certified = res <= KKT_TOL
    status = np.asarray(sols.status, np.int32)
    iters = np.asarray(sols.iters, np.int32)
    np.savez_compressed(args.out, x0s=x0s_np, residual=res,
                        certified=certified, status=status, iters=iters)
    print(f"B={B} certified={int(certified.sum())} "
          f"status_solved={int((status == 1).sum())} "
          f"mean_iters={iters.mean():.4f} "
          f"max_certified_res={res[certified].max() if certified.any() else None} "
          f"solve_s={t_solve:.1f} certify_s={t_cert:.1f} -> {args.out}")


if __name__ == "__main__":
    main()
