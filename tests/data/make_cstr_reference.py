"""Regenerate ``cstr_b256_jax_cpu.npz``: the JAX package's per-lane record of
the certified CSTR batch (BASELINE config 3), for the CUDA port to be held
against on a machine that has no JAX.

The problem is the reference's CSTR setpoint-tracking NMPC
(tests/test_control.py's ``test_cstr_nmpc``): ``cstr_ocp()`` on a
Chebyshev(5) x 2-segment mesh with x_scale (2, 1, 100, 100) and u_scale
(15, 2000), a 100 s horizon, the CSTR control bounds and the state bounds
(0, 0, 50, 50) - (6, 4, 150, 150).  B initial conditions
x0 = CSTR_X0 * (1 + 0.02 U(-1, 1)) are drawn from ``default_rng(4)`` in
float32; each lane starts from the transcription's initial guess.  The
batched float32 SQP runs the exact Hessian with ``max_iter=150`` and
boxADMM QPs (rho 1, eps 1e-5, 40 epochs of 25 iterations, 4 Ruiz sweeps)
through the chosen KKT route, then the three-stage float64 Newton-KKT
certify of ``bench.py`` (fp32 LDL^T solves).

Run from the repository root:

    python tests/data/make_cstr_reference.py [--batch 256] [--route lu]

``--route pallas`` takes the BBT epoch kernel, which runs in interpret mode
on a CPU; ``lu`` (the default) the vmapped LU epoch.  The file holds
``x0s`` (B, 4) float32 and, per lane, the SQP ``status``, ``iters``,
``cost`` and the certified float64 KKT ``residual`` and ``certified`` mask
(residual <= 1e-6), with the ``route`` that made them.
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
X_SCALE = [2.0, 1.0, 100.0, 100.0]
U_SCALE = [15.0, 2000.0]
XL = [0.0, 0.0, 50.0, 50.0]
XU = [6.0, 4.0, 150.0, 150.0]
TF = 100.0


def cstr_x0s(B, seed=4, spread=0.02):
    """B initial conditions CSTR_X0 * (1 + spread * U(-1, 1)), float32."""
    from polympc_tpu.models import CSTR_X0
    rng = np.random.default_rng(seed)
    return (CSTR_X0[None] * (1.0 + spread * rng.uniform(-1.0, 1.0, (B, 4)))
            ).astype(np.float32)


def problem(dtype, route):
    """(tr, bounds, prm, settings) of the CSTR batch in the JAX package."""
    from polympc_tpu.basis import Chebyshev, SegmentedBasis
    from polympc_tpu.models import cstr_ocp, CSTR_ULB, CSTR_UUB
    from polympc_tpu.nlp import SQPSettings
    from polympc_tpu.ocp import transcribe, ocp_bounds
    from polympc_tpu.qp.types import ADMMSettings

    tr = transcribe(cstr_ocp(), SegmentedBasis(Chebyshev(5), 2),
                    x_scale=X_SCALE, u_scale=U_SCALE)
    prm = tr.params(t0=0.0, tf=TF, dtype=dtype)
    bounds = ocp_bounds(tr, ul=CSTR_ULB, uu=CSTR_UUB, xl=XL, xu=XU,
                        dtype=dtype)
    settings = SQPSettings(
        hessian="exact", max_iter=150,
        qp=ADMMSettings(rho=1.0, eps_abs=1e-5, eps_rel=1e-5, max_epochs=40,
                        equil_iters=4, kkt_solver=route,
                        structure=(tr.bbt_structure() if route == "pallas"
                                   else None)))
    return tr, bounds, prm, settings


def certify_fn(tr, bounds, B):
    """bench.py's three-stage float64 certify (jitted, vmapped)."""
    from polympc_tpu.nlp.refine import refine_solution
    prm64 = tr.params(t0=0.0, tf=TF, dtype=jnp.float64)
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--route", choices=("lu", "pallas"), default="lu")
    ap.add_argument("--out", default=os.path.join(HERE,
                                                  "cstr_b256_jax_cpu.npz"))
    args = ap.parse_args()

    from polympc_tpu.parallel import make_batch_solver

    B = args.batch
    tr, bounds, prm, settings = problem(jnp.float32, args.route)
    solve = make_batch_solver(tr, bounds, prm, settings)
    x0s_np = cstr_x0s(B)
    x0s = jnp.asarray(x0s_np, jnp.float32)

    t0 = time.perf_counter()
    sols = jax.block_until_ready(solve(x0s))
    t_solve = time.perf_counter() - t0

    with jax.enable_x64():
        certify = certify_fn(tr, bounds, B)
        t0 = time.perf_counter()
        res = np.asarray(jax.block_until_ready(
            certify(x0s, sols.x, sols.lam, sols.lam_box)), np.float64)
        t_cert = time.perf_counter() - t0

    certified = res <= KKT_TOL
    status = np.asarray(sols.status, np.int32)
    iters = np.asarray(sols.iters, np.int32)
    cost = np.asarray(sols.cost, np.float64)
    np.savez_compressed(args.out, x0s=x0s_np, residual=res,
                        certified=certified, status=status, iters=iters,
                        cost=cost, route=np.array(args.route))
    print(f"B={B} route={args.route} certified={int(certified.sum())} "
          f"status_solved={int((status == 1).sum())} "
          f"mean_iters={iters.mean():.4f} "
          f"solve_s={t_solve:.1f} certify_s={t_cert:.1f} -> {args.out}")


if __name__ == "__main__":
    main()
