"""Regenerate ``headline_jax_cpu.npz``: the JAX package's per-lane record of
the three workloads of ``benchmarks/headline.py``, for the CUDA port to be
held against on a machine that has no JAX.

Each workload is the harness's, step for step, with its seeds, widths and
float32 solves: the spline-fitting QP batch (B=4096, ``default_rng(1)``),
the frame-transform batch (B=4096, ``default_rng(2)``) and the warm-started
race-car batch (B=512, ``default_rng(3)``) with the two-stage fp64 certify.
On a CPU the Pallas kernels run in interpret mode; ``--spline-kkt-solver
lu`` runs the spline QP's epochs through the LU epoch instead (the file
records which one ran).

Run from the repository root:

    python tests/data/make_headline_reference.py
"""
import argparse
import os
import sys
import time
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
sys.setrecursionlimit(100000)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402

# the harness builds its QP "in float64" with x64 off: JAX truncates to
# float32, as the harness's own run does
warnings.filterwarnings("ignore", message="Explicitly requested dtype")

KKT_TOL = 1e-6


def spline_record(batch, kkt_solver):
    from polympc_tpu.control.path import spline_fit_qp_data
    from polympc_tpu.qp.box_admm import box_admm_solve
    from polympc_tpu.qp.types import ADMMSettings, QPData
    s = np.linspace(0.0, 10.0, 81)
    y = np.sin(0.7 * s) + 0.1 * s
    qp64, _ = spline_fit_qp_data(s, y, n_segments=8, dtype=jnp.float64)
    qp = QPData(*(jnp.asarray(a, jnp.float32) for a in qp64))
    settings = ADMMSettings(rho=0.1, eps_abs=1e-4, eps_rel=1e-4,
                            max_epochs=10, check_every=25, equil_iters=4,
                            kkt_solver=kkt_solver)
    one = jax.jit(lambda q: box_admm_solve(q, settings=settings))(qp)
    rng = np.random.default_rng(1)
    ys = y[None] + 0.05 * rng.standard_normal((batch, len(s)))
    hs = jnp.asarray(np.stack(
        [np.asarray(spline_fit_qp_data(s, yy, 8)[0].h) for yy in ys]),
        jnp.float32)
    batched = jax.jit(jax.vmap(
        lambda h, qp: box_admm_solve(QPData(qp.H, h, qp.A, qp.al, qp.au,
                                            qp.xl, qp.xu),
                                     settings=settings),
        in_axes=(0, None)))
    sols = jax.block_until_ready(batched(hs, qp))
    return {"spline_one_status": np.int32(one.status),
            "spline_one_iters": np.int32(one.iters),
            "spline_status": np.asarray(sols.status, np.int8),
            "spline_iters": np.asarray(sols.iters, np.int16),
            "spline_kkt_solver": np.asarray(kkt_solver)}


def frame_record(batch):
    from polympc_tpu.basis.splines import cubic_spline_eval_np as ev
    from polympc_tpu.control.path import (
        project_on_path_newton, track_from_curvature)
    from polympc_tpu.models import make_wave_track
    dtype = jnp.float32
    path = track_from_curvature(
        make_wave_track(length=200.0, amplitude=0.02, waves=3), s_max=200.0)
    s_true = 120.0
    pt = jnp.asarray([float(ev(path.Xc, s_true)), float(ev(path.Yc, s_true))],
                     dtype)
    s_one = jax.jit(lambda s0, p, path: project_on_path_newton(
        path, p, s0=s0, dtype=dtype))(jnp.asarray(s_true - 0.8, dtype), pt,
                                      path)
    rng = np.random.default_rng(2)
    s_b = rng.uniform(5.0, 195.0, batch)
    pts = jnp.asarray(np.stack([ev(path.Xc, s_b), ev(path.Yc, s_b)], axis=1),
                      dtype)
    s0s = jnp.asarray(s_b + rng.uniform(-1.0, 1.0, batch), dtype)
    sols = jax.jit(jax.vmap(
        lambda s0, p, path: project_on_path_newton(path, p, s0=s0,
                                                   dtype=dtype),
        in_axes=(0, 0, None)))(s0s, pts, path)
    return {"frame_one_s": np.float32(s_one),
            "frame_s": np.asarray(sols, np.float32),
            "frame_s_true": s_b}


def race_car_record(batch):
    from polympc_tpu.basis import Chebyshev, SegmentedBasis
    from polympc_tpu.models import make_wave_track, race_car_ocp
    from polympc_tpu.nlp.refine import refine_solution
    from polympc_tpu.nlp.sqp import sqp_solve
    from polympc_tpu.nlp.types import SQPSettings
    from polympc_tpu.ocp import transcribe, ocp_bounds
    from polympc_tpu.qp.types import ADMMSettings
    dtype = jnp.float32
    ocp = race_car_ocp(make_wave_track(length=200.0, amplitude=0.02,
                                       waves=3))
    tr = transcribe(ocp, SegmentedBasis(Chebyshev(5), 2),
                    x_scale=[10.0, 1.0, 1.0, 30.0, 1.0, 1.0],
                    u_scale=[0.4, 1e4, 1e4])
    prm = tr.params(d=[15.0], t0=0.0, tf=2.0, dtype=dtype)
    bounds = ocp_bounds(
        tr, ul=[-0.4, -2e4, -2e4], uu=[0.4, 2e4, 2e4],
        xl=[1.0, -5.0, -3.0, -1e3, -2.0, -1.0],
        xu=[40.0, 5.0, 3.0, 1e3, 2.0, 1.0], dtype=dtype)
    QP = ADMMSettings(rho=1.0, eps_abs=1e-5, eps_rel=1e-5,
                      max_epochs=10, check_every=50, equil_iters=0,
                      kkt_solver="pallas", structure=tr.bbt_structure(),
                      polish=False)
    kw = dict(hessian="exact", reg="mirror", eps_prim=1e-3, eps_dual=1e-3,
              eps_viol=1e-3, eps_stat=1e-2, qp=QP)
    settings = SQPSettings(max_iter=120, **kw)
    settings_warm = SQPSettings(max_iter=16, **kw)
    nx = ocp.nx
    sx = np.asarray(tr.x_scale)

    def pin_x0(b, x0):
        x0s = x0 / sx
        return b._replace(lbx=b.lbx.at[:nx].set(x0s),
                          ubx=b.ubx.at[:nx].set(x0s))

    def solve_with(st):
        @jax.jit
        def solve(x0, z0, lam0, lam_box0, bounds, prm):
            return sqp_solve(tr.nlp, z0, p=prm, bounds=pin_x0(bounds, x0),
                             lam0=lam0, lam_box0=lam_box0, settings=st)
        return solve

    solve_cold, solve = solve_with(settings), solve_with(settings_warm)
    x0 = jnp.asarray([10.0, 0.0, 0.0, 0.0, 0.4, 0.05], dtype)
    z_cold = tr.initial_guess(np.asarray(x0), dtype=dtype)
    sol = solve_cold(x0, z_cold, jnp.zeros(tr.nlp.m, dtype),
                     jnp.zeros(tr.nlp.n, dtype), bounds, prm)
    x1 = x0 + jnp.asarray([0.2, 0.01, 0.0, 0.5, -0.02, 0.0], dtype)
    sol1 = solve(x1, sol.x, sol.lam, sol.lam_box, bounds, prm)

    rng = np.random.default_rng(3)
    dx = rng.standard_normal((batch, 6)) * \
        np.array([0.3, 0.02, 0.02, 0.5, 0.05, 0.02])
    x0s = jnp.asarray(np.asarray(x0)[None] + dx, dtype)
    zs = jnp.broadcast_to(sol.x, (batch,) + sol.x.shape)
    lams = jnp.broadcast_to(sol.lam, (batch,) + sol.lam.shape)
    lbs = jnp.broadcast_to(sol.lam_box, (batch,) + sol.lam_box.shape)
    batched = jax.jit(jax.vmap(solve, in_axes=(0, 0, 0, 0, None, None)))
    t0 = time.perf_counter()
    sols = jax.block_until_ready(batched(x0s, zs, lams, lbs, bounds, prm))
    t_solve = time.perf_counter() - t0

    with jax.enable_x64():
        prm64 = tr.params(d=[15.0], t0=0.0, tf=2.0, dtype=jnp.float64)
        bounds64 = jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float64), bounds)
        sx64 = np.asarray(tr.x_scale, np.float64)

        def one(x0, z, lam, lam_box, **kw):
            x0s_ = jnp.asarray(x0, jnp.float64) / sx64
            b = bounds64._replace(lbx=bounds64.lbx.at[:nx].set(x0s_),
                                  ubx=bounds64.ubx.at[:nx].set(x0s_))
            return refine_solution(tr.nlp, z, lam, lam_box, b, prm64,
                                   solve_dtype=jnp.float32,
                                   matrix_dtype=jnp.float32,
                                   return_residual=True, **kw)[3]

        @jax.jit
        def certify(x0s, sx_, sl, sb):
            r1 = jax.vmap(lambda a, b, c, d: one(a, b, c, d, iters=6))(
                x0s, sx_, sl, sb)
            _, idx = jax.lax.top_k(r1, min(64, x0s.shape[0]))
            r2 = jax.vmap(lambda a, b, c, d: one(
                a, b, c, d, iters=10, act_tol=1e-4, solve_ir=6))(
                x0s[idx], sx_[idx], sl[idx], sb[idx])
            return r1.at[idx].set(jnp.minimum(r1[idx], r2))

        t0 = time.perf_counter()
        kkt = np.asarray(jax.block_until_ready(
            certify(x0s, sols.x, sols.lam, sols.lam_box)), np.float64)
        t_cert = time.perf_counter() - t0
    status = np.asarray(sols.status, np.int8)
    print(f"race car: solve {t_solve:.1f} s, certify {t_cert:.1f} s",
          flush=True)
    return {"race_x0s": np.asarray(x0s, np.float32),
            "race_cold_status": np.int32(sol.status),
            "race_cold_iters": np.int32(sol.iters),
            "race_warm_status": np.int32(sol1.status),
            "race_warm_iters": np.int32(sol1.iters),
            "race_residual": kkt,
            "race_certified": (status == 1) & (kkt <= KKT_TOL),
            "race_status": status,
            "race_iters": np.asarray(sols.iters, np.int8)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--spline-batch", type=int, default=4096)
    ap.add_argument("--frame-batch", type=int, default=4096)
    ap.add_argument("--race-batch", type=int, default=512)
    ap.add_argument("--spline-kkt-solver", default="pallas",
                    choices=["pallas", "lu"])
    ap.add_argument("--out", default=os.path.join(HERE,
                                                  "headline_jax_cpu.npz"))
    args = ap.parse_args()
    rec = {}
    for name, fn in (
            ("frame", lambda: frame_record(args.frame_batch)),
            ("spline", lambda: spline_record(args.spline_batch,
                                             args.spline_kkt_solver)),
            ("race car", lambda: race_car_record(args.race_batch))):
        t0 = time.perf_counter()
        rec.update(fn())
        print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)
    np.savez_compressed(args.out, **rec)
    err = np.abs(rec["frame_s"] - rec["frame_s_true"])
    print(f"spline solved {int((rec['spline_status'] == 1).sum())}/"
          f"{args.spline_batch} ({args.spline_kkt_solver}); frame within "
          f"1e-3 {int((err < 1e-3).sum())}/{args.frame_batch}, max error "
          f"{err.max():.3e}; race car status solved "
          f"{int((rec['race_status'] == 1).sum())}, certified "
          f"{int(rec['race_certified'].sum())}/{args.race_batch}, warm "
          f"iters {int(rec['race_warm_iters'])} -> {args.out} "
          f"({os.path.getsize(args.out)} bytes)")


if __name__ == "__main__":
    main()
