"""Regenerate ``solvers_jax_cpu.npz``: the JAX package's record of the
solver layer's card paths (polympc_torch/solvers_point.py), for the CUDA
port to be held against on a machine that has no JAX.

  * ``kite_*``: bench's kite transcription (Chebyshev(5) x 2 segments,
    n=77, m=55) through ``nlp_ip_solve`` in float64 with default
    ``IPNLPSettings``: B=512 initial conditions from bench's draw
    (``default_rng(0)``, float32 values), each pinned into node 0 of the
    transcription's initial guess and of the bounds; ``jit(vmap)``.  Per
    lane: status, iters, cost, kkt_error.
  * ``ip_*``: the headline spline-fit QP (n=32, m=15) at B=4096, each lane
    a fresh linear term from ``default_rng(1)`` (the harness's batch),
    through ``qp_ip_solve`` in float64 with default ``IPSettings``: status
    and iters of every lane, x of the first 512.
  * ``admm_*``: the same batch in float32 through ``admm_solve`` (the box
    stacked into A: m=47) with the harness's settings (rho 0.1, eps 1e-4,
    10 epochs of 25, 4 Ruiz sweeps) through the "lu" epoch (the Pallas
    route runs in interpret mode on a CPU): status and iters of every lane.
  * ``vjp_*``: the first 512 lanes in float64 through ``box_admm_solve``
    (the same settings, "lu" epoch) and ``jax.vjp``: the cotangents of
    w'x* for w from ``default_rng(7)`` (B=4096 draw, first 512 rows) with
    respect to h, al, au, xl, xu (float32), and the forward's x.

Run from the repository root (about 90 s on an 8-core CPU, most of it the
kite batch):

    python tests/data/make_solvers_reference.py
"""
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
sys.setrecursionlimit(100000)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402

KITE_B = 512
QP_B = 4096
STORED = 512
VJP_SEED = 7


def bench_x0s(B, seed=0):
    """bench.py's initial conditions, float32 (its draw order)."""
    rng = np.random.default_rng(seed)
    s0 = rng.uniform(0.0, 2 * np.pi, B)
    theta0 = np.pi / 6 + 0.2 * np.sin(2 * s0) + rng.normal(0, 0.05, B)
    phi0 = 0.8 * np.cos(s0) + rng.normal(0, 0.05, B)
    gamma0 = rng.uniform(-0.5, 0.5, B)
    return np.stack([np.clip(theta0, 0.05, 1.5), np.clip(phi0, -1.5, 1.5),
                     gamma0, s0, np.full(B, 0.05)], axis=1).astype(np.float32)


def kite_record():
    from polympc_tpu.basis import Chebyshev, SegmentedBasis
    from polympc_tpu.control.nmpf import augment_ocp
    from polympc_tpu.models import kite_dynamics, kite_output, kite_path
    from polympc_tpu.nlp import IPNLPSettings, nlp_ip_solve
    from polympc_tpu.ocp import ocp_bounds, transcribe
    ocp = augment_ocp(lambda x, u: kite_dynamics(x, u), kite_output,
                      kite_path, nx=3, nu=1, ny=2)
    tr = transcribe(ocp, SegmentedBasis(Chebyshev(5), 2))
    prm = tr.params(d=[0.05], t0=0.0, tf=2.0, dtype=jnp.float64)
    bounds = ocp_bounds(tr, ul=[-5.0, -10.0], uu=[5.0, 10.0],
                        xl=[0.0, -np.pi / 2, -np.pi, -100.0, -100.0],
                        xu=[np.pi / 2, np.pi / 2, np.pi, 100.0, 100.0],
                        dtype=jnp.float64)
    x0s = bench_x0s(KITE_B)
    nx = tr.ocp.nx
    x0sc = x0s.astype(np.float64) / np.asarray(tr.x_scale, np.float64)
    z0 = np.tile(np.asarray(tr.initial_guess(dtype=jnp.float64)),
                 (KITE_B, 1))
    z0[:, :nx] = x0sc
    lbx = np.tile(np.asarray(bounds.lbx, np.float64), (KITE_B, 1))
    ubx = np.tile(np.asarray(bounds.ubx, np.float64), (KITE_B, 1))
    lbx[:, :nx] = ubx[:, :nx] = x0sc
    settings = IPNLPSettings()
    solve = jax.jit(jax.vmap(lambda z, lb, ub: nlp_ip_solve(
        tr.nlp, z, p=prm, bounds=bounds._replace(lbx=lb, ubx=ub),
        settings=settings)))
    sols = jax.block_until_ready(solve(jnp.asarray(z0), jnp.asarray(lbx),
                                       jnp.asarray(ubx)))
    return {"kite_x0s": x0s,
            "kite_status": np.asarray(sols.status, np.int8),
            "kite_iters": np.asarray(sols.iters, np.int16),
            "kite_cost": np.asarray(sols.cost, np.float64),
            "kite_kkt_error": np.asarray(sols.kkt_error, np.float64)}


def spline_qps(dtype):
    """The harness's spline-fit QP and its B=4096 linear terms."""
    from polympc_tpu.control.path import spline_fit_qp_data
    s = np.linspace(0.0, 10.0, 81)
    y = np.sin(0.7 * s) + 0.1 * s
    qp, _ = spline_fit_qp_data(s, y, n_segments=8, dtype=jnp.float64)
    rng = np.random.default_rng(1)
    ys = y[None] + 0.05 * rng.standard_normal((QP_B, len(s)))
    hs = np.stack([np.asarray(spline_fit_qp_data(s, yy, 8)[0].h)
                   for yy in ys])
    return (type(qp)(*(jnp.asarray(a, dtype) for a in qp)),
            jnp.asarray(hs, dtype))


def settings(kkt_solver="lu"):
    from polympc_tpu.qp.types import ADMMSettings
    return ADMMSettings(rho=0.1, eps_abs=1e-4, eps_rel=1e-4, max_epochs=10,
                        check_every=25, equil_iters=4, kkt_solver=kkt_solver)


def qp_record():
    from polympc_tpu.qp import admm_solve, box_admm_solve, qp_ip_solve
    qp, hs = spline_qps(jnp.float64)
    with_h = lambda h: qp._replace(h=h)
    ip = jax.block_until_ready(jax.jit(jax.vmap(
        lambda h: qp_ip_solve(with_h(h))))(hs))
    qp32, hs32 = spline_qps(jnp.float32)
    s = settings()
    admm = jax.block_until_ready(jax.jit(jax.vmap(
        lambda h: admm_solve(qp32._replace(h=h), settings=s)))(hs32))
    w = np.random.default_rng(VJP_SEED).standard_normal(
        (QP_B, hs.shape[1]))[:STORED]

    def one(h, al, au, xl, xu, wi):
        q = qp._replace(h=h, al=al, au=au, xl=xl, xu=xu)
        x, vjp = jax.vjp(lambda h_, al_, au_, xl_, xu_: box_admm_solve(
            q._replace(h=h_, al=al_, au=au_, xl=xl_, xu=xu_),
            settings=s).x, h, al, au, xl, xu)
        return x, vjp(wi)
    lanes = lambda a: jnp.broadcast_to(a, (STORED,) + a.shape)
    vx, bars = jax.block_until_ready(jax.jit(jax.vmap(one))(
        hs[:STORED], lanes(qp.al), lanes(qp.au), lanes(qp.xl),
        lanes(qp.xu), jnp.asarray(w)))
    rec = {"ip_status": np.asarray(ip.status, np.int8),
           "ip_iters": np.asarray(ip.iters, np.int8),
           "ip_x": np.asarray(ip.x[:STORED], np.float64),
           "admm_status": np.asarray(admm.status, np.int8),
           "admm_iters": np.asarray(admm.iters, np.int16),
           "admm_kkt_solver": np.asarray("lu"),
           "vjp_x": np.asarray(vx, np.float64)}
    for name, b in zip(("h", "al", "au", "xl", "xu"), bars):
        rec[f"vjp_{name}"] = np.asarray(b, np.float32)
    return rec


def main():
    out = os.path.join(HERE, "solvers_jax_cpu.npz")
    rec = {}
    for name, fn in (("kite", kite_record), ("qp", qp_record)):
        t0 = time.perf_counter()
        rec.update(fn())
        print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)
    np.savez_compressed(out, **rec)
    print(f"kite SOLVED {int((rec['kite_status'] == 1).sum())}/{KITE_B}, "
          f"mean iters {rec['kite_iters'].mean():.3f}; spline QP: ip SOLVED "
          f"{int((rec['ip_status'] == 1).sum())}/{QP_B}, admm SOLVED "
          f"{int((rec['admm_status'] == 1).sum())}; "
          f"{os.path.getsize(out)} bytes -> {out}")


if __name__ == "__main__":
    main()
