"""Regenerate ``ocp_extras_jax_cpu.npz``: the JAX package's record of the
OCP-extras card paths (polympc_torch/ocp_extras_point.py), for the CUDA
port to be held against on a machine that has no JAX.

  * ``kite_*``: bench's augmented kite (nx=5, nu=2, d=[0.05], [0, 2])
    transcribed by multiple shooting, ``transcribe_ms(ocp, 10, 4)``
    (n=75, ne=50, ni=0), bench's bounds through ``ms_bounds``, B=512 initial
    conditions from bench's draw (``default_rng(0)``, float32), each lane
    starting from ``initial_guess(x0)`` with node 0 pinned; the float32
    SQP with bench's settings (exact Hessian, ``reg="mirror"``, l1 merit,
    ``max_iter`` below, 3 x 50 boxADMM iterations) through the "lu" epoch
    (the Pallas route runs in interpret mode on a CPU), ``jit(vmap)``; then
    bench's three-stage float64 Newton-KKT certify with float32 LDL^T
    solves.  Per lane: status, iters, x, cost, the certified residual and
    the certified mask (residual <= 1e-6).
  * ``ms_robot_*``, ``soft_robot_*``, ``stiff_*``, ``rate_*``,
    ``ident_*``, ``adaptive_*``, ``ps_*``: the float64 oracles of the
    ``ocp_extras`` path, one call each, the JAX tests' cases
    (tests/test_ms.py, test_schemes.py, test_trajectory_hooks.py,
    test_identification.py, test_integrators.py).

Run from the repository root (about 3 min on an 8-core CPU):

    python tests/data/make_ocp_extras_reference.py [--max-iter 9]
"""
import argparse
import dataclasses
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

KKT_TOL = 1e-6
KITE_B = 512
KITE_XL = [0.0, -np.pi / 2, -np.pi, -100.0, -100.0]
KITE_XU = [np.pi / 2, np.pi / 2, np.pi, 100.0, 100.0]
ROBOT_X0 = [0.5, 0.5, 0.5]


def bench_x0s(B, seed=0):
    """bench.py's initial conditions, float32 (its draw order)."""
    rng = np.random.default_rng(seed)
    s0 = rng.uniform(0.0, 2 * np.pi, B)
    theta0 = np.pi / 6 + 0.2 * np.sin(2 * s0) + rng.normal(0, 0.05, B)
    phi0 = 0.8 * np.cos(s0) + rng.normal(0, 0.05, B)
    gamma0 = rng.uniform(-0.5, 0.5, B)
    return np.stack([np.clip(theta0, 0.05, 1.5), np.clip(phi0, -1.5, 1.5),
                     gamma0, s0, np.full(B, 0.05)], axis=1).astype(np.float32)


def kite_ms(dtype, max_iter, kkt_solver="lu"):
    """The kite by multiple shooting in the JAX package:
    (tr, bounds, prm, settings)."""
    from polympc_tpu.control.nmpf import augment_ocp
    from polympc_tpu.models import kite_dynamics, kite_output, kite_path
    from polympc_tpu.nlp import SQPSettings
    from polympc_tpu.ocp import ms_bounds, transcribe_ms
    from polympc_tpu.qp.types import ADMMSettings
    ocp = augment_ocp(lambda x, u: kite_dynamics(x, u), kite_output,
                      kite_path, nx=3, nu=1, ny=2)
    tr = transcribe_ms(ocp, num_segments=10, steps_per_segment=4)
    prm = tr.params(d=[0.05], t0=0.0, tf=2.0, dtype=dtype)
    bounds = ms_bounds(tr, ul=[-5.0, -10.0], uu=[5.0, 10.0], xl=KITE_XL,
                       xu=KITE_XU, dtype=dtype)
    settings = SQPSettings(
        hessian="exact", max_iter=max_iter, reg="mirror",
        eps_prim=1e-3, eps_dual=1e-3, eps_viol=1e-3, eps_stat=1e-2,
        qp=ADMMSettings(rho=1.0, eps_abs=1e-4, eps_rel=1e-4,
                        max_epochs=3, check_every=50, equil_iters=0,
                        kkt_solver=kkt_solver, polish=False))
    return tr, bounds, prm, settings


def kite_solve_fn(tr, bounds, prm, settings):
    """jit(vmap) of one lane's solve from initial_guess(x0), node 0 pinned."""
    from polympc_tpu.nlp.sqp import sqp_solve
    nx = tr.ocp.nx

    def one(x0):
        b = bounds._replace(lbx=bounds.lbx.at[:nx].set(x0),
                            ubx=bounds.ubx.at[:nx].set(x0))
        z0 = tr.initial_guess(x0, dtype=x0.dtype)
        return sqp_solve(tr.nlp, z0, p=prm, bounds=b, settings=settings)
    return jax.jit(jax.vmap(one))


def certify_fn(tr, bounds, B):
    """bench.py's three-stage float64 certify on the MS NLP (jitted,
    vmapped)."""
    from polympc_tpu.nlp.refine import refine_solution
    prm64 = tr.params(d=[0.05], t0=0.0, tf=2.0, dtype=jnp.float64)
    b64 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float64), bounds)
    nx = tr.ocp.nx

    def one(x0, z, lam, lam_box, **kw):
        x0_ = jnp.asarray(x0, jnp.float64)
        b = b64._replace(lbx=b64.lbx.at[:nx].set(x0_),
                         ubx=b64.ubx.at[:nx].set(x0_))
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


def kite_record(B, max_iter):
    x0s_np = bench_x0s(KITE_B)[:B]
    with jax.enable_x64(False):
        tr, bounds, prm, settings = kite_ms(jnp.float32, max_iter)
        x0s = jnp.asarray(x0s_np, jnp.float32)
        t0 = time.perf_counter()
        sols = jax.block_until_ready(
            kite_solve_fn(tr, bounds, prm, settings)(x0s))
        t_solve = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = np.asarray(jax.block_until_ready(certify_fn(tr, bounds, B)(
        x0s, sols.x, sols.lam, sols.lam_box)), np.float64)
    t_cert = time.perf_counter() - t0
    status = np.asarray(sols.status, np.int8)
    print(f"kite MS B={B} max_iter={max_iter}: SOLVED "
          f"{int((status == 1).sum())}, certified {int((res <= KKT_TOL).sum())}"
          f", mean iters {np.asarray(sols.iters).mean():.4f}; solve "
          f"{t_solve:.1f} s, certify {t_cert:.1f} s", flush=True)
    return {"kite_x0s": x0s_np, "kite_max_iter": np.asarray(max_iter),
            "kite_kkt_solver": np.asarray("lu"),
            "kite_status": status,
            "kite_iters": np.asarray(sols.iters, np.int16),
            "kite_x": np.asarray(sols.x, np.float32),
            "kite_cost": np.asarray(sols.cost, np.float64),
            "kite_residual": res, "kite_certified": res <= KKT_TOL}


# ---- the ocp_extras oracles (float64) ----

def robot_settings(**kw):
    from polympc_tpu.nlp import SQPSettings
    from polympc_tpu.qp.types import ADMMSettings
    qp = ADMMSettings(eps_abs=1e-6, eps_rel=1e-6, max_epochs=40)
    return SQPSettings(**{"hessian": "exact", "max_iter": 100, "qp": qp,
                          **kw})


def ms_robot():
    """tests/test_ms.py: the robot by multiple shooting (NS=10, 4 RK4 steps
    a segment) and by collocation (Chebyshev(5) x 2)."""
    from polympc_tpu.basis import Chebyshev, SegmentedBasis
    from polympc_tpu.models import robot_ocp
    from polympc_tpu.nlp import sqp_solve
    from polympc_tpu.ocp import (
        ms_bounds, ocp_bounds, transcribe, transcribe_ms)
    tr = transcribe_ms(robot_ocp(), num_segments=10, steps_per_segment=4)
    prm = tr.params(d=[2.0], t0=0.0, tf=2.0)
    b = ms_bounds(tr, ul=[-1.5, -0.75], uu=[1.5, 0.75], x0=ROBOT_X0)
    sol = sqp_solve(tr.nlp, tr.initial_guess(ROBOT_X0), p=prm, bounds=b,
                    settings=robot_settings())
    tc = transcribe(robot_ocp(), SegmentedBasis(Chebyshev(5), 2))
    pc = tc.params(d=[2.0], t0=0.0, tf=2.0)
    bc = ocp_bounds(tc, ul=[-1.5, -0.75], uu=[1.5, 0.75], x0=ROBOT_X0)
    col = sqp_solve(tc.nlp, tc.initial_guess(ROBOT_X0), p=pc, bounds=bc,
                    settings=robot_settings())
    soft = transcribe(robot_ocp(), SegmentedBasis(Chebyshev(5), 2),
                      soft_defects=1e4)
    ssol = sqp_solve(soft.nlp, soft.initial_guess(ROBOT_X0), p=pc,
                     bounds=ocp_bounds(soft, ul=[-1.5, -0.75],
                                       uu=[1.5, 0.75], x0=ROBOT_X0),
                     settings=robot_settings(max_iter=150, eps_prim=5e-3,
                                             eps_stat=0.5))
    return {"ms_robot_status": np.asarray(int(sol.status)),
            "ms_robot_iters": np.asarray(int(sol.iters)),
            "ms_robot_cost": np.asarray(float(sol.cost)),
            "ms_robot_x": np.asarray(sol.x, np.float64),
            "ms_robot_collocation_cost": np.asarray(float(col.cost)),
            "soft_robot_status": np.asarray(int(ssol.status)),
            "soft_robot_iters": np.asarray(int(ssol.iters)),
            "soft_robot_cost": np.asarray(float(ssol.cost)),
            "soft_robot_x": np.asarray(ssol.x, np.float64)}


def stiff_solve(basis, NS):
    """tests/test_schemes.py's stiff actuator tracking OCP on a mesh."""
    from polympc_tpu.basis import SegmentedBasis
    from polympc_tpu.nlp import SQPSettings, sqp_solve
    from polympc_tpu.ocp import OCP, ocp_bounds, transcribe
    from polympc_tpu.qp.types import ADMMSettings
    lam = -50.0
    ocp = OCP(dynamics=lambda x, u, p, d, t: jnp.array([lam * (x[0] - u[0])]),
              nx=1, nu=1,
              lagrange=lambda x, u, p, d, t: (x[0] - 1.0) ** 2
              + 0.1 * u[0] ** 2)
    tr = transcribe(ocp, SegmentedBasis(basis, NS))
    s = SQPSettings(hessian="exact", max_iter=60,
                    qp=ADMMSettings(eps_abs=1e-9, eps_rel=1e-9,
                                    max_epochs=80))
    sol = sqp_solve(tr.nlp, tr.initial_guess([0.0]),
                    p=tr.params(t0=0.0, tf=1.0),
                    bounds=ocp_bounds(tr, x0=[0.0]), settings=s)
    return tr, sol


def stiff():
    """The stiff OCP where Radau(3) x 4 beats Lobatto(3) x 4 against the
    Legendre(8) x 16 oracle: trajectory and cost errors of each."""
    from polympc_tpu.basis import Legendre, LegendreRadau
    tro, solo = stiff_solve(Legendre(8), 16)
    tq = np.linspace(0.0, 1.0, 101)
    Xo = tro.mesh.interp_matrix(tq, 0.0, 1.0) @ np.asarray(solo.x[:tro.N])
    out = {"stiff_oracle_status": np.asarray(int(solo.status)),
           "stiff_oracle_cost": np.asarray(float(solo.cost))}
    for name, basis in (("lobatto", Legendre(3)),
                        ("radau", LegendreRadau(3))):
        tr, sol = stiff_solve(basis, 4)
        X = tr.mesh.interp_matrix(tq, 0.0, 1.0) @ np.asarray(sol.x[:tr.N])
        out.update({f"stiff_{name}_status": np.asarray(int(sol.status)),
                    f"stiff_{name}_iters": np.asarray(int(sol.iters)),
                    f"stiff_{name}_cost": np.asarray(float(sol.cost)),
                    f"stiff_{name}_traj_err": np.asarray(
                        np.abs(X - Xo).max())})
    return out


def rate():
    """tests/test_trajectory_hooks.py: the robot with the rate bound
    |du/dt| <= 1.2 through a trajectory hook, and without it."""
    from polympc_tpu.basis import Chebyshev, SegmentedBasis
    from polympc_tpu.models import robot_ocp
    from polympc_tpu.nlp import SQPSettings, sqp_solve
    from polympc_tpu.ocp import ocp_bounds, transcribe
    from polympc_tpu.qp.types import ADMMSettings
    base = robot_ocp()
    rmax, N = 1.2, 11
    hooked = dataclasses.replace(
        base, trajectory_ineq=lambda X, U, P, d, t, ops: (
            ops.D @ U).reshape(-1), ntg=N * base.nu)
    qp = ADMMSettings(rho=1.0, eps_abs=1e-6, eps_rel=1e-6, max_epochs=40,
                      equil_iters=2)
    out = {}
    for name, ocp, tg in (("rate", hooked, rmax * np.ones(N * base.nu)),
                          ("rate_free", base, None)):
        tr = transcribe(ocp, SegmentedBasis(Chebyshev(5), 2))
        prm = tr.params(d=[2.0], t0=0.0, tf=2.0)
        b = ocp_bounds(tr, ul=[-1.5, -0.75], uu=[1.5, 0.75], x0=ROBOT_X0,
                       tgl=None if tg is None else -tg, tgu=tg)
        sol = sqp_solve(tr.nlp, tr.initial_guess(ROBOT_X0), p=prm, bounds=b,
                        settings=SQPSettings(hessian="exact", max_iter=60,
                                             qp=qp))
        _, U, _ = tr.unpack(sol.x)
        D = np.asarray(tr.Dg_unit) / (2.0 / (2.0 * tr.mesh.num_segments))
        out.update({f"{name}_status": np.asarray(int(sol.status)),
                    f"{name}_iters": np.asarray(int(sol.iters)),
                    f"{name}_cost": np.asarray(float(sol.cost)),
                    f"{name}_x": np.asarray(sol.x, np.float64),
                    f"{name}_max_rate": np.asarray(
                        np.abs(D @ np.asarray(U)).max())})
    return out


def pendulum_data():
    """tests/test_identification.py's noise-free pendulum record: the RK4
    trajectory (301 samples on [0, 3]) of p = (4, 0.3) from (1, 0)."""
    from polympc_tpu.ocp import rk4_integrate
    p = jnp.array([4.0, 0.3])
    f = lambda x, u, t: jnp.array([x[1], -p[0] * jnp.sin(x[0]) - p[1] * x[1]])
    return np.asarray(rk4_integrate(f, jnp.array([1.0, 0.0]), 0.0, 3.0, 300))


def ident():
    """identify on the noise-free pendulum (Chebyshev(5) x 6, p0 = (1, 1),
    bounds (0.1, 0) - (20, 5))."""
    from polympc_tpu.basis import Chebyshev, SegmentedBasis
    from polympc_tpu.basis.splines import fit_cubic_spline
    from polympc_tpu.ocp.identification import identify
    xs = pendulum_data()
    h = 3.0 / (xs.shape[0] - 1)
    sp0 = fit_cubic_spline(0.0, h, xs[:, 0])
    sp1 = fit_cubic_spline(0.0, h, xs[:, 1])
    xdata = lambda t: jnp.stack([sp0(t), sp1(t)])

    def pend(x, u, p, d, t):
        return jnp.array([x[1], -p[0] * jnp.sin(x[0]) - p[1] * x[1]])
    res = identify(pend, SegmentedBasis(Chebyshev(5), 6), xdata, None, 0.0,
                   3.0, n_params=2, nx=2, p0=[1.0, 1.0], pl=[0.1, 0.0],
                   pu=[20.0, 5.0])
    return {"ident_p": np.asarray(res.p, np.float64),
            "ident_p_init": np.asarray(res.p_init, np.float64),
            "ident_status": np.asarray(int(res.status)),
            "ident_iters": np.asarray(int(res.iters)),
            "ident_cost": np.asarray(float(res.cost))}


def integrators():
    """adaptive_integrate on x' = -x over [0, 2] (rtol 1e-8, atol 1e-12),
    on the harmonic oscillator's save grid, and exhausting max_steps=5;
    ps_integrate on the logistic equation (Chebyshev(10) x 3, [0, 4])."""
    from polympc_tpu.basis import Chebyshev, SegmentedBasis
    from polympc_tpu.ocp import adaptive_integrate, ps_integrate
    x, (na, nr, ok) = adaptive_integrate(
        lambda x, u, t: -x, jnp.array([1.0]), 0.0, 2.0, rtol=1e-8,
        atol=1e-12)
    ts = np.linspace(0.5, 6.0, 7)
    xs, (na2, nr2, ok2) = adaptive_integrate(
        lambda x, u, t: jnp.array([x[1], -x[0]]), jnp.array([1.0, 0.0]),
        0.0, 6.0, rtol=1e-8, atol=1e-10, ts=ts)
    _, (na3, nr3, ok3) = adaptive_integrate(
        lambda x, u, t: -x, jnp.array([1.0]), 0.0, 1e6, rtol=1e-10,
        atol=1e-14, max_steps=5)
    X, t = ps_integrate(lambda x, u, t: x * (1 - x), jnp.array([0.1]), 0.0,
                        4.0, SegmentedBasis(Chebyshev(10), 3))
    return {"adaptive_exp_x": np.asarray(x, np.float64),
            "adaptive_exp_stats": np.asarray([int(na), int(nr), int(ok)]),
            "adaptive_osc_xs": np.asarray(xs, np.float64),
            "adaptive_osc_stats": np.asarray([int(na2), int(nr2), int(ok2)]),
            "adaptive_fail_stats": np.asarray([int(na3), int(nr3),
                                               int(ok3)]),
            "ps_X": np.asarray(X, np.float64),
            "ps_t": np.asarray(t, np.float64)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=KITE_B)
    ap.add_argument("--max-iter", type=int, default=9)
    ap.add_argument("--only-kite", action="store_true",
                    help="run the kite batch alone and write nothing")
    ap.add_argument("--out", default=os.path.join(HERE,
                                                  "ocp_extras_jax_cpu.npz"))
    args = ap.parse_args()
    rec = {}
    parts = [("kite", lambda: kite_record(args.batch, args.max_iter))]
    if not args.only_kite:
        parts += [("ms_robot", ms_robot), ("stiff", stiff), ("rate", rate),
                  ("ident", ident), ("integrators", integrators)]
    for name, fn in parts:
        t0 = time.perf_counter()
        rec.update(fn())
        print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)
    if args.only_kite:
        return
    np.savez_compressed(args.out, **rec)
    print(f"{os.path.getsize(args.out)} bytes -> {args.out}")


if __name__ == "__main__":
    main()
