#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (polympc_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own line and raising on failure:

  1. device: a CUDA card is required (there is no CPU path); prints the
     card's name and power limit as nvidia-smi reports them;
  2. build: compiles the hand-written kernels (polympc_torch/csrc) for
     sm_90a from this checkout and prints the build seconds;
  3. kernel parity at the main path's shapes, float32: every kernel against
     its plain PyTorch version on the same inputs on the card, with the
     time of each (median of 10, CUDA events);
  4. main path: bench.py's certified kite batch (B=512) on the port, one
     warm-up then the median wall of 5 repetitions, held against the
     committed record of the JAX package (tests/data/kite_b512_jax_cpu.npz),
     with the launch count of every kernel the path runs;
  5. a JSON line of the kernels, then the result line
     {"ok": true, "device": {...}}.

Needs one card; imports nothing of JAX.
"""
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
REFERENCE = os.path.join(ROOT, "tests", "data", "kite_b512_jax_cpu.npz")

# Tolerances of the kernel-vs-plain phase.
# The epoch runs 50 over-relaxed ADMM iterations in float32; the kernel and
# the plain version sum in different orders, and ADMM is contractive, so the
# two states stay within a few float32 roundings of each other relative to
# the state's size: relative inf-norm 1e-4 per lane leaves a wide margin.
EPOCH_RTOL = 1e-4
# A BBT solve of a quasi-definite KKT is backward stable without pivoting:
# the two solutions agree to relative inf-norm 1e-4 per lane.
SOLVE_RTOL = 1e-4
# Those two tolerances hold on well-conditioned KKTs (random, diagonally
# dominant, in the structure's pattern).  The kite KKT at bench's first
# iterate has a condition number near 1e6 (equality rows carry -1/rho with
# rho = 1e3), so float32 rounding alone moves the plain version's epoch
# state by up to ~2e-2 relative to the same computation in float64 after
# 50 iterations.  There the kernel and the plain float32 version are both
# held against the plain version in float64: the kernel's per-lane error
# may be at most 10x the plain float32 version's (or below 1e-4).
F64_RATIO = 10.0
F64_FLOOR = 1e-4
# The LDL^T kernels are held to the plain version element by element
# (relative inf-norm 1e-4 per lane) on well-conditioned matrices of the
# main path's size.  The refine Newton-KKT matrices are indefinite, so the
# unpivoted factor can grow large elements and amplify summation-order
# differences element by element.  On them compare what the certify pass
# uses instead, the relative residual ||M x - b|| / ||b|| (in float64): the
# kernel's may exceed the plain version's by at most 10x, or be below 1e-5.
# A lane whose plain float32 residual is above 1e-3 is dominated by the
# factor's growth, not by the kernel (both answers are then mostly
# rounding): such lanes are counted and left out of the ratio test.  The
# certify pass repairs them with refinement sweeps in float64 residuals.
LDLT_RTOL = 1e-4
LDLT_RES_RATIO = 10.0
LDLT_RES_FLOOR = 1e-5
LDLT_GROWTH = 1e-3
# The main path may certify at most 10 lanes (2% of B) fewer than the JAX
# record: float32 SQP iterates are chaotic across summation orders.
CERTIFY_SLACK = 10


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "the port's smoke run needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    name = torch.cuda.get_device_name(0)
    say("device", f"{name}; torch {torch.__version__}, CUDA "
                  f"{torch.version.cuda}; {torch.cuda.device_count()} card(s)")
    return name, line


def import_port():
    sys.path.insert(0, ROOT)
    import polympc_torch
    here = os.path.dirname(os.path.abspath(polympc_torch.__file__))
    if here != os.path.join(ROOT, "polympc_torch"):
        raise RuntimeError(f"polympc_torch imported from {here}, not from "
                           f"this checkout ({ROOT})")
    return polympc_torch


def phase_build():
    from polympc_torch.ops import _build
    path, secs, log = _build.build(verbose=True)
    _build.library()
    stats = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    for ln in stats:
        say("build", ln)
    say("build", f"{os.path.relpath(path, ROOT)} built in {secs:.1f} s")


def cuda_ms(fn, reps=10):
    """Median time of fn() on the card over reps runs, after one warm-up."""
    import torch
    if not torch.cuda.is_available():
        return float("nan")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def sync():
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def lane_rel(diff, ref):
    """Per-lane relative inf-norm of diff against ref (B, ...)."""
    d = diff.reshape(diff.shape[0], -1).abs().amax(1)
    r = ref.reshape(ref.shape[0], -1).abs().amax(1).clamp(min=1e-30)
    return d / r


def rel_residual(M, x, b):
    """Per-lane ||M x - b||_inf / ||b||_inf in float64."""
    import torch
    M64, x64, b64 = M.double(), x.double(), b.double()
    r = (M64 @ x64[..., None])[..., 0] - b64
    return r.abs().amax(1) / b64.abs().amax(1).clamp(min=1e-300)


def check_against_f64(name, kernel, plain, args, rest):
    """Kernel vs plain on an ill-conditioned main-path input: both float32
    results are held against the plain version run in float64, and the
    kernel's per-lane relative error may be at most F64_RATIO times the
    float32 plain version's (or below F64_FLOOR)."""
    import torch
    k32 = kernel(*args, *rest)
    p32 = plain(*args, *rest)
    p64 = plain(*(a.double() for a in args), *rest)
    sync()
    for t in (k32, p32):
        if not torch.isfinite(t).all():
            raise RuntimeError(f"{name}: non-finite output")
    ek = lane_rel(k32.double() - p64, p64)
    ep = lane_rel(p32.double() - p64, p64)
    tol = max(F64_RATIO * ep.max().item(), F64_FLOOR)
    if ek.max().item() > tol:
        raise RuntimeError(f"{name}: kernel error against float64 "
                           f"{ek.max().item():.3e} > {tol:.3e} "
                           f"(plain float32: {ep.max().item():.3e})")
    return {"max_abs_err": (k32 - p32).abs().max().item(),
            "rel_vs_plain": lane_rel(k32 - p32, p32).max().item(),
            "kernel_rel_vs_f64": ek.max().item(),
            "plain_rel_vs_f64": ep.max().item()}


def check_tight(name, kernel, plain, args, rest, rtol):
    """Kernel vs plain in float32 on a well-conditioned input."""
    k32 = kernel(*args, *rest)
    p32 = plain(*args, *rest)
    sync()
    rel = lane_rel(k32 - p32, p32).max().item()
    if not rel <= rtol:
        raise RuntimeError(f"{name}: per-lane relative error {rel:.3e} > "
                           f"{rtol}")
    return rel


def check_residuals(name, rk, rp):
    """The residual test of the LDL^T kernels on refine matrices."""
    import torch
    if not torch.isfinite(rk[torch.isfinite(rp)]).all():
        raise RuntimeError(f"{name}: non-finite kernel residual where the "
                           "plain version's is finite")
    live = rp <= LDLT_GROWTH
    bad = live & ~(rk <= torch.clamp(LDLT_RES_RATIO * rp,
                                     min=LDLT_RES_FLOOR))
    if bad.any():
        raise RuntimeError(
            f"{name}: {int(bad.sum())} of {int(live.sum())} lanes with kernel "
            f"residual > max({LDLT_RES_RATIO} x plain, {LDLT_RES_FLOOR}); "
            f"worst kernel {rk[bad].max().item():.3e}")


def random_epoch(st, B, rng, dev):
    """A well-conditioned epoch input in the BBT pattern of ``st``: a random
    diagonally dominant quasi-definite KKT whose dual diagonal is -1/rho
    (so the ADMM iteration is the method's own), random h and boxes."""
    import torch
    from polympc_torch.ops.bbt_kernel import prepare_epoch
    from polympc_torch.ops.structure import random_bbt_kkt
    M = random_bbt_kkt(st, B, seed=int(rng.integers(1 << 30)), device=dev)
    n, m = st.n, st.m
    f = lambda *shape: torch.as_tensor(rng.normal(size=shape),
                                       dtype=torch.float32, device=dev)
    rho = -1.0 / torch.diagonal(M, dim1=1, dim2=2)[:, n:]
    rb = torch.full((B, n), 0.1, device=dev)
    xl, al = -1.0 - f(B, n).abs(), -1.0 - f(B, m).abs()
    z = lambda k: torch.zeros((B, k), device=dev)
    return prepare_epoch(M, f(B, n), al, -al, xl, -xl, rho, rb, z(n), z(m),
                         z(n), z(m), z(n), st)


def phase_parity(ref, dev):
    import torch
    from polympc_torch.headline import kite_problem
    from polympc_torch.nlp.hessian import regularize
    from polympc_torch.nlp.refine import newton_system
    from polympc_torch.ops import bbt_kernel as bk
    from polympc_torch.ops import ldlt
    from polympc_torch.ops.structure import (
        bbt_structure, gather_blocks, permute_vec, random_bbt_kkt,
        unpermute_vec)
    from polympc_torch.parallel import make_batch_solver, pin_initial_state
    from polympc_torch.qp.box_admm import _build_kkt, penalties
    from polympc_torch.qp.types import QPData

    rng = np.random.default_rng(7)
    tr, bounds, prm, settings = kite_problem(dev)
    qs, st = settings.qp, settings.qp.structure
    nlp, nx = tr.nlp, tr.ocp.nx
    x0 = torch.as_tensor(ref["x0s"], dtype=torch.float32, device=dev)
    B = x0.shape[0]
    results = {}

    # ---- kernel 1: the epoch at bench's first SQP iterate ----
    bnd, x0sc = pin_initial_state(tr, bounds, x0)
    z0 = tr.rollout_guess(x0, prm)
    z0[:, :nx] = x0sc
    z0 = torch.clamp(z0, min=bnd.lbx, max=bnd.ubx)
    lam0 = torch.zeros((B, nlp.m), device=dev)
    H = regularize(nlp.lag_hessian(z0, lam0, prm), settings.reg,
                   settings.reg_eps)
    c = nlp.eq(z0, prm)
    qp = QPData(H=H, h=nlp.cost_grad(z0, prm), A=nlp.eq_jac(z0, prm),
                al=-c, au=-c, xl=bnd.lbx - z0, xu=bnd.ubx - z0)
    rho, rb = penalties(torch.full((B,), qs.rho, device=dev), qp, qs)
    kkt = _build_kkt(qp, rho, rb, qs.sigma)
    zeros = torch.zeros_like
    # the first epoch's state: x = q = 0, z = A x = 0, y = lam = 0, yb = 0
    kite = bk.prepare_epoch(kkt, qp.h, qp.al, qp.au, qp.xl, qp.xu, rho, rb,
                            zeros(z0), zeros(c), zeros(z0), lam0, zeros(z0),
                            st)
    ep = (qs.sigma, qs.alpha, qs.check_every)
    err = check_against_f64("bbt_epoch", bk.bbt_epoch, bk.bbt_epoch_plain,
                            kite, (st, *ep))
    st_b = bbt_structure(tr.N, nx, tr.ocp.nu, 0, 2, 0, tr.mesh.order,
                         tr.mesh.num_segments)
    for tag, s_ in (("kite", st), ("bordered", st_b)):
        case = random_epoch(s_, B, rng, dev)
        rel = check_tight("bbt_epoch", bk.bbt_epoch, bk.bbt_epoch_plain,
                          case, (s_, *ep), EPOCH_RTOL)
        say("parity", f"bbt_epoch random quasi-definite {tag} S={s_.S} "
                      f"k={s_.k} a={s_.a}: rel {rel:.2e} (tol {EPOCH_RTOL})")
    results["bbt_epoch"] = {
        **err, "ms": cuda_ms(lambda: bk.bbt_epoch(*kite, st, *ep)),
        "plain_ms": cuda_ms(lambda: bk.bbt_epoch_plain(*kite, st, *ep))}
    say("parity", f"bbt_epoch at the first kite iterate B={B} {st.S}x{st.k} "
                  f"nx={st.nx} iters={qs.check_every}: {results['bbt_epoch']}")

    # ---- kernel 2: factor + one solve, kite and bordered structures ----
    pad = permute_vec(torch.zeros((B, st.K), device=dev), st, 1.0) == 1.0
    rhs = torch.as_tensor(rng.normal(size=pad.shape), dtype=torch.float32,
                          device=dev)
    kite_solve = (*kite[:4], torch.where(pad, 0.0, rhs))
    err = check_against_f64("bbt_solve", bk.bbt_solve, bk.bbt_solve_plain,
                            kite_solve, (st,))
    Mb = random_bbt_kkt(st_b, B, seed=1, device=dev)
    bb = torch.as_tensor(rng.normal(size=(B, st_b.K)), dtype=torch.float32,
                         device=dev)
    bord = (*gather_blocks(Mb, st_b), permute_vec(bb, st_b, 0.0))
    rel = check_tight("bbt_solve", bk.bbt_solve, bk.bbt_solve_plain, bord,
                      (st_b,), SOLVE_RTOL)
    res = rel_residual(Mb, unpermute_vec(bk.bbt_solve(*bord, st_b), st_b),
                       bb).max().item()
    say("parity", f"bbt_solve bordered random quasi-definite S={st_b.S} "
                  f"k={st_b.k} a={st_b.a}: rel {rel:.2e} (tol {SOLVE_RTOL}), "
                  f"residual against the dense KKT {res:.2e}")
    results["bbt_solve"] = {
        **err, "ms": cuda_ms(lambda: bk.bbt_solve(*kite_solve, st)),
        "plain_ms": cuda_ms(lambda: bk.bbt_solve_plain(*kite_solve, st)),
        "bordered_ms": cuda_ms(lambda: bk.bbt_solve(*bord, st_b)),
        "bordered_plain_ms": cuda_ms(
            lambda: bk.bbt_solve_plain(*bord, st_b))}
    say("parity", f"bbt_solve at the first kite iterate: "
                  f"{results['bbt_solve']}")

    # ---- kernels 3 and 4: refine Newton matrices at the fp32 solution ----
    solve = make_batch_solver(tr, bounds, prm, settings, rollout_guess=True)
    sols = solve(x0)
    prm64 = tr.params(d=[0.05], t0=0.0, tf=2.0, dtype=torch.float64,
                      device=dev)
    b64 = bounds._replace(**{f: getattr(bounds, f).double()
                             for f in bounds._fields})
    bnd64, _ = pin_initial_state(tr, b64, x0.double())
    Ms, rs = newton_system(nlp, sols.x, sols.lam, bnd64, prm64,
                           matrix_dtype=torch.float32)
    M32, r32 = Ms.float().contiguous(), rs.float().contiguous()
    K = M32.shape[-1]
    # well-conditioned matrices of the same size: dense, symmetric,
    # diagonally dominant, indefinite (half the diagonal negative)
    A = torch.as_tensor(rng.normal(size=(B, K, K)), dtype=torch.float32,
                        device=dev)
    A = A + A.transpose(1, 2)
    sign = torch.where(torch.arange(K, device=dev) < K // 2, 1.0, -1.0)
    A = A + torch.diag_embed(sign * (A.abs().sum(2) + 1.0))
    bA = torch.as_tensor(rng.normal(size=(B, K)), dtype=torch.float32,
                         device=dev)
    rel = check_tight("ldlt_factor_solve", lambda *a: torch.cat(
        ldlt.ldlt_factor_solve(*a)[::2], 1), lambda *a: torch.cat(
        ldlt.ldlt_factor_solve_plain(*a)[::2], 1), (A, bA), (), LDLT_RTOL)
    say("parity", f"ldlt_factor_solve random diagonally dominant B={B} "
                  f"K={K}: x and d rel {rel:.2e} (tol {LDLT_RTOL})")
    _, FA, dA = ldlt.ldlt_factor_solve_plain(A, bA)
    rel = check_tight("ldlt_solve", ldlt.ldlt_solve, ldlt.ldlt_solve_plain,
                      (FA, dA, bA), (), LDLT_RTOL)
    say("parity", f"ldlt_solve random diagonally dominant B={B} K={K}: "
                  f"rel {rel:.2e} (tol {LDLT_RTOL})")

    xk, Fk, dk = ldlt.ldlt_factor_solve(M32, r32)
    xp, Fp, dp = ldlt.ldlt_factor_solve_plain(M32, r32)
    sync()
    rk, rp = rel_residual(Ms, xk, rs), rel_residual(Ms, xp, rs)
    check_residuals("ldlt_factor_solve", rk, rp)
    results["ldlt_factor_solve"] = {
        "max_abs_err": (xk - xp).abs().max().item(),
        "res_kernel_max": rk.max().item(), "res_plain_max": rp.max().item(),
        "growth_lanes": int((rp > LDLT_GROWTH).sum()),
        "ms": cuda_ms(lambda: ldlt.ldlt_factor_solve(M32, r32)),
        "plain_ms": cuda_ms(lambda: ldlt.ldlt_factor_solve_plain(M32, r32))}
    say("parity", f"ldlt_factor_solve at the refine matrices B={B} K={K}: "
                  f"{results['ldlt_factor_solve']}")
    # the solve alone, against the plain version's factor
    sk = ldlt.ldlt_solve(Fp, dp, r32)
    sp = ldlt.ldlt_solve_plain(Fp, dp, r32)
    sync()
    rk, rp = rel_residual(Ms, sk, rs), rel_residual(Ms, sp, rs)
    check_residuals("ldlt_solve", rk, rp)
    results["ldlt_solve"] = {
        "max_abs_err": (sk - sp).abs().max().item(),
        "res_kernel_max": rk.max().item(), "res_plain_max": rp.max().item(),
        "growth_lanes": int((rp > LDLT_GROWTH).sum()),
        "ms": cuda_ms(lambda: ldlt.ldlt_solve(Fp, dp, r32)),
        "plain_ms": cuda_ms(lambda: ldlt.ldlt_solve_plain(Fp, dp, r32))}
    say("parity", f"ldlt_solve B={B} K={K}: {results['ldlt_solve']}")
    return results


def phase_main(ref, card, dev):
    import torch
    from polympc_torch.headline import run
    from polympc_torch.ops import _build
    _build.reset_launches()
    extra, lanes = run(B=ref["x0s"].shape[0], device=dev, reps=5,
                       x0s=ref["x0s"])
    launches = dict(_build.LAUNCHES)
    for name in ("bbt_epoch", "ldlt_factor_solve", "ldlt_solve"):
        if launches[name] <= 0:
            raise RuntimeError(f"main path never launched kernel {name}")
    res = lanes["residual"]
    if res.shape != ref["residual"].shape or not np.isfinite(res).all():
        raise RuntimeError("main path: residuals of the wrong shape or "
                           "non-finite")
    mine, theirs = lanes["certified"], ref["certified"].astype(bool)
    extra["certified_solves_per_s"] = extra["solved"] / \
        extra["wall_s_per_batch"]
    say("main", f"{card}: certified {extra['solved']}/{extra['batch']}, "
                f"status_solved {extra['status_solved']}, "
                f"kkt_residual_max {extra['kkt_residual_max']}, "
                f"mean_sqp_iters {extra['mean_sqp_iters']}, "
                f"wall_s_per_batch {extra['wall_s_per_batch']:.4f}, "
                f"certified solves/s {extra['certified_solves_per_s']:.1f}")
    say("main", f"launches {launches}")
    say("main", f"reference certifies {int(theirs.sum())}; common "
                f"{int((mine & theirs).sum())}; port only "
                f"{np.nonzero(mine & ~theirs)[0].tolist()}; reference only "
                f"{np.nonzero(~mine & theirs)[0].tolist()}; lanes whose "
                f"status differs: "
                f"{int((lanes['status'] != ref['status']).sum())}")
    if extra["solved"] < int(theirs.sum()) - CERTIFY_SLACK:
        raise RuntimeError(f"main path certifies {extra['solved']}, fewer "
                           f"than the reference's {int(theirs.sum())} - "
                           f"{CERTIFY_SLACK}")
    return launches


KERNELS = (
    ("bbt_epoch", "polympc_torch/csrc/bbt_epoch.cu",
     "polympc_tpu/ops/bbt_kernel.py:473"),
    ("bbt_solve", "polympc_torch/csrc/bbt_epoch.cu",
     "polympc_tpu/ops/bbt_kernel.py:635"),
    ("ldlt_factor_solve", "polympc_torch/csrc/ldlt.cu",
     "polympc_tpu/ops/ldlt.py:355"),
    ("ldlt_solve", "polympc_torch/csrc/ldlt.cu",
     "polympc_tpu/ops/ldlt.py:328"),
)


def main():
    import torch
    card, smi = phase_device()
    import_port()
    ref = dict(np.load(REFERENCE))
    phase_build()
    parity = phase_parity(ref, "cuda")
    launches = phase_main(ref, smi, "cuda")
    kernels = [{"name": n, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[n], "on_main_path": n != "bbt_solve",
                **parity[n]} for n, src, rep in KERNELS]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
