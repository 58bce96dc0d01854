#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (polympc_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines and raising on failure:

  1. device: a CUDA card is required (there is no CPU path); prints the
     card's name and power limit as nvidia-smi reports them;
  2. build: compiles the hand-written kernels (polympc_torch/csrc) for
     sm_90a from this checkout, one nvcc per source in parallel, and prints
     the build seconds;
  3. kernel parity at the main paths' shapes, float32: every kernel against
     its plain PyTorch version on the same inputs on the card, with the
     time of each (median of 10, CUDA events), the least time the card
     could take for the same work (bound) and, where one PyTorch call
     computes the same function, that call's time (median of 3); the BBT
     kernels and the explicit inverse also against the PyTorch mirror of
     their own algorithm (explicit block inverses by a Gauss-Jordan
     sweep), and the BBT epoch timed at 128 and 256 threads per block at
     the kite's and the race car's shapes;
  4. main paths, each with the launch counts set to 0 just before it and
     read just after:
       kite: bench.py's certified kite batch (B=512), one warm-up then the
         median wall of 3 repetitions, against the JAX package's record
         (tests/data/kite_b512_jax_cpu.npz);
       the reference's headline table (polympc_torch/headline_table.py)
       against the JAX package's record (tests/data/headline_jax_cpu.npz):
       spline-fitting QP (B=4096, and B=1 beside the LU epoch), frame
       transform (B=4096, and B=1), race car (B=512 with the fp64 certify,
       3 repetitions, and the B=1 warm re-solve, 10 repetitions);
       dist_kite_s8: the horizon-partitioned SQP (polympc_torch/
       dist_point.py: kite, Chebyshev(5) x 8 segments, B=128, fp64
       certify), a small warm-up then one timed batch through the kernel
       route, and its B=1 point through the "lu" and the kernel route;
       then, outside the counts, the same batch through the "lu" route;
       each route against the JAX package's record of the same route
       (tests/data/dist_kite_s8_jax_cpu.npz);
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
HEADLINE_REFERENCE = os.path.join(ROOT, "tests", "data",
                                  "headline_jax_cpu.npz")
DIST_REFERENCE = os.path.join(ROOT, "tests", "data",
                              "dist_kite_s8_jax_cpu.npz")

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
# The BBT kernels and the explicit inverse compute by another algorithm
# than their plain versions (they invert blocks by an in-place Gauss-Jordan
# sweep and apply the inverses; the plain versions substitute through
# LDL^T factors).  Against the PyTorch mirror of their own algorithm
# (ops.bbt_kernel.bbt_epoch_mirror, bbt_solve_mirror,
# ops.ldlt.sweep_inverse_mirror), on the same well-conditioned inputs, the
# same operations differ only in the order of their sums: relative
# inf-norm 1e-5 per lane.
MIRROR_RTOL = 1e-5
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
# The factor kernel alone is held there on its factor against the plain
# version in float64 (the F64_RATIO rule above) and on the residual of its
# factor solved by the solve kernel.
LDLT_RTOL = 1e-4
LDLT_RES_RATIO = 10.0
LDLT_RES_FLOOR = 1e-5
LDLT_GROWTH = 1e-3
# The kite and race-car paths may certify at most 10 lanes (2% of B) fewer
# than the JAX record: float32 SQP iterates are chaotic across summation
# orders.  The spline QP and the frame transform must solve exactly as many
# lanes as the record.
CERTIFY_SLACK = 10
# The dist path (B=128) may certify at most 3 lanes (2% of B) fewer.
DIST_SLACK = 3
# Published peaks of one H100 SXM: float32 outside the tensor cores and HBM
# bandwidth (the bound of a kernel is the larger of flops and bytes over
# these).
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


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
    """Median time of fn() on the card over reps samples, after one
    warm-up.  A sample times back-to-back calls between two CUDA events,
    as many as fill about 2 ms (at most 20, at least 1), so that the host's
    time to launch a short kernel hides behind the queue instead of adding
    to the kernel's."""
    import torch
    if not torch.cuda.is_available():
        return float("nan")
    fn()
    torch.cuda.synchronize()

    def sample(calls):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / calls

    calls = int(min(20, max(1, 2.0 // max(sample(1), 1e-3))))
    return float(np.median([sample(calls) for _ in range(reps)]))


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
    from polympc_torch.ops import bbt_kernel as bk
    from polympc_torch.ops import ldlt
    from polympc_torch.ops.structure import (
        bbt_structure, gather_blocks, permute_vec, random_bbt_kkt,
        unpermute_vec)
    from polympc_torch.parallel import pin_initial_state
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
        relm = check_tight("bbt_epoch (mirror)", bk.bbt_epoch,
                           bk.bbt_epoch_mirror, case, (s_, *ep), MIRROR_RTOL)
        say("parity", f"bbt_epoch random quasi-definite {tag} S={s_.S} "
                      f"k={s_.k} a={s_.a}: rel {rel:.2e} (tol {EPOCH_RTOL}); "
                      f"against its mirror {relm:.2e} (tol {MIRROR_RTOL})")
    results["bbt_epoch"] = {
        **err, **timing(lambda: bk.bbt_epoch(*kite, st, *ep),
                        lambda: bk.bbt_epoch_plain(*kite, st, *ep), None,
                        bound_bbt_epoch(st, B, qs.check_every)),
        **by_threads(bk, kite, st, ep)}
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
    relm = check_tight("bbt_solve (mirror)", bk.bbt_solve,
                       bk.bbt_solve_mirror, bord, (st_b,), MIRROR_RTOL)
    res = rel_residual(Mb, unpermute_vec(bk.bbt_solve(*bord, st_b), st_b),
                       bb).max().item()
    say("parity", f"bbt_solve bordered random quasi-definite S={st_b.S} "
                  f"k={st_b.k} a={st_b.a}: rel {rel:.2e} (tol {SOLVE_RTOL}), "
                  f"against its mirror {relm:.2e} (tol {MIRROR_RTOL}), "
                  f"residual against the dense KKT {res:.2e}")
    b_dense = unpermute_vec(kite_solve[4], st)
    results["bbt_solve"] = {
        **err, **timing(lambda: bk.bbt_solve(*kite_solve, st),
                        lambda: bk.bbt_solve_plain(*kite_solve, st),
                        library_ms("bbt_solve", lambda: torch.linalg.solve(
                            kkt, b_dense)), bound_bbt_solve(st, B)),
        "bordered_ms": cuda_ms(lambda: bk.bbt_solve(*bord, st_b)),
        "bordered_plain_ms": cuda_ms(
            lambda: bk.bbt_solve_plain(*bord, st_b))}
    say("parity", f"bbt_solve at the first kite iterate: "
                  f"{results['bbt_solve']}")

    # ---- kernels 3 and 4: refine Newton matrices at the fp32 solution ----
    Ms, rs = kite_refine_inputs(x0, dev)
    M32, r32 = Ms.float().contiguous(), rs.float().contiguous()
    K = M32.shape[-1]
    # well-conditioned matrices of the same size: dense, symmetric,
    # diagonally dominant, indefinite (half the diagonal negative)
    A, bA = diag_dominant(B, K, rng, dev)
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

    out = refine_checks(Ms, M32, r32)
    results.update(out)
    for name in out:
        say("parity", f"{name} at the kite's refine matrices B={B} K={K}: "
                      f"{out[name]}")
    return results


def kite_refine_inputs(x0, dev):
    """The kite's certify Newton-KKT matrices (K=132, float32) and
    right-hand sides (float64) at the batch's fp32 solution from x0."""
    import torch
    from polympc_torch.headline import kite_problem
    from polympc_torch.nlp.refine import newton_system
    from polympc_torch.parallel import make_batch_solver, pin_initial_state
    tr, bounds, prm, settings = kite_problem(dev)
    sols = make_batch_solver(tr, bounds, prm, settings,
                             rollout_guess=True)(x0)
    prm64 = tr.params(d=[0.05], t0=0.0, tf=2.0, dtype=torch.float64,
                      device=dev)
    b64 = bounds._replace(**{f: getattr(bounds, f).double()
                             for f in bounds._fields})
    bnd64, _ = pin_initial_state(tr, b64, x0.double())
    return newton_system(tr.nlp, sols.x, sols.lam, bnd64, prm64,
                         matrix_dtype=torch.float32)


def by_threads(bk, args, st, ep):
    """The BBT epoch's time at 128 and 256 threads per block on the same
    inputs, and the block size its wrapper chooses (epoch_threads)."""
    ms = {t: cuda_ms(lambda: bk._launch_epoch(*args, st, *ep, t))
          for t in bk._THREADS}
    chosen = bk.epoch_threads(st)
    say("parity", f"bbt_epoch S={st.S} k={st.k}: {ms[128]:.4f} ms at 128 "
                  f"threads, {ms[256]:.4f} ms at 256; the wrapper takes "
                  f"{chosen}")
    return {"ms_by_threads": ms, "threads": chosen}


def bound(flops, nbytes):
    """The least time the card could take: the larger of the operations
    over the fp32 peak and the bytes (each input read once, each output
    written once) over the memory rate."""
    tf, tb = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return {"bound_ms": max(tf, tb) * 1e3,
            "bound_by": "operations" if tf >= tb else "bytes"}


def flops_factor(K):
    """Unpivoted LDL^T of one symmetric K x K matrix: at each pivot the
    rank-1 update of the trailing block's lower triangle (n (n+1) / 2
    multiply-adds for a trailing order n) and the n scalings of the
    column; about K^3 / 3."""
    return sum(n * (n + 1) + n for n in range(1, K))


def flops_inverse(K):
    """The symmetric inverse from an LDL^T factor: the unit triangle's
    inverse and the product L^-T D^-1 L^-1, of which only one triangle is
    needed; about K^3 / 3 each (LAPACK's count for xPOTRI)."""
    return 2 * K ** 3 // 3


def flops_solve(K, nrhs=1):
    """Forward, diagonal and backward sweeps against a packed factor."""
    return nrhs * (2 * K * (K - 1) + K)


def flops_bbt_factor(st):
    S, k, nx, a = st.S, st.k, st.nx, st.a
    f = 2 * a ** 3
    for s in range(S):
        if s > 0:
            f += 2 * (k * nx * nx + a * k * nx + k * k * nx)
        f += flops_factor(k) + flops_solve(k, nx + a) + 2 * a * a * k
    return f


def flops_bbt_solve(st):
    S, k, nx, a = st.S, st.k, st.nx, st.a
    return (S * flops_solve(k) + 4 * (S - 1) * k * nx + 4 * S * a * k
            + 2 * a * a)


def bbt_bytes(st, nvec):
    return 4 * (st.S * st.k * (st.k + st.nx + st.a) + st.a * st.a
                + nvec * (st.S * st.k + st.a))


def bound_bbt_epoch(st, B, iters):
    L = st.S * st.k + st.a
    f = flops_bbt_factor(st) + iters * (flops_bbt_solve(st) + 15 * L)
    return bound(B * f, B * bbt_bytes(st, 11))


def bound_bbt_solve(st, B):
    f = flops_bbt_factor(st) + flops_bbt_solve(st)
    return bound(B * f, B * bbt_bytes(st, 2))


def bound_admm_epoch(B, n, m, iters):
    K = n + m
    f = flops_factor(K) + iters * (flops_solve(K) + 20 * K)
    return bound(B * f, B * 4 * (K * K + 10 * n + 7 * m))


def bound_ldlt(kind, B, K):
    f = {"factor": flops_factor(K), "solve": flops_solve(K),
         "factor_solve": flops_factor(K) + flops_solve(K)}[kind]
    nb = {"factor": 2 * K * K + K, "solve": K * K + 3 * K,
          "factor_solve": 2 * K * K + 3 * K}[kind]
    return bound(B * f, B * 4 * nb)


def library_ms(name, fn):
    """Time of one PyTorch call computing the same function, as a yardstick
    (the port never calls it), median of 3; None where the call fails on
    this card."""
    try:
        return cuda_ms(fn, reps=3)
    except RuntimeError as err:
        say("parity", f"{name}: library call failed: {err}")
        return None


def timing(kernel, plain, library, bnd):
    return {"ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain),
            "library_ms": library, **bnd}


def diag_dominant(B, K, rng, dev):
    """Dense symmetric indefinite diagonally dominant matrices (half the
    diagonal negative) and right-hand sides."""
    import torch
    A = torch.as_tensor(rng.normal(size=(B, K, K)), dtype=torch.float32,
                        device=dev)
    A = A + A.transpose(1, 2)
    sign = torch.where(torch.arange(K, device=dev) < K // 2, 1.0, -1.0)
    A = A + torch.diag_embed(sign * (A.abs().sum(2) + 1.0))
    b = torch.as_tensor(rng.normal(size=(B, K)), dtype=torch.float32,
                        device=dev)
    return A, b


def random_dense_epoch(n, m, B, rng, dev):
    """A batch of well-conditioned quasi-definite boxADMM KKTs built for
    their own rho/rb (the recipe of tests/test_tpu_kernels.py:170-228) and
    a random state, float32 on the card."""
    import torch
    G = rng.standard_normal((B, n, n))
    H = G @ G.transpose(0, 2, 1) / n + np.eye(n)
    J = rng.standard_normal((B, m, n))
    rho = rng.uniform(0.5, 2.0, (B, m))
    rb = rng.uniform(0.05, 0.2, (B, n))
    K = np.zeros((B, n + m, n + m))
    K[:, :n, :n] = H + 1e-6 * np.eye(n) + rb[:, :, None] * np.eye(n)
    K[:, :n, n:] = J.transpose(0, 2, 1)
    K[:, n:, :n] = J
    K[:, n:, n:] = -np.eye(m) / rho[:, :, None]
    al = rng.normal(size=(B, m)) - 2.0
    au = al + rng.uniform(0.5, 3.0, (B, m))
    xl, xu = np.full((B, n), -0.8), np.full((B, n), 0.8)
    vec = lambda k: rng.normal(size=(B, k)) * 0.1
    arrays = (K, rng.standard_normal((B, n)), al, au, xl, xu, rho, rb,
              vec(n), vec(m), vec(n) + 0.01, vec(m), vec(n))
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=dev)
                 for a in arrays)


def epoch_fns(**kw):
    """The dense epoch and its plain version as functions of the 13 epoch
    arguments returning one (B, 3n + 2m) tensor."""
    import torch
    from polympc_torch.ops import admm_epoch as ae
    return (lambda *a: torch.cat(ae.admm_epoch_batched(*a, **kw), 1),
            lambda *a: torch.cat(ae.admm_epoch_plain(*a, **kw), 1))


def phase_parity_dense(dev, results):
    """The dense boxADMM epoch and the LDL^T factor: at the spline QP's
    first Ruiz-scaled epoch (B=4096, K=47), on random well-conditioned
    quasi-definite KKTs (K=47, K=132, and box-only), and the factor on
    diagonally dominant matrices."""
    import torch
    from polympc_torch import headline_table as ht
    from polympc_torch.ops import _build
    from polympc_torch.ops import admm_epoch as ae
    from polympc_torch.ops import ldlt
    from polympc_torch.qp.box_admm import _build_kkt, penalties
    from polympc_torch.qp.ruiz import ruiz_equilibrate
    rng = np.random.default_rng(11)
    qs = ht.spline_settings()
    _, big = ht.spline_batch(4096, dev)
    qp, _ = ruiz_equilibrate(big, qs.equil_iters)
    B, n = qp.h.shape
    m = qp.al.shape[1]
    rho, rb = penalties(torch.full((B,), qs.rho, device=dev), qp, qs)
    kkt = _build_kkt(qp, rho, rb, qs.sigma)
    zero = lambda k: torch.zeros((B, k), device=dev)
    spline = (kkt, qp.h, qp.al, qp.au, qp.xl, qp.xu, rho, rb, zero(n),
              zero(m), zero(n), zero(m), zero(n))
    kw = dict(sigma=qs.sigma, alpha=qs.alpha, iters=qs.check_every)
    kern, plain = epoch_fns(**kw)
    err = check_against_f64("admm_epoch", kern, plain, spline, ())
    for nn, mm in ((32, 15), (77, 55), (47, 0)):
        case = random_dense_epoch(nn, mm, 512, rng, dev)
        rel = check_tight("admm_epoch", kern, plain, case, (), EPOCH_RTOL)
        say("parity", f"admm_epoch random quasi-definite B=512 n={nn} "
                      f"m={mm}: rel {rel:.2e} (tol {EPOCH_RTOL})")
    by_threads = {t: cuda_ms(lambda: ae.admm_epoch_batched(
        *spline, threads=t, **kw)) for t in (64, 128, 256)}
    k132 = random_dense_epoch(77, 55, 512, rng, dev)
    by_threads_132 = {t: cuda_ms(lambda: ae.admm_epoch_batched(
        *k132, threads=t, **kw)) for t in (64, 128, 256)}
    results["admm_epoch"] = {
        **err, **timing(lambda: kern(*spline), lambda: plain(*spline), None,
                        bound_admm_epoch(B, n, m, qs.check_every)),
        "shape": f"B={B} n={n} m={m} iters={qs.check_every}",
        "threads": ae.epoch_threads(n + m),
        "ms_by_threads": by_threads,
        "ms_by_threads_K132_B512": by_threads_132,
        "smem_bytes": int(ae.epoch_smem_bytes(n, m))}
    if _build.library().pt_admm_epoch_smem_bytes(n, m) != \
            ae.epoch_smem_bytes(n, m):
        raise RuntimeError("admm_epoch: the wrapper's fit rule and the "
                           "kernel's shared memory disagree")
    say("parity", f"admm_epoch at the spline QP's first scaled epoch "
                  f"B={B} K={n + m}: {results['admm_epoch']}")

    for K in (132, 165):
        A, _ = diag_dominant(512, K, rng, dev)
        flat = lambda F, d: torch.cat([F.flatten(1), d], 1)
        rel = check_tight("ldlt_factor", lambda M: flat(*ldlt.ldlt_factor(M)),
                          lambda M: flat(*ldlt.ldlt_factor_plain(M)), (A,),
                          (), LDLT_RTOL)
        say("parity", f"ldlt_factor random diagonally dominant B=512 K={K}: "
                      f"F and d rel {rel:.2e} (tol {LDLT_RTOL})")


def race_car_inputs(dev):
    """The race car's main-path inputs on the card: the first boxADMM epoch
    of the warm-started batch (B=512, S=2 blocks of k=96) and the certify's
    Newton-KKT matrices (K=165) at the batch's fp32 solution."""
    import torch
    from polympc_torch import headline_table as ht
    from polympc_torch.nlp.hessian import regularize
    from polympc_torch.nlp.refine import newton_system
    from polympc_torch.ops import bbt_kernel as bk
    from polympc_torch.parallel import pin_initial_state
    from polympc_torch.qp.box_admm import _build_kkt, penalties
    from polympc_torch.qp.types import QPData
    tr, bounds, prm, solve, sol = ht.race_car_cold(dev)
    warm = ht.race_car_problem(dev)[4]
    nlp, nx = tr.nlp, tr.ocp.nx
    x0s = torch.as_tensor(ht.race_car_x0s(512), device=dev)
    B = x0s.shape[0]
    bnd, x0sc = pin_initial_state(tr, bounds, x0s)
    z = sol.x.expand(B, -1).clone()
    z[:, :nx] = x0sc
    lam, lam_box = sol.lam.expand(B, -1), sol.lam_box.expand(B, -1)
    qs = warm.qp
    c = nlp.eq(z, prm)
    qp = QPData(H=regularize(nlp.lag_hessian(z, lam, prm), warm.reg,
                             warm.reg_eps),
                h=nlp.cost_grad(z, prm), A=nlp.eq_jac(z, prm), al=-c, au=-c,
                xl=bnd.lbx - z, xu=bnd.ubx - z)
    rho, rb = penalties(torch.full((B,), qs.rho, device=dev), qp, qs)
    kkt = _build_kkt(qp, rho, rb, qs.sigma)
    zeros = torch.zeros_like
    epoch = bk.prepare_epoch(kkt, qp.h, qp.al, qp.au, qp.xl, qp.xu, rho, rb,
                             zeros(z), zeros(c), zeros(z), lam, lam_box,
                             qs.structure)
    sols = solve(x0s, sol.x.expand(B, -1), lam, lam_box)
    prm64 = tr.params(d=[15.0], t0=0.0, tf=2.0, dtype=torch.float64,
                      device=dev)
    b64 = bounds._replace(**{f: getattr(bounds, f).double()
                             for f in bounds._fields})
    bnd64, _ = pin_initial_state(tr, b64, x0s.double())
    Ms, rs = newton_system(nlp, sols.x, sols.lam, bnd64, prm64,
                           matrix_dtype=torch.float32)
    return qs, epoch, Ms, rs


def phase_parity_race_car(dev, results):
    """The BBT epoch and the LDL^T kernels at the race car's shapes."""
    import torch
    from polympc_torch.ops import bbt_kernel as bk
    from polympc_torch.ops import ldlt
    rng = np.random.default_rng(13)
    qs, epoch, Ms, rs = race_car_inputs(dev)
    st = qs.structure
    B = epoch[0].shape[0]
    ep = (qs.sigma, qs.alpha, qs.check_every)
    err = check_against_f64("bbt_epoch", bk.bbt_epoch, bk.bbt_epoch_plain,
                            epoch, (st, *ep))
    case = random_epoch(st, B, rng, dev)
    rel = check_tight("bbt_epoch", bk.bbt_epoch, bk.bbt_epoch_plain, case,
                      (st, *ep), EPOCH_RTOL)
    relm = check_tight("bbt_epoch (mirror)", bk.bbt_epoch,
                       bk.bbt_epoch_mirror, case, (st, *ep), MIRROR_RTOL)
    say("parity", f"bbt_epoch random quasi-definite race-car S={st.S} "
                  f"k={st.k}: rel {rel:.2e} (tol {EPOCH_RTOL}); against its "
                  f"mirror {relm:.2e} (tol {MIRROR_RTOL})")
    results["bbt_epoch"]["race_car"] = {
        **err, **timing(lambda: bk.bbt_epoch(*epoch, st, *ep),
                        lambda: bk.bbt_epoch_plain(*epoch, st, *ep), None,
                        bound_bbt_epoch(st, B, qs.check_every)),
        **by_threads(bk, epoch, st, ep),
        "shape": f"B={B} S={st.S} k={st.k} nx={st.nx} "
                 f"iters={qs.check_every}"}
    say("parity", f"bbt_epoch at the race car's first warm epoch: "
                  f"{results['bbt_epoch']['race_car']}")

    M32, r32 = Ms.float().contiguous(), rs.float().contiguous()
    K = M32.shape[-1]
    A, bA = diag_dominant(B, K, rng, dev)
    rel = check_tight("ldlt_factor_solve", lambda *a: torch.cat(
        ldlt.ldlt_factor_solve(*a)[::2], 1), lambda *a: torch.cat(
        ldlt.ldlt_factor_solve_plain(*a)[::2], 1), (A, bA), (), LDLT_RTOL)
    _, FA, dA = ldlt.ldlt_factor_solve_plain(A, bA)
    rel2 = check_tight("ldlt_solve", ldlt.ldlt_solve, ldlt.ldlt_solve_plain,
                       (FA, dA, bA), (), LDLT_RTOL)
    say("parity", f"ldlt_factor_solve / ldlt_solve random diagonally "
                  f"dominant B={B} K={K}: rel {rel:.2e} / {rel2:.2e}")
    out = refine_checks(Ms, M32, r32)
    for name in ("ldlt_factor_solve", "ldlt_solve", "ldlt_factor"):
        results[name]["race_car"] = out[name]
        say("parity", f"{name} at the race car's refine matrices B={B} "
                      f"K={K}: {out[name]}")


def refine_checks(Ms, M32, r32):
    """The three LDL^T kernels on certify Newton matrices: each against its
    plain version through the residual test, with their times."""
    import torch
    from polympc_torch.ops import ldlt
    B, K = r32.shape
    rs = r32.double()
    out = {}
    xk, _, _ = ldlt.ldlt_factor_solve(M32, r32)
    xp, Fp, dp = ldlt.ldlt_factor_solve_plain(M32, r32)
    sync()
    rk, rp = rel_residual(Ms, xk, rs), rel_residual(Ms, xp, rs)
    check_residuals("ldlt_factor_solve", rk, rp)
    out["ldlt_factor_solve"] = {
        "max_abs_err": (xk - xp).abs().max().item(),
        "res_kernel_max": rk.max().item(), "res_plain_max": rp.max().item(),
        "growth_lanes": int((rp > LDLT_GROWTH).sum()),
        **timing(lambda: ldlt.ldlt_factor_solve(M32, r32),
                 lambda: ldlt.ldlt_factor_solve_plain(M32, r32),
                 library_ms("ldlt_factor_solve",
                            lambda: torch.linalg.solve(M32, r32)),
                 bound_ldlt("factor_solve", B, K))}
    sk = ldlt.ldlt_solve(Fp, dp, r32)
    sp = ldlt.ldlt_solve_plain(Fp, dp, r32)
    sync()
    rk, rp = rel_residual(Ms, sk, rs), rel_residual(Ms, sp, rs)
    check_residuals("ldlt_solve", rk, rp)
    ldl_solve = ldl_solve_library(Fp, dp, r32, sp)
    out["ldlt_solve"] = {
        "max_abs_err": (sk - sp).abs().max().item(),
        "res_kernel_max": rk.max().item(), "res_plain_max": rp.max().item(),
        "growth_lanes": int((rp > LDLT_GROWTH).sum()),
        **timing(lambda: ldlt.ldlt_solve(Fp, dp, r32),
                 lambda: ldlt.ldlt_solve_plain(Fp, dp, r32),
                 library_ms("ldlt_solve (torch.linalg.ldl_solve on the "
                            "unpivoted factor)", ldl_solve),
                 bound_ldlt("solve", B, K))}
    # the factor alone, held on the factor itself against the plain version
    # in float64, and through the residual of the pair a caller runs
    # (ldlt_factor, then ldlt_solve): summation-order differences in the
    # unpivoted factor of these indefinite matrices are amplified lane by
    # lane, so the kernel's factor is not held to the plain float32
    # factor's residual under other sweeps
    Fk, dk = ldlt.ldlt_factor(M32)
    err = check_factor_against_f64("ldlt_factor", Fk, dk, M32)
    fk = ldlt.ldlt_solve(Fk, dk, r32)
    sync()
    rk = rel_residual(Ms, fk, rs)
    check_residuals("ldlt_factor", rk, rp)
    out["ldlt_factor"] = {
        **err, "res_kernel_max": rk.max().item(),
        "res_plain_max": rp.max().item(),
        **timing(lambda: ldlt.ldlt_factor(M32),
                 lambda: ldlt.ldlt_factor_plain(M32),
                 library_ms("ldlt_factor (torch.linalg.ldl_factor, "
                            "pivoted)", lambda: torch.linalg.ldl_factor(M32)),
                 bound_ldlt("factor", B, K))}
    return out


def ldl_solve_library(F, d, b, x_plain):
    """``torch.linalg.ldl_solve`` on the same unpivoted factor (LD = the
    strict lower triangle of F' plus diag(d); pivots 1..K, no interchange)
    as a function of no arguments: the one PyTorch call that computes what
    ``ldlt_solve`` computes.  Prints its per-lane relative difference from
    the plain version, or its error where the call fails."""
    import torch
    B, K = b.shape
    LD = torch.tril(F.transpose(-1, -2), -1) + torch.diag_embed(d)
    piv = torch.arange(1, K + 1, dtype=torch.int32,
                       device=b.device).expand(B, K).contiguous()
    fn = lambda: torch.linalg.ldl_solve(LD, piv, b[..., None])[..., 0]
    try:
        x = fn()
        sync()
        say("parity", f"torch.linalg.ldl_solve on the unpivoted factor B={B} "
                      f"K={K}: rel vs plain "
                      f"{lane_rel(x - x_plain, x_plain).max().item():.2e}")
    except RuntimeError as err:
        say("parity", f"torch.linalg.ldl_solve B={B} K={K} failed: {err}")
    return fn


def quasi_definite(B, nz, m, rng, dev):
    """Random symmetric quasi-definite [[H, A'], [A, -D]] (H positive
    definite, D a positive diagonal), float32 on the card."""
    import torch
    G = rng.normal(size=(B, nz, nz))
    K = np.zeros((B, nz + m, nz + m))
    K[:, :nz, :nz] = G @ G.transpose(0, 2, 1) / nz + np.eye(nz)
    A = rng.normal(size=(B, m, nz))
    K[:, :nz, nz:] = A.transpose(0, 2, 1)
    K[:, nz:, :nz] = A
    K[:, nz:, nz:] = -np.eye(m) * rng.uniform(0.1, 2.0, (B, m, 1))
    return torch.as_tensor(K, dtype=torch.float32, device=dev)


def bound_inverse(B, K):
    """The symmetric factor and the symmetric inverse from it (about K^3
    flops) against reading and writing K x K per matrix."""
    return bound(B * (flops_factor(K) + flops_inverse(K)), B * 8 * K * K)


def phase_parity_dist(drec, dev, results):
    """ldlt_inverse at the dist path's shape (B*S = 1024 matrices, K=72):
    on the dist batch's first-epoch ADMM KKTs (rho*1e3 equality rows, so
    held against float64 by the F64 rule) and on random quasi-definite
    matrices (LDLT_RTOL against the plain version)."""
    import torch
    from polympc_torch import dist_point as dp
    from polympc_torch.ops import _build
    from polympc_torch.ops import ldlt
    from polympc_torch.parallel.dist_sqp import first_epoch_kkt
    from polympc_torch.parallel.multihost import pin_segment_head
    rng = np.random.default_rng(17)
    dtr, bounds, settings = dp.dist_problem(dev)
    x0 = torch.as_tensor(drec["x0s"], dtype=torch.float32, device=dev)
    W0, P0 = dtr.rollout_guess(x0, d=dp.D)
    K = first_epoch_kkt(dtr, pin_segment_head(dtr, bounds, x0), W0, P0,
                        d=dp.D, settings=settings)
    Kf = K.reshape(-1, K.shape[-1], K.shape[-1]).contiguous()
    n, k = Kf.shape[0], Kf.shape[-1]
    err = check_against_f64("ldlt_inverse", ldlt.ldlt_inverse,
                            ldlt.ldlt_inverse_plain, (Kf,), ())
    qd = (quasi_definite(n, dtr.kz, dtr.ml, rng, dev),)
    rel = check_tight("ldlt_inverse", ldlt.ldlt_inverse,
                      ldlt.ldlt_inverse_plain, qd, (), LDLT_RTOL)
    relm = check_tight("ldlt_inverse (mirror)", ldlt.ldlt_inverse,
                       ldlt.sweep_inverse_mirror, qd, (), MIRROR_RTOL)
    say("parity", f"ldlt_inverse random quasi-definite B={n} K={k}: rel "
                  f"{rel:.2e} (tol {LDLT_RTOL}); against its mirror "
                  f"{relm:.2e} (tol {MIRROR_RTOL})")
    lib = _build.library()
    if lib.pt_ldlt_inverse_smem_bytes(k) != ldlt.inverse_smem_bytes(k):
        raise RuntimeError("ldlt_inverse: the wrapper's fit rule and the "
                           "kernel's shared memory disagree")
    rules = [(f"bbt at {t} threads", kmax,
              lambda kk, t=t: lib.pt_bbt_tile_fits(kk, 0, t))
             for t, kmax in _build.SWEEP_MAX_K.items()]
    rules.append(("ldlt_inverse", _build.SWEEP_MAX_K[ldlt._THREADS],
                  lib.pt_ldlt_inverse_fits))
    for what, kmax, fits in rules:
        for kk in (kmax, kmax + 1):
            if bool(fits(kk)) != (kk <= kmax):
                raise RuntimeError(f"the sweep's fit rule ({what}) and the "
                                   f"kernels' tiles disagree at k={kk}")
    results["ldlt_inverse"] = {
        **err, **timing(lambda: ldlt.ldlt_inverse(Kf),
                        lambda: ldlt.ldlt_inverse_plain(Kf),
                        library_ms("ldlt_inverse (torch.linalg.inv)",
                                   lambda: torch.linalg.inv(Kf)),
                        bound_inverse(n, k)),
        "shape": f"B*S={n} K={k}", "random_rel_vs_plain": rel,
        "random_rel_vs_mirror": relm,
        "smem_bytes": ldlt.inverse_smem_bytes(k)}
    say("parity", f"ldlt_inverse at the dist batch's first-epoch KKTs: "
                  f"{results['ldlt_inverse']}")


def check_factor_against_f64(name, Fk, dk, M32):
    """The LDL^T factor kernel's (F upper triangle, d) against the plain
    factor in float64, per lane: its relative error may be at most
    F64_RATIO times the plain float32 factor's (or below F64_FLOOR), over
    the lanes whose plain factors are finite."""
    import torch
    from polympc_torch.ops import ldlt
    Fp, dp = ldlt.ldlt_factor_plain(M32)
    F64, d64 = ldlt.ldlt_factor_plain(M32.double())
    K = M32.shape[-1]
    upper = torch.triu(torch.ones(K, K, dtype=torch.bool,
                                  device=M32.device), 1)
    flat = lambda F, d: torch.cat([F[:, upper], d], 1).double()
    k, p, r = flat(Fk, dk), flat(Fp, dp), flat(F64, d64)
    live = torch.isfinite(p).all(1) & torch.isfinite(r).all(1)
    if not torch.isfinite(k[live]).all():
        raise RuntimeError(f"{name}: non-finite kernel factor where the "
                           "plain version's is finite")
    ek = lane_rel(k[live] - r[live], r[live])
    ep = lane_rel(p[live] - r[live], r[live])
    tol = max(F64_RATIO * ep.max().item(), F64_FLOOR)
    if ek.max().item() > tol:
        raise RuntimeError(f"{name}: factor error against float64 "
                           f"{ek.max().item():.3e} > {tol:.3e} (plain "
                           f"float32: {ep.max().item():.3e})")
    return {"max_abs_err": (k[live] - p[live]).abs().max().item(),
            "kernel_rel_vs_f64": ek.max().item(),
            "plain_rel_vs_f64": ep.max().item(),
            "finite_lanes": int(live.sum())}


def run_path(name, fn, must_launch):
    """Drive one main path with the launch counts set to 0 just before it
    and read just after; raise if it never launched one of its kernels."""
    from polympc_torch.ops import _build
    _build.reset_launches()
    out = fn()
    launches = dict(_build.LAUNCHES)
    for k in must_launch:
        if launches[k] <= 0:
            raise RuntimeError(f"{name} path never launched kernel {k}")
    say(name, f"launches {launches}")
    return out, launches


def phase_kite(ref, card, dev):
    from polympc_torch.headline import run
    (extra, lanes), launches = run_path(
        "kite", lambda: run(B=ref["x0s"].shape[0], device=dev, reps=3,
                            x0s=ref["x0s"]),
        ("bbt_epoch", "ldlt_factor_solve", "ldlt_solve"))
    res = lanes["residual"]
    if res.shape != ref["residual"].shape or not np.isfinite(res).all():
        raise RuntimeError("kite path: residuals of the wrong shape or "
                           "non-finite")
    mine, theirs = lanes["certified"], ref["certified"].astype(bool)
    extra["certified_solves_per_s"] = extra["solved"] / \
        extra["wall_s_per_batch"]
    say("kite", f"{card}: certified {extra['solved']}/{extra['batch']}, "
                f"status_solved {extra['status_solved']}, "
                f"kkt_residual_max {extra['kkt_residual_max']}, "
                f"mean_sqp_iters {extra['mean_sqp_iters']}, "
                f"wall_s_per_batch {extra['wall_s_per_batch']:.4f}, "
                f"certified solves/s {extra['certified_solves_per_s']:.1f}")
    say("kite", f"reference certifies {int(theirs.sum())}; common "
                f"{int((mine & theirs).sum())}; port only "
                f"{np.nonzero(mine & ~theirs)[0].tolist()}; reference only "
                f"{np.nonzero(~mine & theirs)[0].tolist()}; lanes whose "
                f"status differs: "
                f"{int((lanes['status'] != ref['status']).sum())}")
    if extra["solved"] < int(theirs.sum()) - CERTIFY_SLACK:
        raise RuntimeError(f"kite path certifies {extra['solved']}, fewer "
                           f"than the reference's {int(theirs.sum())} - "
                           f"{CERTIFY_SLACK}")
    return launches


def phase_spline(rec, card, dev):
    import torch
    from polympc_torch import headline_table as ht
    from polympc_torch.qp import box_admm_solve
    (res, lanes), launches = run_path(
        "spline", lambda: ht.spline_qp(dev, batch=4096, reps=50,
                                       batch_reps=10), ("admm_epoch",))
    want = int((rec["spline_status"] == 1).sum())
    # B=1 through the kernel and through the LU epoch, timed alike, for the
    # choice of a solo path
    qp, _ = ht.spline_batch(1, dev)
    b1 = {k: cuda_ms(lambda: box_admm_solve(
        qp, settings=ht.spline_settings(k)), reps=50) for k in ("kernel",
                                                                 "lu")}
    res["latency_ms_median_kernel_epoch"] = b1["kernel"]
    res["latency_ms_median_lu_epoch"] = b1["lu"]
    say("spline", f"{card}: {res}")
    say("spline", f"JAX record ({rec['spline_kkt_solver']} epoch) solves "
                  f"{want}; lanes whose status differs "
                  f"{int((lanes['status'] != rec['spline_status']).sum())}; "
                  f"B=1 median of 50: kernel epoch {b1['kernel']:.3f} ms, "
                  f"LU epoch {b1['lu']:.3f} ms")
    if res["batch_solved"] != want:
        raise RuntimeError(f"spline QP solves {res['batch_solved']}, the "
                           f"JAX record {want}")
    if not torch.isfinite(torch.as_tensor(lanes["iters"])).all():
        raise RuntimeError("spline QP: non-finite iteration counts")
    return res, launches


def phase_frame(rec, card, dev):
    from polympc_torch import headline_table as ht
    (res, lanes), launches = run_path(
        "frame", lambda: ht.frame_transform(dev, batch=4096, reps=50,
                                            batch_reps=10), ())
    err = np.abs(rec["frame_s"] - rec["frame_s_true"])
    want = int((err < 1e-3).sum())
    say("frame", f"{card}: {res}")
    say("frame", f"JAX record: within 1e-3 {want}, max error "
                 f"{err.max():.3e}; port vs record max |ds| "
                 f"{np.abs(lanes['s'] - rec['frame_s']).max():.3e}")
    if res["batch_solved"] != want or not np.isfinite(lanes["s"]).all():
        raise RuntimeError(f"frame transform solves {res['batch_solved']}, "
                           f"the JAX record {want}")
    return res, launches


def phase_race_car(rec, card, dev):
    from polympc_torch import headline_table as ht
    (res, lanes), launches = run_path(
        "race_car", lambda: ht.race_car(dev, batch=512, reps=10,
                                        batch_reps=3),
        ("bbt_epoch", "ldlt_factor_solve", "ldlt_solve"))
    mine, theirs = lanes["certified"], rec["race_certified"].astype(bool)
    say("race_car", f"{card}: {res}")
    say("race_car", f"JAX record certifies {int(theirs.sum())} (status "
                    f"solved {int((rec['race_status'] == 1).sum())}, warm "
                    f"iters {int(rec['race_warm_iters'])}); common "
                    f"{int((mine & theirs).sum())}; port only "
                    f"{np.nonzero(mine & ~theirs)[0].tolist()}; record only "
                    f"{np.nonzero(~mine & theirs)[0].tolist()}; lanes whose "
                    f"status differs "
                    f"{int((lanes['status'] != rec['race_status']).sum())}")
    if not np.isfinite(lanes["residual"]).all():
        raise RuntimeError("race car: non-finite certified residuals")
    if res["batch_certified_1e-6"] < int(theirs.sum()) - CERTIFY_SLACK:
        raise RuntimeError(f"race car certifies "
                           f"{res['batch_certified_1e-6']}, fewer than the "
                           f"record's {int(theirs.sum())} - {CERTIFY_SLACK}")
    return res, launches


def compare_dist(drec, pre, lanes, tag):
    """Print one route's lanes beside the JAX record of the same route
    (``pre`` "" for "lu", "pallas_" for the kernel route) and raise if it
    certifies more than DIST_SLACK lanes fewer."""
    res = lanes["residual"]
    if res.shape != drec[pre + "residual"].shape or \
            not np.isfinite(res).all():
        raise RuntimeError(f"dist path ({tag}): residuals of the wrong shape "
                           "or non-finite")
    mine, theirs = lanes["certified"], drec[pre + "certified"].astype(bool)
    route = pre.rstrip("_") or "lu"
    say("dist_kite_s8", f"{tag}: certified {int(mine.sum())}, status solved "
                        f"{int((lanes['status'] == 1).sum())}, mean iters "
                        f"{lanes['iters'].mean():.4f}; JAX record ({route} "
                        f"route) certifies {int(theirs.sum())}, status "
                        f"solved {int((drec[pre + 'status'] == 1).sum())}, "
                        f"mean iters {drec[pre + 'iters'].mean():.4f}; "
                        f"common {int((mine & theirs).sum())}; port only "
                        f"{np.nonzero(mine & ~theirs)[0].tolist()}; record "
                        f"only {np.nonzero(~mine & theirs)[0].tolist()}; "
                        f"lanes whose status differs "
                        f"{int((lanes['status'] != drec[pre + 'status']).sum())}")
    if mine.sum() < int(theirs.sum()) - DIST_SLACK:
        raise RuntimeError(f"dist path ({tag}) certifies {int(mine.sum())}, "
                           f"fewer than the record's {int(theirs.sum())} - "
                           f"{DIST_SLACK}")


def dist_lu_route(drec, dev):
    """The same lanes through the "lu" route (torch.linalg.inv): held
    against the record's "lu" fields, beside the kernel route against its
    "pallas" fields, it shows how much of a status difference is the
    route's float32 rounding."""
    import torch
    from polympc_torch import dist_point as dp
    from polympc_torch.parallel.multihost import make_batch_dist_solver
    dtr, bounds, settings = dp.dist_problem(dev, torch.float32, "lu")
    x0 = torch.as_tensor(drec["x0s"], dtype=torch.float32, device=dev)
    W0, P0 = dtr.rollout_guess(x0, d=dp.D)
    out = make_batch_dist_solver(dtr, bounds, settings, d=dp.D)(x0, W0, P0)
    return dp.summarize(out, dp.certify(dtr, bounds, x0, out))


def phase_dist(drec, card, dev):
    from polympc_torch import dist_point as dp
    B = drec["x0s"].shape[0]
    (extra, lanes), launches = run_path(
        "dist_kite_s8", lambda: dp.run(B, dev, x0s=drec["x0s"]),
        ("ldlt_inverse",))
    b1 = extra.pop("b1")
    extra["certified_solves_per_s"] = extra["certified"] / \
        extra["wall_s_per_batch"]
    say("dist_kite_s8", f"{card}: {extra}")
    compare_dist(drec, "pallas_", lanes, "kernel route")
    lu, lu_lanes = dist_lu_route(drec, dev)
    compare_dist(drec, "", lu_lanes, "lu route")
    say("dist_kite_s8", f"lanes whose status differs between the port's "
                        f"two routes {int((lu_lanes['status'] != lanes['status']).sum())}, "
                        f"between the record's two routes "
                        f"{int((drec['status'] != drec['pallas_status']).sum())}")
    say("dist_kite_s8", f"B=1 (x0 {dp.B1_X0}), solve wall after a short "
                        f"warm-up: lu {b1['lu']}, kernel {b1['kernel']}; "
                        f"JAX record lu: status {int(drec['b1_status'])}, "
                        f"iters {int(drec['b1_iters'])}, violation "
                        f"{float(drec['b1_violation']):.3e}; pallas: status "
                        f"{int(drec['b1_pallas_status'])}, iters "
                        f"{int(drec['b1_pallas_iters'])}, violation "
                        f"{float(drec['b1_pallas_violation']):.3e}")
    for r, v in b1.items():
        if not np.isfinite(v["violation"]):
            raise RuntimeError(f"dist B=1 ({r}): non-finite violation")
    return extra, launches


KERNELS = (
    ("bbt_epoch", "polympc_torch/csrc/bbt_epoch.cu",
     "polympc_tpu/ops/bbt_kernel.py:473"),
    ("bbt_solve", "polympc_torch/csrc/bbt_epoch.cu",
     "polympc_tpu/ops/bbt_kernel.py:635"),
    ("ldlt_factor_solve", "polympc_torch/csrc/ldlt.cu",
     "polympc_tpu/ops/ldlt.py:355"),
    ("ldlt_solve", "polympc_torch/csrc/ldlt.cu",
     "polympc_tpu/ops/ldlt.py:328"),
    ("ldlt_factor", "polympc_torch/csrc/ldlt.cu",
     "polympc_tpu/ops/ldlt.py:315"),
    ("admm_epoch", "polympc_torch/csrc/admm_epoch.cu",
     "polympc_tpu/ops/admm_epoch.py:151"),
    ("ldlt_inverse", "polympc_torch/csrc/ldlt.cu",
     "polympc_tpu/ops/ldlt.py:344"),
)


def main():
    import torch
    card, smi = phase_device()
    import_port()
    ref = dict(np.load(REFERENCE))
    rec = dict(np.load(HEADLINE_REFERENCE))
    drec = dict(np.load(DIST_REFERENCE))
    phase_build()
    parity = phase_parity(ref, "cuda")
    phase_parity_dense("cuda", parity)
    phase_parity_race_car("cuda", parity)
    phase_parity_dist(drec, "cuda", parity)
    paths = {"kite": phase_kite(ref, smi, "cuda"),
             "spline_qp": phase_spline(rec, smi, "cuda")[1],
             "frame_transform": phase_frame(rec, smi, "cuda")[1],
             "race_car": phase_race_car(rec, smi, "cuda")[1],
             "dist_kite_s8": phase_dist(drec, smi, "cuda")[1]}
    kernels = []
    for n, src, rep in KERNELS:
        by_path = {p: c[n] for p, c in paths.items() if c[n]}
        kernels.append({"name": n, "route": "cuda", "source": src,
                        "replaces": rep, "launches": sum(by_path.values()),
                        "launches_by_path": by_path, **parity[n]})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
