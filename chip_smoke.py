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
     the kite's and the race car's shapes, the dense epoch at one, two and
     four instances (warps) a block; each LDL^T kernel's and the dense
     epoch's launch (block size, shared memory, blocks an SM by the
     occupancy API and by the shared memory alone); at the CSTR batch's
     shape the BBT epoch on its first epoch, and the epoch's fit rule in
     Python (bbt_kernel_fits) against the kernel's own on seven
     structures; the dense epoch also at admm_solve's first epoch of the
     stacked spline QP (B=4096, n=32, m=47, K=79) and at the MS kite
     batch's first epoch (B=512, n=75, m=50, K=125), and the LDL^T
     factor-solve and solve at K=125 on diagonally dominant matrices;
  4. main paths, each with the launch counts set to 0 just before it and
     read just after (the LDL^T kernels on every path's certify matrices by
     one residual gate, every lane, raising: refine_checks):
       kite: bench.py's certified kite batch (B=512), one warm-up then the
         median wall of 3 repetitions, against the JAX package's record
         (tests/data/kite_b512_jax_cpu.npz);
       the reference's headline table (polympc_torch/headline_table.py)
       against the JAX package's record (tests/data/headline_jax_cpu.npz):
       spline-fitting QP (B=4096, and B=1 beside the LU epoch), frame
       transform (B=4096, and B=1), race car (B=512 with the fp64 certify,
       2 repetitions, and the B=1 warm re-solve, 5 repetitions);
       dist_kite_s8: the horizon-partitioned SQP (polympc_torch/
       dist_point.py: kite, Chebyshev(5) x 8 segments, B=128, fp64
       certify), a small warm-up then one timed batch through the kernel
       route, and its B=1 point through the "lu" and the kernel route;
       then, outside the counts, the same batch through the "lu" route;
       each route against the JAX package's record of the same route
       (tests/data/dist_kite_s8_jax_cpu.npz);
       dist_sharded: the same batch through make_batch_dist_solver on a
       ("dp", "seg") mesh of one rank in a one-rank NCCL group (segment
       sharding over torch.distributed; kernel 6 in the sharded Schur
       factor), held per lane against the dist_kite_s8 batch of this call
       and, certified by dist_refine on the mesh, against the record; with
       more than one card also the dry run over every card
       (polympc_torch/multichip_point.py);
       cstr_b256: the CSTR batch of BASELINE config 3
       (polympc_torch/cstr_point.py: B=256, fp32 SQP through the BBT epoch,
       fp64 certify) after a B=8 warm-up, against the JAX package's record
       of its "lu" route (tests/data/cstr_b256_jax_cpu.npz); then, outside
       the counts, its first 16 lanes through the port's "lu" route; after
       the path, the LDL^T kernels on its certify matrices (K=110);
       mpc: the MPC facade in float64 (no kernel): the robot quick start
       with default settings and its warm re-solve, the CSTR with
       block-BFGS, and the closed loop of examples/cstr_nmpc.py;
       the solver layer (polympc_torch/solvers_point.py) against the JAX
       package's record (tests/data/solvers_jax_cpu.npz):
       kite_ip_b512: bench's kite batch through the float64 interior
         point after a B=8 warm-up (no kernel);
       mpc_ip: MPC(solver="ip") on the robot quick start beside the SQP
         route, its warm re-solve and 10 more (float64, no kernel);
       qp_solvers: the spline QPs (B=4096) through the interior point
         (float64), admm_solve in float32 on the dense epoch kernel (K=79),
         the active set on the host (the first 256 lanes) and the VJP of
         box_admm_solve (float32 forward through the kernel);
       lqr: BASELINE config 2, the quadrotor at B=1 (mean of 50) and at
         B=4096 linearisation points, against scipy (float64, no kernel);
       nlp_extras: psarc, the trust region, projected gradient and a
         projection, one float64 call each with the JAX tests' oracles;
       slice 4 (polympc_torch/ocp_extras_point.py) against the JAX
       package's record (tests/data/ocp_extras_jax_cpu.npz):
       kite_ms_b512: bench's kite by multiple shooting (B=512, fp32 SQP
         with its inner QPs on the dense epoch kernel at K=125, bench's
         fp64 certify), a B=8 warm-up then the median of 3 batches; after
         the path, the LDL^T kernels on its certify matrices (K=125);
       ocp_extras: the robot by multiple shooting and with soft defects,
         Radau against Lobatto on a stiff OCP, a trajectory-hook rate
         bound, identify, and the adaptive and pseudospectral integrators,
         one float64 call each with the JAX tests' oracles;
       horizon_sweep (polympc_torch/scaling_point.py, the twin of
         benchmarks/scaling.py): the kite on Chebyshev(5) x S for S = 2,
         4, 8, 16 at B = max(128, 1024 // S), each S through the dense and
         the BBT epoch where its fit rule holds (else a skipped row) and,
         where neither fits (S=16), the solver's own route (the LU epoch);
         each row after a warm-up (median of 3 at S <= 4, one at S >= 8)
         with bench's fp64 certify, its certified count against the JAX
         record of the same S (tests/data/scaling_jax_cpu.npz), and each
         row's own launches read around it, which must show the row's
         route (its epoch kernel, or none for the LU epoch, and the LDL^T
         kernels in its certify exactly at K <= 206); after the path, the
         measured epoch kernels (20 back to back), kernel 1 at S=4 and
         S=8, kernel 7 at K=252 on the rows' first epochs and the LDL^T
         kernels on the S=4 certify's matrices (K=252);
       long_horizon (polympc_torch/long_horizon_point.py): the
         partitioned full-space Newton engine (parallel/long_horizon.py)
         on the damped pendulum, S=512 Chebyshev(4) segments of 0.5 s,
         B=32 lanes, 12 float64 Newton steps (no kernel: the segment
         blocks by torch.func, the Schur interface solve by
         torch.linalg.solve), a warm-up then the median of 3 solves and
         one more split by CUDA events into the segment blocks and the
         interface solve, against the JAX package's record
         (tests/data/long_horizon_jax_cpu.npz): every lane's final defect
         <= 1e-7 and continuity <= 1e-10, the boundary states of every
         lane and the whole Z of lanes 0-1 within 1e-7; then one Newton
         step of lanes 0-3 on horizon_mesh(1) in a one-rank NCCL group,
         equal bit for bit to the mesh-less step;
     and, outside every path's count, the lane-major LDL^T entry points
     (ldlt_*_lanes, the JAX package's (K, K, B) layout) bit for bit
     against the batch-first calls at K=132, B=512;
  5. a JSON line of the kernels, then the result line
     {"ok": true, "device": {...}}.

Needs one card; imports nothing of JAX.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
REFERENCE = os.path.join(ROOT, "tests", "data", "kite_b512_jax_cpu.npz")
HEADLINE_REFERENCE = os.path.join(ROOT, "tests", "data",
                                  "headline_jax_cpu.npz")
CSTR_REFERENCE = os.path.join(ROOT, "tests", "data",
                              "cstr_b256_jax_cpu.npz")
DIST_REFERENCE = os.path.join(ROOT, "tests", "data",
                              "dist_kite_s8_jax_cpu.npz")
SOLVERS_REFERENCE = os.path.join(ROOT, "tests", "data",
                                 "solvers_jax_cpu.npz")
OCP_EXTRAS_REFERENCE = os.path.join(ROOT, "tests", "data",
                                    "ocp_extras_jax_cpu.npz")
LONG_HORIZON_REFERENCE = os.path.join(ROOT, "tests", "data",
                                      "long_horizon_jax_cpu.npz")
SCALING_REFERENCE = os.path.join(ROOT, "tests", "data",
                                 "scaling_jax_cpu.npz")

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
# uses instead, the relative residual ||M x - b|| / ||b|| (in float64), by
# one rule on every path and every lane (residual_gate): a lane passes
#   (a) where the kernel's residual is at most 10x the plain float32
#       version's, or below 1e-5; or
#   (b) where the kernel's factor equals the plain factor bit for bit and
#       its residual is at most 10x that of the float64 substitution on
#       that float32 factor: this holds the one part the kernel adds beyond
#       the factor, its substitution, against exact arithmetic.  Where the
#       factor pivots on the certify's 1e-6 regularisation (every lane of
#       the kite by multiple shooting) the plain float32 residual is
#       rounding luck, so (a) alone would hold the kernel against luck
#       (MS lane 310 on the card: kernel 6.208677e-4, plain 2.851318e-5,
#       float64 substitution 6.208675e-4; the CPU's plain solve of it
#       2.3e-3).
# A lane passing neither raises.  A lane whose plain float32 residual is
# above 1e-3 is dominated by the factor's growth, not by the kernel (both
# answers are then mostly rounding): such lanes are counted and left out
# of the test.  The certify pass repairs them with refinement sweeps in
# float64 residuals.  The factor kernel alone is held there on its factor
# against the plain version in float64 (the F64_RATIO rule above) and on
# the residual of its factor solved by the solve kernel.
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
# the CSTR batch (B=256): SOLVED and certified counts at least the record's
# less 2% of B; on the lanes SOLVED in both, the median relative cost
# difference within CSTR_COST_RTOL.  Not every such lane: in float32 about
# a quarter of the lanes stop SOLVED 20-30% above the optimum (certify
# residual 1e6-1e9) in either package and through either KKT route, and
# which lanes do is chaotic (the JAX package's own "lu" and "pallas"
# routes part so on lane 7 of 8 at B=8; PERF.md §6)
CSTR_SLACK = 5
CSTR_COST_RTOL = 1e-3
CSTR_LU_LANES = 16
# The solver layer's paths (polympc_torch/solvers_point.py) against the JAX
# record (tests/data/solvers_jax_cpu.npz).  The kite through the interior
# point (B=512, float64): SOLVED at least the record's less 10 (2% of B),
# and on the lanes SOLVED in both the cost within 1e-6 relative (Ipopt's
# tolerance; both packages stop at the same optimum).
KITE_IP_SLACK = 10
KITE_IP_COST_RTOL = 1e-6
# MPC(solver="ip") on the robot: x within 1e-3 of the SQP route (the JAX
# test's tolerance).
MPC_IP_X_ATOL = 1e-3
# The spline QPs: the interior point (float64) solves as many lanes as the
# record, x within 1e-6 of it on the stored lanes.  admm_solve (float32,
# through the dense epoch kernel at K=79) SOLVED at least the record's
# less 41 (1% of B); on the lanes SOLVED there and by the interior point,
# ||x - x_ip||_inf / (1 + ||x_ip||_inf) within ADMM_X_RTOL on at least
# 99% of them: the ADMM stops at eps_abs = eps_rel = 1e-4, and the float32
# plain version on the CPU stays within 5e-5 (B=32), so 1e-3 rather than
# 1e-2.  The active set (host, the first 256 lanes): every lane SOLVED, x
# within 1e-6 of the interior point.  The VJP (float32 forward through the
# kernel) against the float64 record: median per-lane relative error of
# the cotangents at most 1e-3 (the float32 plain version on the CPU: 1e-6).
QP_IP_X_ATOL = 1e-6
ADMM_SLACK = 41
ADMM_X_RTOL = 1e-3
ADMM_X_SHARE = 0.99
AS_X_ATOL = 1e-6
VJP_MEDIAN_RTOL = 1e-3
# LQR (BASELINE config 2): P at B=1 and on LQR_SCIPY_LANES lanes of the
# batch against scipy at tests/test_control.py's rtol 1e-5, atol 1e-7;
# the batch's CARE residual relative to ||A'P||_F + ||Q||_F at most 1e-8.
LQR_RTOL, LQR_ATOL = 1e-5, 1e-7
LQR_RES_TOL = 1e-8
LQR_SCIPY_LANES = 64
# The kite by multiple shooting (B=512, float32 SQP, float64 certify)
# against the JAX record of its "lu" route: certified and SOLVED counts at
# least the record's less 10 (2% of B), as for bench's kite.  The
# ocp_extras cases (float64) against the record: each JAX test's oracle,
# and the statuses equal and the costs within OCP_EXTRAS_COST_RTOL.
KITE_MS_SLACK = 10
OCP_EXTRAS_COST_RTOL = 1e-6
# The horizon sweep (polympc_torch/scaling_point.py): each row's certified
# count at least the JAX record's for the same S (its "lu" route) less 2%
# of B, rounded (float32 chaos; 10 lanes at B=512 as for the kite, 3 at
# B=128 as for the dist batch).  dist_sharded: the sharded batch
# against the unsharded one of the same call, per lane: statuses and SQP
# iterations equal, W within DIST_SHARDED_RTOL relative (the same
# operations, gathered; bit for bit is expected on one rank).
SWEEP_SLACK_SHARE = 0.02
DIST_SHARDED_RTOL = 1e-6
# the long-horizon batch's gates: the record's final defects reach 3.6e-8
# (the delta = 1e-8 regularisation's floor) and its continuity 1.1e-15
LH_DEFECT_TOL = 1e-7
LH_CONTINUITY_TOL = 1e-10
LH_RECORD_ATOL = 1e-7
LH_SHARDED_LANES = 4
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


def residual_gate(rk, rp, r64):
    """The residual test of the LDL^T kernels on refine matrices, lane by
    lane, for a kernel whose factor equals the plain one bit for bit: rk
    the kernel's residual, rp the plain float32 version's, r64 that of the
    float64 substitution on the plain float32 factor.  Returns the masks
    (live, passes (a), passes (b)): a lane is live where rp is at most
    LDLT_GROWTH; (a) rk <= max(LDLT_RES_RATIO x rp, LDLT_RES_FLOOR); (b) rk
    <= LDLT_RES_RATIO x r64."""
    import torch
    live = rp <= LDLT_GROWTH
    by_a = rk <= torch.clamp(LDLT_RES_RATIO * rp, min=LDLT_RES_FLOOR)
    by_b = rk <= LDLT_RES_RATIO * r64
    return live, live & by_a, live & by_b


def check_residuals(name, rk, rp, r64):
    """The residual gate (:func:`residual_gate`): raises where a live lane
    passes neither test, or where the kernel's residual is not finite and
    the plain version's is; returns the lane counts (live, passed by (a),
    by (b), by (b) alone)."""
    import torch
    if not torch.isfinite(rk[torch.isfinite(rp)]).all():
        raise RuntimeError(f"{name}: non-finite kernel residual where the "
                           "plain version's is finite")
    live, by_a, by_b = residual_gate(rk, rp, r64)
    bad = live & ~by_a & ~by_b
    if bad.any():
        lanes = bad.nonzero().flatten().tolist()
        worst = {i: (rk[i].item(), rp[i].item(), r64[i].item())
                 for i in lanes[:5]}
        raise RuntimeError(
            f"{name}: {len(lanes)} of {int(live.sum())} lanes pass neither "
            f"(a) kernel residual <= max({LDLT_RES_RATIO} x plain, "
            f"{LDLT_RES_FLOOR}) nor (b) <= {LDLT_RES_RATIO} x the float64 "
            f"substitution on the same factor; lanes {lanes[:20]}, "
            f"(kernel, plain, float64) {worst}")
    return {"gate_live": int(live.sum()), "gate_by_a": int(by_a.sum()),
            "gate_by_b": int(by_b.sum()),
            "gate_by_b_only": int((by_b & ~by_a).sum())}


def check_mirror(name, x, x_mirror):
    """The kernel's solution equal to the mirror of its own algorithm bit
    for bit, on every lane."""
    import torch
    if not torch.equal(x, x_mirror):
        bad = (x != x_mirror).any(1).nonzero().flatten().tolist()
        raise RuntimeError(f"{name}: the kernel's solution differs from "
                           f"panel_solve_mirror on lanes {bad[:20]}")
    return True


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
    from polympc_torch.nlp import sqp
    from polympc_torch.ops import bbt_kernel as bk
    from polympc_torch.ops import ldlt
    from polympc_torch.ops.structure import (
        bbt_structure, gather_blocks, permute_vec, random_bbt_kkt,
        unpermute_vec)
    from polympc_torch.parallel import pin_initial_state

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
    first = sqp.first_epoch(nlp, z0, prm, bnd, settings=settings)
    kkt = first[0]
    kite = bk.prepare_epoch(*first, st)
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


def epoch_by_threads(ae, args, kw):
    """The dense epoch's time at one, two and four instances (warps) a
    block on the same inputs."""
    return {f"{t} threads, {t // 32} instance(s) a block": cuda_ms(
        lambda: ae.admm_epoch_batched(*args, threads=t, **kw))
        for t in (32, 64, 128)}


def epoch_launch(ae, n, m):
    """The dense epoch's launch at this shape: block size, instances and
    shared memory a block, and blocks an SM by the occupancy API beside
    the shared memory's count; raises if the kernel's and the wrapper's
    shared memory disagree."""
    from polympc_torch.ops import _build
    t = ae.epoch_threads(n + m)
    smem = ae.epoch_smem_bytes(n, m, t)
    lib = _build.library()
    if lib.pt_admm_epoch_smem_bytes(n, m, t) != smem:
        raise RuntimeError("admm_epoch: the wrapper's fit rule and the "
                           "kernel's shared memory disagree")
    out = {"threads": t, "instances_per_block": t // 32, "smem_bytes": smem,
           "blocks_per_sm": lib.pt_admm_epoch_blocks_per_sm(n, m, t),
           "blocks_per_sm_by_smem": _build.blocks_per_sm(smem, t)}
    say("launch", f"admm_epoch n={n} m={m}: {out}")
    return out


def ldlt_designed_blocks(K):
    """Blocks an SM the LDL^T kernels' launch bounds are built for at K
    (``min_blocks`` in csrc/ldlt.cu, by 32-row register chunks): six up to
    K=160 (40 registers a thread at 256 threads), four up to 192, two
    above."""
    tc = -(-K // 32)
    return 6 if tc <= 5 else 4 if tc == 6 else 2


def ldlt_launch(which, K):
    """An LDL^T kernel's launch at K (which: 0 ldlt_factor, 1
    ldlt_factor_solve, 2 ldlt_solve): 256 threads, the shared memory and
    blocks an SM by the occupancy API; raises if the kernel's and the
    wrapper's shared memory disagree, or if the occupancy API holds fewer
    blocks than both the shared memory and the launch bounds' design
    (:func:`ldlt_designed_blocks`) do: registers would then limit it
    below what the kernels are built for.  (At K=110 the shared memory
    alone would hold eight blocks; the launch bounds hold six.)"""
    from polympc_torch.ops import _build
    from polympc_torch.ops import ldlt
    smem = ldlt.ldlt_smem_bytes(K)
    lib = _build.library()
    if lib.pt_ldlt_smem_bytes(K) != smem:
        raise RuntimeError(f"ldlt at K={K}: the wrapper's fit rule and the "
                           "kernel's shared memory disagree")
    out = {"threads": ldlt._THREADS, "smem_bytes": smem,
           "blocks_per_sm": lib.pt_ldlt_blocks_per_sm(which, K),
           "blocks_per_sm_by_smem": _build.blocks_per_sm(smem,
                                                         ldlt._THREADS),
           "blocks_per_sm_by_design": ldlt_designed_blocks(K)}
    say("launch", f"{('ldlt_factor', 'ldlt_factor_solve', 'ldlt_solve')[which]}"
                  f" K={K}: {out}")
    if out["blocks_per_sm"] < min(out["blocks_per_sm_by_smem"],
                                  out["blocks_per_sm_by_design"]):
        raise RuntimeError(f"ldlt at K={K}: the occupancy API holds fewer "
                           "blocks an SM than the shared memory and the "
                           "launch bounds do")
    return out


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
    from polympc_torch.qp.box_admm import first_epoch
    from polympc_torch.qp.types import QPData
    rng = np.random.default_rng(11)
    qs = ht.spline_settings()
    _, big = ht.spline_batch(4096, dev)
    spline = first_epoch(big, settings=qs)
    B, n = big.h.shape
    m = big.al.shape[1]
    kw = dict(sigma=qs.sigma, alpha=qs.alpha, iters=qs.check_every)
    kern, plain = epoch_fns(**kw)
    err = check_against_f64("admm_epoch", kern, plain, spline, ())
    for nn, mm in ((32, 15), (77, 55), (47, 0)):
        case = random_dense_epoch(nn, mm, 512, rng, dev)
        rel = check_tight("admm_epoch", kern, plain, case, (), EPOCH_RTOL)
        say("parity", f"admm_epoch random quasi-definite B=512 n={nn} "
                      f"m={mm}: rel {rel:.2e} (tol {EPOCH_RTOL})")
    by_threads = epoch_by_threads(ae, spline, kw)
    k132 = random_dense_epoch(77, 55, 512, rng, dev)
    results["admm_epoch"] = {
        **err, **timing(lambda: kern(*spline), lambda: plain(*spline), None,
                        bound_admm_epoch(B, n, m, qs.check_every)),
        "shape": f"B={B} n={n} m={m} iters={qs.check_every}",
        "launch": epoch_launch(ae, n, m),
        "ms_by_threads": by_threads,
        "ms_by_threads_K132_B512": epoch_by_threads(ae, k132, kw),
        "launch_K132": epoch_launch(ae, 77, 55)}
    say("parity", f"admm_epoch at the spline QP's first scaled epoch "
                  f"B={B} K={n + m}: {results['admm_epoch']}")
    # admm_solve's stacked QP ([I; A]: m=47, K=79) at its first epoch, as
    # the qp_solvers path runs it
    eye = torch.eye(n, device=dev).expand(B, n, n)
    inf = torch.full((B, n), float("inf"), device=dev)
    stacked = first_epoch(
        QPData(big.H, big.h, torch.cat([eye, big.A], 1),
               torch.cat([big.xl, big.al], 1),
               torch.cat([big.xu, big.au], 1), -inf, inf), settings=qs)
    m2 = m + n
    k79 = {**check_against_f64("admm_epoch (stacked)", kern, plain,
                               stacked, ()),
           **timing(lambda: kern(*stacked), lambda: plain(*stacked), None,
                    bound_admm_epoch(B, n, m2, qs.check_every)),
           "shape": f"B={B} n={n} m={m2} iters={qs.check_every}",
           "launch": epoch_launch(ae, n, m2)}
    results["admm_epoch"]["stacked_K79"] = k79
    say("parity", f"admm_epoch at admm_solve's first scaled epoch of the "
                  f"stacked spline QP B={B} K={n + m2}: {k79}")

    for K in (132, 165):
        A, _ = diag_dominant(512, K, rng, dev)
        # the upper triangle (d on its diagonal) and d: the kernel's strict
        # lower triangle is zero, the plain version's the recurrence's
        # scratch, and no caller reads it
        upper = torch.triu(torch.ones(K, K, dtype=torch.bool, device=dev))
        flat = lambda F, d: torch.cat([F[:, upper], d], 1)
        rel = check_tight("ldlt_factor", lambda M: flat(*ldlt.ldlt_factor(M)),
                          lambda M: flat(*ldlt.ldlt_factor_plain(M)), (A,),
                          (), LDLT_RTOL)
        say("parity", f"ldlt_factor random diagonally dominant B=512 K={K}: "
                      f"F's upper triangle and d rel {rel:.2e} (tol "
                      f"{LDLT_RTOL})")


def cstr_first_epoch(x0s, dev):
    """The CSTR batch's first boxADMM epoch as the path runs it
    (``nlp.sqp.first_epoch``: the transcription's guess with each lane's
    x0 pinned, zero multipliers, the QP Ruiz-equilibrated as
    ``box_admm_solve`` does); returns (settings.qp, epoch inputs)."""
    import torch
    from polympc_torch import cstr_point as cp
    from polympc_torch.nlp import sqp
    from polympc_torch.ops import bbt_kernel as bk
    from polympc_torch.parallel import pin_initial_state
    tr, bounds, prm, settings = cp.cstr_problem(dev)
    x0 = torch.as_tensor(x0s, dtype=torch.float32, device=dev)
    bnd, x0sc = pin_initial_state(tr, bounds, x0)
    z = tr.initial_guess(dtype=torch.float32, device=dev)[None].repeat(
        x0.shape[0], 1)
    z[:, :tr.ocp.nx] = x0sc
    qs = settings.qp
    return qs, bk.prepare_epoch(
        *sqp.first_epoch(tr.nlp, z, prm, bnd, settings=settings),
        qs.structure)


def check_bbt_fit_rule():
    """The BBT epoch's fit rule in Python (``bbt_kernel.bbt_kernel_fits``,
    ``epoch_smem_bytes``) against the kernel's own (its shared-memory
    count, and the blocks an SM the occupancy API places at 128 and 256
    threads) on the main paths' structures and on three at the rule's
    edges; raises where they disagree."""
    from polympc_torch.headline import kite_problem
    from polympc_torch.ops import _build
    from polympc_torch.ops import bbt_kernel as bk
    from polympc_torch.ops.structure import bbt_structure
    lib = _build.library()
    cases = {"kite": kite_problem("cpu")[3].qp.structure,
             "bordered": bbt_structure(11, 5, 2, 0, 2, 0, 5, 2),
             "race_car": bbt_structure(11, 6, 3, 0, 0, 0, 5, 2),
             "cstr": bbt_structure(11, 4, 2, 0, 0, 0, 5, 2),
             "S=1 k=192": bbt_structure(6, 15, 2, 0, 0, 0, 5, 1),
             "S=1 k=200": bbt_structure(7, 13, 2, 0, 0, 0, 6, 1),
             "S=2 k=168": bbt_structure(11, 12, 3, 0, 0, 0, 5, 2)}
    out = {}
    for name, st in cases.items():
        key = (st.S, st.k, st.nx, st.a)
        smem = bk.epoch_smem_bytes(st)
        if lib.pt_bbt_epoch_smem_bytes(*key) != smem:
            raise RuntimeError(f"bbt_epoch ({name}): the wrapper's shared "
                               "memory count and the kernel's disagree")
        blocks = {t: lib.pt_bbt_epoch_blocks_per_sm(*key, t)
                  for t in bk._THREADS}
        fits = bk.bbt_kernel_fits(st)
        if fits != any(blocks.values()) or \
                bk._fitting_threads(st) != [t for t in bk._THREADS
                                            if blocks[t]]:
            raise RuntimeError(f"bbt_epoch ({name}): bbt_kernel_fits says "
                               f"{fits}, the kernel places {blocks} blocks "
                               "an SM at 128/256 threads")
        out[name] = {"S": st.S, "k": st.k, "smem_bytes": smem,
                     "blocks_per_sm": blocks, "fits": fits}
    say("launch", f"bbt_epoch fit rule (Python = kernel): {out}")
    return out


def phase_parity_cstr(crec, dev, results):
    """The BBT epoch at the CSTR batch's shape (B=256, S=2 blocks of k=64,
    25 iterations): on the path's own first epoch by the F64 rule, on
    random quasi-definite KKTs in its pattern against the plain version
    and the mirror; and the fit rule's Python formulas against the
    kernel's."""
    from polympc_torch.ops import bbt_kernel as bk
    rng = np.random.default_rng(19)
    fit = check_bbt_fit_rule()
    qs, epoch = cstr_first_epoch(crec["x0s"], dev)
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
    say("parity", f"bbt_epoch random quasi-definite CSTR S={st.S} k={st.k}: "
                  f"rel {rel:.2e} (tol {EPOCH_RTOL}); against its mirror "
                  f"{relm:.2e} (tol {MIRROR_RTOL})")
    results["bbt_epoch"]["cstr"] = {
        **err, **timing(lambda: bk.bbt_epoch(*epoch, st, *ep),
                        lambda: bk.bbt_epoch_plain(*epoch, st, *ep), None,
                        bound_bbt_epoch(st, B, qs.check_every)),
        **by_threads(bk, epoch, st, ep),
        "random_rel_vs_plain": rel, "random_rel_vs_mirror": relm,
        "fit_rule": fit,
        "shape": f"B={B} S={st.S} k={st.k} nx={st.nx} "
                 f"iters={qs.check_every}"}
    say("parity", f"bbt_epoch at the CSTR batch's first epoch: "
                  f"{results['bbt_epoch']['cstr']}")


def phase_parity_cstr_refine(crec, lanes, dev, results):
    """The LDL^T kernels on the CSTR certify's Newton-KKT matrices (K=110)
    at the path's fp32 solution, by the residual test (run after the
    path, from its solution: the batch is not solved twice)."""
    import torch
    from polympc_torch import cstr_point as cp
    from polympc_torch.nlp.refine import newton_system
    from polympc_torch.parallel import pin_initial_state
    tr, bounds, _, _ = cp.cstr_problem(dev)
    x0 = torch.as_tensor(crec["x0s"], dtype=torch.float64, device=dev)
    prm64 = tr.params(t0=0.0, tf=cp.TF, dtype=torch.float64, device=dev)
    b64 = bounds._replace(**{f: getattr(bounds, f).double()
                             for f in bounds._fields})
    bnd64, _ = pin_initial_state(tr, b64, x0)
    f32 = lambda k: torch.as_tensor(lanes[k], dtype=torch.float32,
                                    device=dev)
    Ms, rs = newton_system(tr.nlp, f32("x"), f32("lam"), bnd64, prm64,
                           matrix_dtype=torch.float32)
    M32, r32 = Ms.float().contiguous(), rs.float().contiguous()
    B, K = r32.shape
    out = refine_checks(Ms, M32, r32)
    for name in ("ldlt_factor_solve", "ldlt_solve", "ldlt_factor"):
        results[name]["cstr"] = {**out[name], "shape": f"B={B} K={K}"}
        say("parity", f"{name} at the CSTR certify's refine matrices B={B} "
                      f"K={K}: {out[name]}")


def race_car_inputs(dev):
    """The race car's main-path inputs on the card: the first boxADMM epoch
    of the warm-started batch (B=512, S=2 blocks of k=96) and the certify's
    Newton-KKT matrices (K=165) at the batch's fp32 solution."""
    import torch
    from polympc_torch import headline_table as ht
    from polympc_torch.nlp import sqp
    from polympc_torch.nlp.refine import newton_system
    from polympc_torch.ops import bbt_kernel as bk
    from polympc_torch.parallel import pin_initial_state
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
    epoch = bk.prepare_epoch(
        *sqp.first_epoch(nlp, z, prm, bnd, lam, lam_box, settings=warm),
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
    plain version through the residual gate (:func:`check_residuals`, every
    lane, raising) and against the mirror of the kernels' algorithm bit for
    bit, their factors against the plain factor bit for bit, with their
    times."""
    import torch
    from polympc_torch.ops import ldlt
    B, K = r32.shape
    rs = r32.double()
    out = {}
    launch = {name: ldlt_launch(which, K) for which, name in enumerate(
        ("ldlt_factor", "ldlt_factor_solve", "ldlt_solve"))}
    xk, Fk, dk = ldlt.ldlt_factor_solve(M32, r32)
    xp, Fp, dp = ldlt.ldlt_factor_solve_plain(M32, r32)
    xm = ldlt.panel_solve_mirror(Fp, dp, r32)
    # the float64 substitution on the plain float32 factor: test (b)
    r64 = rel_residual(Ms, ldlt.ldlt_solve_plain(Fp.double(), dp.double(),
                                                 rs), rs)
    sync()
    same_factor("ldlt_factor_solve", Fk, dk, Fp, dp)
    rk, rp = rel_residual(Ms, xk, rs), rel_residual(Ms, xp, rs)
    held = check_residuals("ldlt_factor_solve", rk, rp, r64)
    out["ldlt_factor_solve"] = {
        "max_abs_err": (xk - xp).abs().max().item(), **held,
        "equals_mirror": check_mirror("ldlt_factor_solve", xk, xm),
        "res_kernel_max": rk.max().item(), "res_plain_max": rp.max().item(),
        "growth_lanes": int((rp > LDLT_GROWTH).sum()),
        **timing(lambda: ldlt.ldlt_factor_solve(M32, r32),
                 lambda: ldlt.ldlt_factor_solve_plain(M32, r32),
                 library_ms("ldlt_factor_solve",
                            lambda: torch.linalg.solve(M32, r32)),
                 bound_ldlt("factor_solve", B, K)),
        "launch": launch["ldlt_factor_solve"]}
    sk = ldlt.ldlt_solve(Fp, dp, r32)
    sp = ldlt.ldlt_solve_plain(Fp, dp, r32)
    sync()
    rk, rp = rel_residual(Ms, sk, rs), rel_residual(Ms, sp, rs)
    held = check_residuals("ldlt_solve", rk, rp, r64)
    ldl_solve = ldl_solve_library(Fp, dp, r32, sp)
    out["ldlt_solve"] = {
        "max_abs_err": (sk - sp).abs().max().item(), **held,
        "equals_mirror": check_mirror("ldlt_solve", sk, xm),
        "res_kernel_max": rk.max().item(), "res_plain_max": rp.max().item(),
        "growth_lanes": int((rp > LDLT_GROWTH).sum()),
        **timing(lambda: ldlt.ldlt_solve(Fp, dp, r32),
                 lambda: ldlt.ldlt_solve_plain(Fp, dp, r32),
                 library_ms("ldlt_solve (torch.linalg.ldl_solve on the "
                            "unpivoted factor)", ldl_solve),
                 bound_ldlt("solve", B, K)),
        "launch": launch["ldlt_solve"]}
    # the factor alone, held on the factor itself against the plain version
    # in float64, and through the residual of the pair a caller runs
    # (ldlt_factor, then ldlt_solve): summation-order differences in the
    # unpivoted factor of these indefinite matrices are amplified lane by
    # lane, so the kernel's factor is not held to the plain float32
    # factor's residual under other sweeps
    Fk, dk = ldlt.ldlt_factor(M32)
    err = check_factor_against_f64("ldlt_factor", Fk, dk, M32)
    same_factor("ldlt_factor", Fk, dk, Fp, dp)
    fk = ldlt.ldlt_solve(Fk, dk, r32)
    sync()
    rk = rel_residual(Ms, fk, rs)
    held = check_residuals("ldlt_factor", rk, rp, r64)
    out["ldlt_factor"] = {
        **err, **held, "equals_mirror": check_mirror("ldlt_factor", fk, xm),
        "res_kernel_max": rk.max().item(),
        "res_plain_max": rp.max().item(),
        **timing(lambda: ldlt.ldlt_factor(M32),
                 lambda: ldlt.ldlt_factor_plain(M32),
                 library_ms("ldlt_factor (torch.linalg.ldl_factor, "
                            "pivoted)", lambda: torch.linalg.ldl_factor(M32)),
                 bound_ldlt("factor", B, K)),
        "launch": launch["ldlt_factor"]}
    return out


def same_factor(name, Fk, dk, Fp, dp):
    """The kernel's factor (F's upper triangle, d) equal to the plain
    version's bit for bit; the kernels round as it does."""
    import torch
    K = Fk.shape[-1]
    upper = torch.triu(torch.ones(K, K, dtype=torch.bool,
                                  device=Fk.device))
    same = lambda a, b: bool(((a == b) | (a.isnan() & b.isnan())).all())
    if not (same(Fk[:, upper], Fp[:, upper]) and same(dk, dp)):
        raise RuntimeError(f"{name}: the factor differs from the plain "
                           "version's; the kernels round as it does, bit "
                           "for bit")


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
    t0 = time.perf_counter()
    out = fn()
    secs = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    for k in must_launch:
        if launches[k] <= 0:
            raise RuntimeError(f"{name} path never launched kernel {k}")
    say(name, f"launches {launches}; the path took {secs:.1f} s")
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
        "race_car", lambda: ht.race_car(dev, batch=512, reps=5,
                                        batch_reps=2),
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
    return extra, lanes, launches


def phase_cstr(crec, card, dev):
    """The CSTR batch (B=256) after a B=8 warm-up, held against the JAX
    package's record; then, outside the counts, its first CSTR_LU_LANES
    lanes through the "lu" route (the route the record holds)."""
    from polympc_torch import cstr_point as cp
    B = crec["x0s"].shape[0]
    (extra, lanes), launches = run_path(
        "cstr_b256", lambda: cp.run(B, dev, x0s=crec["x0s"], warmup=8),
        ("bbt_epoch", "ldlt_factor_solve", "ldlt_solve"))
    extra["certified_solves_per_s"] = extra["certified"] / \
        extra["wall_s_per_batch"]
    extra["solves_per_s"] = extra["status_solved"] / extra["solve_s"]
    say("cstr_b256", f"{card}: {extra}")
    compare_cstr(crec, lanes, "kernel route")
    # the first CSTR_LU_LANES lanes only: the LU epoch's batched factors
    # took 191 s at B=256 on the card, the batch's largest share of this
    # script's time
    n = CSTR_LU_LANES
    _, lu = cp.run(n, dev, x0s=crec["x0s"][:n], kkt_solver="lu", warmup=0)
    say("cstr_b256", f"lu route on lanes 0-{n - 1} (outside the counts): "
                     f"status solved {int((lu['status'] == 1).sum())} "
                     f"(kernel route {int((lanes['status'][:n] == 1).sum())}"
                     f", record {int((crec['status'][:n] == 1).sum())}), "
                     f"certified {int(lu['certified'].sum())}, mean iters "
                     f"{lu['iters'].mean():.4f}; lanes whose status differs "
                     f"from the kernel route "
                     f"{int((lu['status'] != lanes['status'][:n]).sum())}, "
                     f"from the record "
                     f"{int((lu['status'] != crec['status'][:n]).sum())}")
    return extra, lanes, launches


def compare_cstr(crec, lanes, tag):
    """The gates of the CSTR batch against the JAX record: SOLVED and
    certified counts at least the record's less CSTR_SLACK; on the lanes
    SOLVED in both, the median relative cost difference within
    CSTR_COST_RTOL (see there)."""
    res = lanes["residual"]
    if res.shape != crec["residual"].shape or \
            not np.isfinite(lanes["cost"]).all():
        raise RuntimeError(f"cstr path ({tag}): results of the wrong shape "
                           "or non-finite costs")
    mine, theirs = lanes["status"] == 1, crec["status"] == 1
    both = mine & theirs
    rel = np.abs(lanes["cost"][both] - crec["cost"][both]) / \
        np.abs(crec["cost"][both])
    # SOLVED short of the optimum: a certify residual far above the ~1e2
    # of the lanes that reach it
    short = lambda a: int(((a["status"] == 1) & (a["residual"] > 1e5)).sum())
    say("cstr_b256", f"{tag}: status solved {int(mine.sum())} (record "
                     f"{int(theirs.sum())}, route {crec['route']}), "
                     f"certified {int(lanes['certified'].sum())} (record "
                     f"{int(crec['certified'].sum())}); SOLVED in both "
                     f"{int(both.sum())}, port only "
                     f"{np.nonzero(mine & ~theirs)[0].tolist()}, record "
                     f"only {np.nonzero(~mine & theirs)[0].tolist()}; mean "
                     f"iters {lanes['iters'].mean():.4f} (record "
                     f"{crec['iters'].mean():.4f}); cost on common lanes: "
                     f"median relative difference {np.median(rel):.3e}, "
                     f"largest {rel.max():.3e}, above {CSTR_COST_RTOL} on "
                     f"{int((rel > CSTR_COST_RTOL).sum())}; SOLVED with a "
                     f"certify residual above 1e5 {short(lanes)} (record "
                     f"{short(crec)}); certify residual median "
                     f"{np.median(res):.3e} (record "
                     f"{np.median(crec['residual']):.3e})")
    for what, got, want in (
            ("SOLVED", int(mine.sum()), int(theirs.sum())),
            ("certified", int(lanes["certified"].sum()),
             int(crec["certified"].sum()))):
        if got < want - CSTR_SLACK:
            raise RuntimeError(f"cstr path ({tag}): {what} {got}, fewer "
                               f"than the record's {want} - {CSTR_SLACK}")
    if not np.median(rel) <= CSTR_COST_RTOL:
        raise RuntimeError(f"cstr path ({tag}): the median relative cost "
                           f"difference on lanes SOLVED in both is "
                           f"{np.median(rel):.3e} (tol {CSTR_COST_RTOL})")


def mpc_path(dev):
    """The MPC facade on the card in float64 (no kernel: the kernels take
    float32): the robot quick start with default SQPSettings() (dense
    BFGS) and its warm re-solve, the CSTR with block-BFGS at the
    reference's optimum, and examples/cstr_nmpc.py's closed loop (12
    steps, RK4 plant): every step SOLVED or stopped at max_iter at the
    primal optimum, and the error falling every step."""
    import torch
    from polympc_torch.basis import Chebyshev, SegmentedBasis
    from polympc_torch.control import MPC
    from polympc_torch.models import (
        CSTR_ULB, CSTR_US, CSTR_UUB, CSTR_X0, CSTR_XS, cstr_ocp, robot_ocp)
    from polympc_torch.nlp import SQPSettings
    from polympc_torch.ocp import rk4_integrate
    from polympc_torch.qp.types import ADMMSettings
    from polympc_torch.utils import status as st
    mesh = lambda: SegmentedBasis(Chebyshev(5), 2)
    out = {}

    def timed(mpc):
        t0 = time.perf_counter()
        sol = mpc.solve()
        sync()
        return sol, time.perf_counter() - t0

    mpc = MPC(robot_ocp(), mesh(), t0=0.0, tf=2.0, settings=SQPSettings(),
              device=dev)
    mpc.set_static_parameters([2.0])
    mpc.control_bounds([-1.5, -0.75], [1.5, 0.75])
    mpc.initial_conditions([0.5, 0.5, 0.5])
    cold, t_cold = timed(mpc)
    mpc.initial_conditions([0.52, 0.48, 0.5])
    warm, t_warm = timed(mpc)
    out["robot_bfgs"] = {"cold_iters": int(cold.iters),
                         "warm_iters": int(warm.iters),
                         "cold_s": t_cold, "warm_s": t_warm}
    if int(cold.status) != st.SOLVED or int(warm.status) != st.SOLVED or \
            int(warm.iters) > int(cold.iters):
        raise RuntimeError(f"mpc path: robot quick start {out['robot_bfgs']}"
                           f", statuses {int(cold.status)}/"
                           f"{int(warm.status)}")

    def cstr_mpc(hessian, max_iter):
        m = MPC(cstr_ocp(), mesh(), t0=0.0, tf=100.0,
                settings=SQPSettings(
                    hessian=hessian, max_iter=max_iter,
                    qp=ADMMSettings(rho=1.0, eps_abs=1e-5, eps_rel=1e-5,
                                    max_epochs=40, equil_iters=4)),
                x_scale=[2.0, 1.0, 100.0, 100.0], u_scale=[15.0, 2000.0],
                device=dev)
        m.control_bounds(CSTR_ULB, CSTR_UUB)
        m.state_bounds([0.0, 0.0, 50.0, 50.0], [6.0, 4.0, 150.0, 150.0])
        return m

    m = cstr_mpc("block_bfgs", 150)
    m.initial_conditions(CSTR_X0)
    m.x_guess(CSTR_X0)
    m.u_guess([14.19, -1113.5])
    sol, t_bb = timed(m)
    out["cstr_block_bfgs"] = {"status": int(sol.status),
                              "iters": int(sol.iters),
                              "cost": float(sol.cost), "s": t_bb}
    if int(sol.status) != st.SOLVED or \
            abs(float(sol.cost) - 12262.6) > 1e-3 * 12262.6:
        raise RuntimeError(f"mpc path: CSTR block-BFGS "
                           f"{out['cstr_block_bfgs']}, the reference's "
                           "optimum is 12262.6 (rtol 1e-3)")

    m = cstr_mpc("exact", 100)
    ocp = m.ocp
    x = torch.as_tensor(CSTR_X0, dtype=torch.float64, device=dev)
    xs = torch.as_tensor(CSTR_XS, dtype=torch.float64, device=dev)
    none = torch.zeros(0, dtype=torch.float64, device=dev)
    prev = float(torch.linalg.vector_norm(x - xs))
    lat, iters, stalled = [], [], []
    qs = m.settings
    for k in range(12):
        m.initial_conditions(x)
        if k == 0:
            m.x_guess(x)
            m.u_guess(CSTR_US)
        sol, t = timed(m)
        lat.append(t)
        iters.append(int(sol.iters))
        # a step that stops at max_iter with its primal step and violation
        # inside the SQP's tolerances sits at the optimum while its duals
        # creep at the smallest trial step (the merit line search rejects
        # full steps on rounding noise there; ROADMAP queue 3): counted,
        # not failed
        primal_done = float(sol.primal_step) <= qs.eps_prim and \
            float(sol.violation) <= qs.eps_viol
        if int(sol.status) != st.SOLVED:
            if not primal_done:
                raise RuntimeError(f"mpc path: closed-loop step {k} status "
                                   f"{int(sol.status)}, primal step "
                                   f"{float(sol.primal_step):.3e}, "
                                   f"violation {float(sol.violation):.3e}")
            stalled.append(k)
        u = m.solution_u()[0]
        x = rk4_integrate(lambda xx, uu, tt: ocp.dynamics(xx, u, none,
                                                          none, tt),
                          x, 0.0, 10.0, 20)[-1]
        err = float(torch.linalg.vector_norm(x - xs))
        if not err < prev:
            raise RuntimeError(f"mpc path: closed-loop error rose at step "
                               f"{k}: {prev:.4f} -> {err:.4f}")
        prev = err
    out["cstr_closed_loop"] = {
        "steps": 12, "iters": iters, "final_error": prev,
        "solved_steps": 12 - len(stalled),
        "max_iter_at_the_primal_optimum": stalled,
        "latency_ms_mean": 1e3 * float(np.mean(lat)),
        "latency_ms_max": 1e3 * float(np.max(lat))}
    return out


def phase_mpc(card, dev):
    out, launches = run_path("mpc", lambda: mpc_path(dev), ())
    say("mpc", f"{card}, float64, no kernel on this path (the kernels take "
               f"float32): {out}")
    return out, launches


def phase_kite_ip(srec, card, dev):
    """bench's kite batch (B=512) through the interior point in float64
    after a B=8 warm-up, against the JAX record."""
    from polympc_torch import solvers_point as sp
    x0s = srec["kite_x0s"]
    (extra, lanes), launches = run_path(
        "kite_ip_b512", lambda: sp.kite_ip(x0s.shape[0], dev, x0s=x0s,
                                           warmup=8), ())
    if lanes["cost"].shape != srec["kite_cost"].shape:
        raise RuntimeError("kite_ip path: results of the wrong shape")
    mine, theirs = lanes["status"] == 1, srec["kite_status"] == 1
    both = mine & theirs
    rel = np.abs(lanes["cost"][both] - srec["kite_cost"][both]) / \
        np.abs(srec["kite_cost"][both])
    differ = np.nonzero(lanes["iters"] != srec["kite_iters"])[0]
    say("kite_ip_b512", f"{card}, float64, no kernel on this path: {extra}")
    say("kite_ip_b512", f"record SOLVED {int(theirs.sum())} (mean iters "
                        f"{srec['kite_iters'].mean():.4f}); SOLVED in both "
                        f"{int(both.sum())}, port only "
                        f"{np.nonzero(mine & ~theirs)[0].tolist()}, record "
                        f"only {np.nonzero(~mine & theirs)[0].tolist()}; "
                        f"lanes whose iteration count differs "
                        f"{len(differ)}: {differ[:40].tolist()}; cost on "
                        f"common lanes: largest relative difference "
                        f"{rel.max():.3e}")
    if extra["status_solved"] < int(theirs.sum()) - KITE_IP_SLACK:
        raise RuntimeError(f"kite_ip path: SOLVED {extra['status_solved']},"
                           f" fewer than the record's {int(theirs.sum())} - "
                           f"{KITE_IP_SLACK}")
    if not (np.isfinite(lanes["cost"][mine]).all()
            and rel.max() <= KITE_IP_COST_RTOL):
        raise RuntimeError(f"kite_ip path: cost on lanes SOLVED in both "
                           f"differs by {rel.max():.3e} relative (tol "
                           f"{KITE_IP_COST_RTOL})")
    return extra, launches


def phase_mpc_ip(card, dev):
    """MPC(solver="ip") on the robot quick start, float64."""
    from polympc_torch import solvers_point as sp
    res, launches = run_path("mpc_ip", lambda: sp.mpc_ip(dev), ())
    say("mpc_ip", f"{card}, float64, no kernel on this path: {res}")
    if not (res["cold_status"] == res["sqp_status"] == res["warm_status"]
            == 1 and res["resolves_solved"] == res["resolves"]):
        raise RuntimeError(f"mpc_ip path: statuses {res}")
    if not res["max_abs_dx_vs_sqp"] <= MPC_IP_X_ATOL:
        raise RuntimeError(f"mpc_ip path: x differs from the SQP route by "
                           f"{res['max_abs_dx_vs_sqp']:.3e} (tol "
                           f"{MPC_IP_X_ATOL})")
    return res, launches


def active_rows(qp, x, tol):
    """The VJP's active sets at x (the backward's rule): general rows and
    box rows with a bound within tol, as one (B, m + n) boolean array."""
    A, al, au, xl, xu = (getattr(qp, f).cpu().numpy()
                         for f in ("A", "al", "au", "xl", "xu"))
    Ax = np.einsum("bij,bj->bi", A, x)
    return np.concatenate([(Ax - al <= tol) | (au - Ax <= tol),
                           (x - xl <= tol) | (xu - x <= tol)], 1)


def phase_qp_solvers(srec, card, dev):
    """The spline-fit QP batch (B=4096) through the interior point, the
    stacked ADMM (kernel 7 at K=79), the active set (host) and the VJP,
    against the JAX record and each other."""
    import torch
    from polympc_torch import solvers_point as sp
    from polympc_torch.headline_table import spline_batch, spline_settings
    (extra, lanes), launches = run_path(
        "qp_solvers", lambda: sp.qp_solvers(dev), ("admm_epoch",))
    say("qp_solvers", f"{card}: {extra}")
    # the interior point, float64
    ns = srec["ip_x"].shape[0]
    ip_ok = lanes["ip_status"] == 1
    want = int((srec["ip_status"] == 1).sum())
    dx_ip = np.abs(lanes["ip_x"][:ns] - srec["ip_x"]).max()
    say("qp_solvers", f"qp_ip_solve: SOLVED {int(ip_ok.sum())} (record "
                      f"{want}), lanes whose iteration count differs "
                      f"{int((lanes['ip_iters'] != srec['ip_iters']).sum())}"
                      f", max |x - x_record| on {ns} lanes {dx_ip:.3e}")
    if int(ip_ok.sum()) != want or not dx_ip <= QP_IP_X_ATOL:
        raise RuntimeError("qp_solvers path: the interior point disagrees "
                           "with the record")
    # admm_solve, float32 through the kernel
    ad_ok = lanes["admm_status"] == 1
    want = int((srec["admm_status"] == 1).sum())
    both = ad_ok & ip_ok
    xi = lanes["ip_x"][both]
    err = np.abs(lanes["admm_x"][both] - xi).max(1) / \
        (1.0 + np.abs(xi).max(1))
    share = float((err <= ADMM_X_RTOL).mean()) if both.any() else 0.0
    say("qp_solvers", f"admm_solve (stacked, K=79, kernel): SOLVED "
                      f"{int(ad_ok.sum())} (record {want}, "
                      f"{srec['admm_kkt_solver']} epoch); against the "
                      f"interior point on {int(both.sum())} lanes: worst "
                      f"{err.max():.3e}, median {np.median(err):.3e}, "
                      f"share within {ADMM_X_RTOL} {share:.4f}")
    if int(ad_ok.sum()) < want - ADMM_SLACK or share < ADMM_X_SHARE:
        raise RuntimeError("qp_solvers path: admm_solve fails its gates")
    # the active set, on the host by definition
    na = lanes["as_x"].shape[0]
    dx_as = np.abs(lanes["as_x"] - lanes["ip_x"][:na]).max()
    say("qp_solvers", f"qp_active_set_solve (host: Goldfarb-Idnani through "
                      f"ctypes, the solver's definition in both packages) "
                      f"on {na} lanes: SOLVED "
                      f"{int((lanes['as_status'] == 1).sum())}, max |x - "
                      f"x_ip| {dx_as:.3e}")
    if not ((lanes["as_status"] == 1).all() and dx_as <= AS_X_ATOL):
        raise RuntimeError("qp_solvers path: the active set fails its gates")
    # the VJP, float32 forward through the kernel, against float64
    nv = srec["vjp_x"].shape[0]
    names = sp.VJP_FIELDS
    mine = np.concatenate([lanes[f"vjp_{k}"][:nv] for k in names], 1)
    ref = np.concatenate([srec[f"vjp_{k}"].astype(np.float64)
                          for k in names], 1)
    rel = np.abs(mine - ref).max(1) / np.maximum(np.abs(ref).max(1), 1e-30)
    qp64 = spline_batch(nv, "cpu", torch.float64)[1]
    tol = 10.0 * spline_settings().eps_abs + 1e-8
    flips = (active_rows(qp64, lanes["vjp_x"][:nv].astype(np.float64), tol)
             != active_rows(qp64, srec["vjp_x"], tol)).any(1)
    say("qp_solvers", f"VJP d(w'x*)/d({', '.join(names)}) on {nv} lanes "
                      f"against the float64 record: median relative error "
                      f"{np.median(rel):.3e}, worst {rel.max():.3e} (lane "
                      f"{int(rel.argmax())}); lanes whose active set "
                      f"differs {np.nonzero(flips)[0].tolist()}")
    if not np.median(rel) <= VJP_MEDIAN_RTOL:
        raise RuntimeError(f"qp_solvers path: VJP median relative error "
                           f"{np.median(rel):.3e} > {VJP_MEDIAN_RTOL}")
    return extra, launches


def phase_lqr(card, dev):
    """LQR / CARE (BASELINE config 2): the quadrotor at B=1 and B=4096
    linearisation points, float64, against scipy."""
    from scipy.linalg import solve_continuous_are
    from polympc_torch import solvers_point as sp
    (extra, lanes), launches = run_path("lqr", lambda: sp.lqr_batch(dev), ())
    A, Bm, Q, R = sp.quadrotor()
    P_ref = solve_continuous_are(A, Bm, Q, R)
    b1 = np.abs(lanes["P1"] - P_ref) <= LQR_ATOL + LQR_RTOL * np.abs(P_ref)
    worst = 0.0
    for b in range(LQR_SCIPY_LANES):
        ref = solve_continuous_are(lanes["A"][b], Bm, Q, R)
        worst = max(worst, float((np.abs(lanes["P"][b] - ref)
                                  / (LQR_ATOL + LQR_RTOL * np.abs(ref))
                                  ).max()))
    eig = np.linalg.eigvals(lanes["A"] - Bm[None] @ lanes["K"])
    stable = (eig.real < 0).all(1)
    say("lqr", f"{card}, float64, no kernel on this path: {extra}")
    say("lqr", f"B=1 P against scipy within rtol {LQR_RTOL} atol {LQR_ATOL}:"
               f" {bool(b1.all())}; {LQR_SCIPY_LANES} batch lanes against "
               f"scipy: worst error / tolerance {worst:.3e}; worst relative "
               f"CARE residual {extra['worst_rel_residual']:.3e} (lane "
               f"{int(lanes['rel_residual'].argmax())}); closed loops "
               f"stable {int(stable.sum())}/{stable.size}")
    if not (b1.all() and worst <= 1.0 and stable.all()
            and extra["worst_rel_residual"] <= LQR_RES_TOL):
        raise RuntimeError("lqr path fails its gates")
    return extra, launches


def phase_nlp_extras(card, dev):
    """psarc, the trust region, projected gradient and the projection, one
    float64 call each on the card, with the JAX tests' oracles."""
    from polympc_torch import solvers_point as sp
    out, launches = run_path("nlp_extras", lambda: sp.nlp_extras(dev), ())
    say("nlp_extras", f"{card}, float64, no kernel on this path: {out}")
    ps, tr, gp = out["psarc"], out["trust_region"], out["projected_gradient"]
    checks = {
        "psarc": ps["converged"] and ps["residual"] < 1e-6
        and ps["lambda_first_last"] == [1.0, 0.0],
        "trust_region": tr["status"] == 1
        and np.abs(np.asarray(tr["x"]) - 1.0).max() <= 1e-4,
        "projected_gradient": gp["status"] == 1
        and np.abs(np.asarray(gp["x"]) - [0.1, 1.0]).max() <= 1e-5,
        "projection": out["projection"]["device"].startswith("cuda")
        and out["projection"]["max_error"] <= 1e-6}
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise RuntimeError(f"nlp_extras path: {bad} fail their oracles")
    return out, launches


def phase_parity_kite_ms(orec, dev, results):
    """The dense epoch at the MS kite's shape (B=512, n=75, m=50, K=125, 50
    iterations): on the path's own first epoch by the F64 rule, on random
    well-conditioned quasi-definite KKTs of that shape against the plain
    version; its time, bound, launch and time by instances a block.  The
    LDL^T factor-solve and solve at the MS certify's K=125 on diagonally
    dominant matrices against the plain version."""
    from polympc_torch import ocp_extras_point as op
    from polympc_torch.ops import admm_epoch as ae
    rng = np.random.default_rng(23)
    x0s = orec["kite_x0s"]
    qs, epoch = op.first_epoch(x0s.shape[0], dev, x0s)
    B, n = epoch[1].shape
    m = epoch[2].shape[1]
    kw = dict(sigma=qs.sigma, alpha=qs.alpha, iters=qs.check_every)
    kern, plain = epoch_fns(**kw)
    err = check_against_f64("admm_epoch (MS kite)", kern, plain, epoch, ())
    case = random_dense_epoch(n, m, B, rng, dev)
    rel = check_tight("admm_epoch (MS kite shape)", kern, plain, case, (),
                      EPOCH_RTOL)
    say("parity", f"admm_epoch random quasi-definite B={B} n={n} m={m}: rel "
                  f"{rel:.2e} (tol {EPOCH_RTOL})")
    k125 = {**err, **timing(lambda: kern(*epoch), lambda: plain(*epoch),
                            None, bound_admm_epoch(B, n, m, qs.check_every)),
            "random_rel_vs_plain": rel,
            "shape": f"B={B} n={n} m={m} iters={qs.check_every}",
            "launch": epoch_launch(ae, n, m),
            "ms_by_threads": epoch_by_threads(ae, epoch, kw)}
    results["admm_epoch"]["kite_ms_K125"] = k125
    say("parity", f"admm_epoch at the MS kite batch's first epoch B={B} "
                  f"K={n + m}: {k125}")
    # the LDL^T kernels at the MS certify's K on well-conditioned matrices
    # (the certify's own matrices are checked after the path)
    import torch
    from polympc_torch.ops import ldlt
    A, bA = diag_dominant(B, n + m, rng, dev)
    rel = check_tight("ldlt_factor_solve", lambda *a: torch.cat(
        ldlt.ldlt_factor_solve(*a)[::2], 1), lambda *a: torch.cat(
        ldlt.ldlt_factor_solve_plain(*a)[::2], 1), (A, bA), (), LDLT_RTOL)
    _, FA, dA = ldlt.ldlt_factor_solve_plain(A, bA)
    rel2 = check_tight("ldlt_solve", ldlt.ldlt_solve, ldlt.ldlt_solve_plain,
                       (FA, dA, bA), (), LDLT_RTOL)
    say("parity", f"ldlt_factor_solve / ldlt_solve random diagonally "
                  f"dominant B={B} K={n + m}: rel {rel:.2e} / {rel2:.2e} "
                  f"(tol {LDLT_RTOL})")


def phase_kite_ms(orec, card, dev):
    """The kite by multiple shooting (B=512): a B=8 warm-up, then the
    median of 3 timed batches (float32 SQP through the dense epoch kernel,
    float64 certify through the LDL^T kernels), against the JAX record."""
    from polympc_torch import ocp_extras_point as op
    x0s = orec["kite_x0s"]
    (extra, lanes), launches = run_path(
        "kite_ms_b512", lambda: op.kite_ms(x0s.shape[0], dev, reps=3,
                                           x0s=x0s, warmup=8),
        ("admm_epoch", "ldlt_factor_solve", "ldlt_solve"))
    if lanes["x"].shape != orec["kite_x"].shape or \
            not np.isfinite(lanes["residual"]).all():
        raise RuntimeError("kite_ms path: results of the wrong shape or "
                           "not finite")
    mine, theirs = lanes["certified"], orec["kite_certified"]
    solved = int((orec["kite_status"] == 1).sum())
    say("kite_ms_b512", f"{card}: {extra}")
    say("kite_ms_b512", f"JAX record ({orec['kite_kkt_solver']} epoch, "
                        f"max_iter {int(orec['kite_max_iter'])}) certifies "
                        f"{int(theirs.sum())}, status solved {solved}, mean "
                        f"iters {orec['kite_iters'].mean():.4f}; certified "
                        f"in both {int((mine & theirs).sum())}, port only "
                        f"{np.nonzero(mine & ~theirs)[0].tolist()}, record "
                        f"only {np.nonzero(~mine & theirs)[0].tolist()}")
    if extra["certified"] < int(theirs.sum()) - KITE_MS_SLACK or \
            extra["status_solved"] < solved - KITE_MS_SLACK:
        raise RuntimeError(f"kite_ms path: certified {extra['certified']}, "
                           f"SOLVED {extra['status_solved']}; the record's "
                           f"{int(theirs.sum())} and {solved} less "
                           f"{KITE_MS_SLACK}")
    return extra, lanes, launches


def phase_parity_kite_ms_refine(orec, lanes, dev, results):
    """The LDL^T kernels on the MS certify's Newton-KKT matrices (K=125) at
    the path's float32 solution (after the path, from its solution), by
    the residual gate on every lane.  Every MS lane's unpivoted factor
    pivots on the certify's 1e-6 regularisation (the last node's gamma and
    s_dot carry no curvature), where the plain float32 residual is
    rounding luck; such lanes pass by test (b), the kernel's substitution
    against the float64 one on the same factor."""
    from polympc_torch import ocp_extras_point as op
    Ms, rs = op.certify_system(lanes["x"], lanes["lam"], orec["kite_x0s"],
                               dev)
    M32, r32 = Ms.float().contiguous(), rs.float().contiguous()
    B, K = r32.shape
    out = refine_checks(Ms, M32, r32)
    for name in ("ldlt_factor_solve", "ldlt_solve", "ldlt_factor"):
        results[name]["kite_ms"] = {**out[name], "shape": f"B={B} K={K}"}
        say("parity", f"{name} at the MS kite certify's refine matrices "
                      f"B={B} K={K}: {out[name]}")


def _near(a, b, rtol):
    return abs(a - b) <= rtol * max(abs(b), 1e-300)


def phase_ocp_extras(orec, card, dev):
    """The OCP extras in float64 on the card (no kernel: the kernels take
    float32), each held to its JAX test's oracle and to the record."""
    from polympc_torch import ocp_extras_point as op
    out, launches = run_path("ocp_extras", lambda: op.ocp_extras(dev), ())
    say("ocp_extras", f"{card}, float64, no kernel on this path: {out}")
    r, tol = orec, OCP_EXTRAS_COST_RTOL
    ms, sr, stf = out["ms_robot"], out["soft_robot"], out["stiff"]
    rate, ident, ig = out["rate"], out["identify"], out["integrators"]
    c_ps = float(r["ms_robot_collocation_cost"])
    checks = {
        "ms_robot": ms["status"] == 1 and ms["x0_error"] <= 1e-8
        and ms["max_abs_eq"] <= 1e-4 and _near(ms["cost"], c_ps, 2e-2)
        and _near(ms["cost"], float(r["ms_robot_cost"]), tol)
        and _near(ms["collocation_cost"], c_ps, tol),
        "soft_robot": sr["status"] == 1 and sr["ne"] == 0
        and abs(sr["cost"] - c_ps) / c_ps < 0.1
        and _near(sr["cost"], float(r["soft_robot_cost"]), tol),
        "stiff": all(stf[k]["status"] == 1
                     for k in ("oracle", "lobatto", "radau"))
        and stf["radau"]["traj_err"] < stf["lobatto"]["traj_err"]
        and stf["radau"]["cost_err"] < stf["lobatto"]["cost_err"]
        and all(_near(stf[k]["cost"], float(r[f"stiff_{k}_cost"]), tol)
                for k in ("oracle", "lobatto", "radau")),
        "rate": rate["rate"]["status"] == rate["free"]["status"] == 1
        and rate["rate"]["max_rate"] <= 1.2 + 1e-4
        and rate["free"]["max_rate"] > 1.2
        and rate["rate"]["bbt_structure_is_none"]
        and _near(rate["rate"]["cost"], float(r["rate_cost"]), tol),
        "identify": ident["status"] == 1
        and np.abs(np.asarray(ident["p"]) - [4.0, 0.3]).max() <= 1e-3
        and np.abs(np.asarray(ident["p_init"]) - [4.0, 0.3]).max() <= 1e-3
        and np.abs(np.asarray(ident["p"]) - r["ident_p"]).max() <= 1e-6,
        "integrators": ig["device"].startswith("cuda")
        and ig["exp"]["stats"][2] == 1
        and _near(ig["exp"]["x"], float(np.exp(-2.0)), 1e-5)
        and ig["oscillator"]["stats"][2] == 1
        and ig["oscillator"]["error"] <= 1e-5
        and ig["exhausted"]["stats"][2] == 0
        and ig["ps"]["error"] <= 1e-7
        and np.abs(np.asarray(ig["ps"]["X"]) - r["ps_X"][:, 0]).max()
        <= 1e-9}
    say("ocp_extras", "adaptive step counts (accepted, rejected, success) "
                      f"against the record: exp {ig['exp']['stats']} / "
                      f"{r['adaptive_exp_stats'].tolist()}, oscillator "
                      f"{ig['oscillator']['stats']} / "
                      f"{r['adaptive_osc_stats'].tolist()}, exhausted "
                      f"{ig['exhausted']['stats']} / "
                      f"{r['adaptive_fail_stats'].tolist()}")
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise RuntimeError(f"ocp_extras path: {bad} fail their oracles")
    return out, launches


def phase_dist_sharded(drec, lanes, card, dev):
    """The dist kite batch (S=8, B=128, the kernel route) through
    ``make_batch_dist_solver`` on ``mesh_2d(1, 1)`` in a one-rank NCCL
    group: held against the unsharded batch of the dist_kite_s8 path of
    this call, per lane, and its certify (``dist_refine`` on the mesh)
    against the record.  With more than one card, also the dry run's
    composed (dp, seg) solve over every card
    (``multichip_point.run``)."""
    import torch
    import torch.distributed as dist
    from polympc_torch import dist_point as dp
    from polympc_torch.multichip_point import free_port
    from polympc_torch.multichip_point import run as multichip_run
    from polympc_torch.parallel import initialize_multihost, mesh_2d
    initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0, device=dev)
    try:
        if dist.get_backend() != "nccl":
            raise RuntimeError(f"dist_sharded: the group runs "
                               f"{dist.get_backend()}, not NCCL")
        once = dp.batch_fn(drec["x0s"].shape[0], dev, drec["x0s"],
                           mesh=mesh_2d(1, 1))
        (out, res, solve_s, _), launches = run_path(
            "dist_sharded", once, ("ldlt_inverse",))
        extra, mine = dp.summarize(out, res)
        same = {k: bool(np.array_equal(mine[k], lanes[k]))
                for k in ("status", "iters", "qp_iters", "W")}
        W, W0 = mine["W"].astype(np.float64), lanes["W"].astype(np.float64)
        rel = float(lane_rel(torch.as_tensor(W - W0),
                             torch.as_tensor(W0)).max())
        say("dist_sharded", f"{card}: one NCCL rank, mesh (dp=1, seg=1); "
                            f"solve {solve_s:.3f} s; {extra}")
        say("dist_sharded", f"against the unsharded batch of this call: "
                            f"equal bit for bit {same}; W per-lane "
                            f"relative difference {rel:.3e}")
        if not (same["status"] and same["iters"]) or \
                not rel <= DIST_SHARDED_RTOL:
            raise RuntimeError("dist_sharded: statuses, iterations or W "
                               "differ from the unsharded batch")
        compare_dist(drec, "pallas_", mine, "sharded, kernel route")
        if torch.cuda.device_count() > 1:
            say("dist_sharded", "the dry run over every card: " + json.dumps(
                multichip_run(torch.cuda.device_count(), dev)))
        else:
            say("dist_sharded", "one card: ran one rank; the (dp, seg) "
                                "composed solve over several cards did not "
                                "run")
        extra.update(solve_s=solve_s, bitwise=same, W_rel=rel)
        return extra, launches
    finally:
        dist.destroy_process_group()


# the epoch kernel that each route of the sweep's QPs launches
ROUTE_KERNEL = {"bbt": "bbt_epoch", "dense_kernel": "admm_epoch", "lu": None}


def row_route(row, ldlt_max_k):
    """The route a sweep row took, read from its own launches: its QPs
    launched the epoch kernel of one route and no other ("lu": neither),
    and its certify the LDL^T factor-solve exactly where K is at most
    ``ldlt_max_k``.  Raises where that disagrees with the route the row
    reports or a skipped row launched anything."""
    got = row["launches"]
    if "skipped" in row:
        if got:
            raise RuntimeError(f"horizon_sweep S={row['segments']} "
                               f"{row['backend']}: skipped, yet launched "
                               f"{got}")
        return "skipped"
    taken = [r for r, k in ROUTE_KERNEL.items() if k and got.get(k, 0)]
    taken = "+".join(taken) or "lu"
    if taken != row["route"]:
        raise RuntimeError(f"horizon_sweep S={row['segments']} "
                           f"{row['backend']}: the route is "
                           f"{row['route']} but its QPs launched {got}")
    if (got.get("ldlt_factor_solve", 0) > 0) != (row["K"] <= ldlt_max_k):
        raise RuntimeError(f"horizon_sweep S={row['segments']} "
                           f"{row['backend']} K={row['K']}: its certify "
                           f"launched {got}, the LDL^T kernels being its "
                           f"route exactly where K <= {ldlt_max_k}")
    return taken


def phase_horizon_sweep(grec, card, dev):
    """The horizon sweep (polympc_torch/scaling_point.py): every row after
    its warm-up, each certified count against the JAX record's for the
    same S.  Each row's launches are read around the row itself and must
    show its own route (``row_route``).  After the path, outside its
    window, the measured epoch kernels (run_kernel_micro) with their
    bounds."""
    from polympc_torch import scaling_point as sp
    from polympc_torch.nlp.refine import REFINE_LDLT_MAX_K
    from polympc_torch.ops import _build

    def body():
        out, before = [], dict(_build.LAUNCHES)
        for row, lanes in sp.sweep(device=dev,
                                   x0s=lambda S, B: grec[f"s{S}_x0s"]):
            now = dict(_build.LAUNCHES)
            row["launches"] = {k: now[k] - before[k] for k in now
                               if now[k] != before[k]}
            before = now
            out.append((row, lanes))
        return out
    rows, launches = run_path(
        "horizon_sweep", body, ("bbt_epoch", "admm_epoch",
                                "ldlt_factor_solve", "ldlt_solve"))
    for row, lanes in rows:
        S, B = row["segments"], row["batch"]
        taken = row_route(row, REFINE_LDLT_MAX_K)
        if "skipped" in row:
            say("horizon_sweep", f"S={S:2d} {row['backend']:5s} "
                                 f"K={row['K']}: skipped, {row['skipped']}")
            continue
        if lanes["residual"].shape != (B,) or \
                not np.isfinite(lanes["residual"]).all():
            raise RuntimeError(f"horizon_sweep S={S}: residuals of the "
                               "wrong shape or not finite")
        theirs = int(grec[f"s{S}_certified"].sum())
        rsolved = int((grec[f"s{S}_status"] == 1).sum())
        slack = round(SWEEP_SLACK_SHARE * B)
        say("horizon_sweep", (
            f"S={S:2d} {row['backend']:5s} route taken {taken:12s} "
            f"K={row['K']} B={B}: SOLVED {row['solved']} (record "
            f"{rsolved}), certified {row['certified']} (record {theirs}), "
            f"mean iters {row['mean_sqp_iters']:.4f} (record "
            f"{grec[f's{S}_iters'].mean():.4f}), wall "
            f"{row['wall_s_per_batch']:.4f} s (solve {row['solve_s']:.4f},"
            f" certify {row['certify_s']:.4f}; {row['walls']}), "
            f"{row['solves_per_s']:.1f} solves/s, "
            f"{row['certified_solves_per_s']:.1f} certified/s; the row's "
            f"launches {row['launches']}"))
        if row["certified"] < theirs - slack:
            raise RuntimeError(f"horizon_sweep S={S} {row['backend']}: "
                               f"certified {row['certified']}, fewer than "
                               f"the record's {theirs} - {slack}")
    micro = [sp.run_kernel_micro(S, b, sp.batch_of(S), dev)
             for S, b in sp.sweep_rows() if b in sp.BACKENDS]
    for m in micro:
        if "skipped" in m:
            continue
        S, B, it = m["segments"], m["batch"], m["iters_per_epoch"]
        tr = sp.sweep_problem(S, m["backend"], "cpu")[0]
        m.update(bound_bbt_epoch(tr.bbt_structure(), B, it)
                 if m["backend"] == "bbt" else
                 bound_admm_epoch(B, tr.nlp.n, tr.nlp.m, it))
        say("horizon_sweep", f"epoch micro (20 back-to-back, outside the "
                             f"path's count): {m}")
    return rows, micro, launches


def phase_parity_sweep(grec, rows, dev, results):
    """After the sweep: kernel 1 at S=4 (B=256) and S=8 (B=128), kernel 7
    at K=252 (S=4, B=256) on the rows' first epochs by the F64 rule and on
    random well-conditioned inputs of their shapes, and kernels 3-5 on the
    S=4 certify's Newton matrices (K=252) by the residual gate (the
    kernels hold K=252; the certify itself solves K > 206 by LU, as the
    JAX package does)."""
    import torch
    from polympc_torch import scaling_point as sp
    from polympc_torch.nlp.refine import newton_system
    from polympc_torch.ops import admm_epoch as ae
    from polympc_torch.ops import bbt_kernel as bk
    from polympc_torch.parallel import pin_initial_state
    rng = np.random.default_rng(29)
    for S in (4, 8):
        B = sp.batch_of(S)
        qs, first = sp.first_epoch(S, "bbt", B, dev, grec[f"s{S}_x0s"])
        st = qs.structure
        epoch = bk.prepare_epoch(*first, st)
        ep = (qs.sigma, qs.alpha, qs.check_every)
        err = check_against_f64("bbt_epoch", bk.bbt_epoch,
                                bk.bbt_epoch_plain, epoch, (st, *ep))
        case = random_epoch(st, B, rng, dev)
        rel = check_tight("bbt_epoch", bk.bbt_epoch, bk.bbt_epoch_plain,
                          case, (st, *ep), EPOCH_RTOL)
        relm = check_tight("bbt_epoch (mirror)", bk.bbt_epoch,
                           bk.bbt_epoch_mirror, case, (st, *ep), MIRROR_RTOL)
        results["bbt_epoch"][f"sweep_S{S}"] = {
            **err, **timing(lambda: bk.bbt_epoch(*epoch, st, *ep),
                            lambda: bk.bbt_epoch_plain(*epoch, st, *ep),
                            None, bound_bbt_epoch(st, B, qs.check_every)),
            **by_threads(bk, epoch, st, ep),
            "random_rel_vs_plain": rel, "random_rel_vs_mirror": relm,
            "shape": f"B={B} S={st.S} k={st.k} nx={st.nx} "
                     f"iters={qs.check_every}"}
        say("parity", f"bbt_epoch at the sweep's S={S} first epoch: "
                      f"{results['bbt_epoch'][f'sweep_S{S}']}")
    S, B = 4, sp.batch_of(4)
    qs, epoch = sp.first_epoch(S, "dense", B, dev, grec["s4_x0s"])
    n, m = epoch[1].shape[1], epoch[2].shape[1]
    kw = dict(sigma=qs.sigma, alpha=qs.alpha, iters=qs.check_every)
    kern, plain = epoch_fns(**kw)
    err = check_against_f64("admm_epoch (sweep S=4)", kern, plain, epoch, ())
    rel = check_tight("admm_epoch (sweep S=4 shape)", kern, plain,
                      random_dense_epoch(n, m, B, rng, dev), (), EPOCH_RTOL)
    results["admm_epoch"]["sweep_K252"] = {
        **err, **timing(lambda: kern(*epoch), lambda: plain(*epoch), None,
                        bound_admm_epoch(B, n, m, qs.check_every)),
        "random_rel_vs_plain": rel,
        "shape": f"B={B} n={n} m={m} iters={qs.check_every}",
        "launch": epoch_launch(ae, n, m)}
    say("parity", f"admm_epoch at the sweep's S=4 first epoch B={B} "
                  f"K={n + m}: {results['admm_epoch']['sweep_K252']}")
    lanes = next(ln for row, ln in rows
                 if (row["segments"], row["backend"]) == (4, "bbt"))
    tr, bounds, _, _ = sp.sweep_problem(4, "bbt", dev)
    prm64 = tr.params(d=[0.05], t0=0.0, tf=2.0, dtype=torch.float64,
                      device=dev)
    b64 = bounds._replace(**{f: getattr(bounds, f).double()
                             for f in bounds._fields})
    bnd64, _ = pin_initial_state(tr, b64, torch.as_tensor(
        grec["s4_x0s"], dtype=torch.float64, device=dev))
    f32 = lambda k: torch.as_tensor(lanes[k], dtype=torch.float32,
                                    device=dev)
    Ms, rs = newton_system(tr.nlp, f32("x"), f32("lam"), bnd64, prm64,
                           matrix_dtype=torch.float32)
    M32, r32 = Ms.float().contiguous(), rs.float().contiguous()
    out = refine_checks(Ms, M32, r32)
    for name in ("ldlt_factor_solve", "ldlt_solve", "ldlt_factor"):
        results[name]["sweep_K252"] = {**out[name],
                                       "shape": f"B={B} K={r32.shape[1]}"}
        say("parity", f"{name} at the sweep's S=4 certify matrices B={B} "
                      f"K={r32.shape[1]}: {out[name]}")


def phase_long_horizon(lrec, card, dev):
    """The long-horizon batch (S=512, B=32, float64) against the JAX
    record, then its one-rank NCCL Newton step (lanes 0-3) against the
    mesh-less step, bit for bit.  The path launches no kernel of the
    port."""
    from polympc_torch import long_horizon_point as lp
    if not np.array_equal(lp.lane_x0s(), lrec["x0s"]):
        raise RuntimeError("long_horizon: the record's x0s are not the "
                           "harness's draw")
    (summary, lanes), launches = run_path(
        "long_horizon", lambda: lp.run(device=dev), ())
    if any(launches.values()):
        raise RuntimeError(f"long_horizon launched kernels: {launches}")
    defect, cont = lanes["defect"][-1], lanes["continuity"][-1]
    diffs = {
        "boundary": float(np.abs(lanes["boundary"]
                                 - lrec["boundary"]).max()),
        "Z01": float(np.abs(lanes["Z"][:2] - lrec["Z01"]).max()),
        "defect_hist": float(np.abs(lanes["defect"] - lrec["defect"]).max()),
        "continuity_hist": float(np.abs(lanes["continuity"]
                                        - lrec["continuity"]).max())}
    say("long_horizon", f"{card}: {json.dumps(summary)}")
    say("long_horizon", (
        f"{card}: final defect max {defect.max():.3e} (record "
        f"{lrec['defect'][-1].max():.3e}), continuity max {cont.max():.3e} "
        f"(record {lrec['continuity'][-1].max():.3e}); against the record: "
        f"{diffs}; per-lane final defect {defect.tolist()}"))
    if not (np.isfinite(lanes["Z"]).all() and lanes["Z"].shape
            == (lp.LANES, lp.SEGMENTS, lrec["Z01"].shape[-1])):
        raise RuntimeError("long_horizon: Z not finite or of the wrong "
                           "shape")
    if not (defect.max() <= LH_DEFECT_TOL
            and cont.max() <= LH_CONTINUITY_TOL
            and diffs["boundary"] <= LH_RECORD_ATOL
            and diffs["Z01"] <= LH_RECORD_ATOL):
        raise RuntimeError(f"long_horizon: a gate failed (defect <= "
                           f"{LH_DEFECT_TOL}, continuity <= "
                           f"{LH_CONTINUITY_TOL}, boundary and Z01 within "
                           f"{LH_RECORD_ATOL} of the record)")
    summary.update(diffs, sharded=long_horizon_sharded(lrec, card, dev))
    return summary, launches


def long_horizon_sharded(lrec, card, dev):
    """One Newton step of the first lanes of the long-horizon batch from
    their constant guess, on horizon_mesh(1) in a one-rank NCCL group
    (this rank builds every segment's block and gathers over a group of
    one), against the mesh-less step: Z, LAM and cont bit for bit."""
    import torch
    import torch.distributed as dist
    from polympc_torch import long_horizon_point as lp
    from polympc_torch.multichip_point import free_port
    from polympc_torch.parallel import horizon_mesh, initialize_multihost
    from polympc_torch.parallel.long_horizon import long_horizon_newton_step
    lh = lp.long_horizon()
    x0 = torch.as_tensor(lrec["x0s"][:LH_SHARDED_LANES],
                         dtype=torch.float64, device=dev)
    Z = lh.initial_guess(x0, device=dev)
    LAM = Z.new_zeros((*Z.shape[:-1], lh.ne))
    plain = long_horizon_newton_step(lh, Z, LAM, x0)
    backend = "nccl" if torch.device(dev).type == "cuda" else "gloo"
    initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0, device=dev)
    try:
        if dist.get_backend() != backend:
            raise RuntimeError(f"long_horizon: the group runs "
                               f"{dist.get_backend()}, not {backend}")
        mesh = horizon_mesh(1)
        long_horizon_newton_step(lh, Z, LAM, x0, mesh=mesh)
        sync()
        t0 = time.perf_counter()
        sharded = long_horizon_newton_step(lh, Z, LAM, x0, mesh=mesh)
        sync()
        secs = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    same = {n: bool(torch.equal(a, b))
            for n, a, b in zip(("Z", "LAM", "cont"), sharded, plain)}
    say("long_horizon", f"{card}: one {backend} rank, horizon_mesh(1), lanes "
                        f"0-{LH_SHARDED_LANES - 1}: one Newton step "
                        f"{secs * 1e3:.3f} ms; equal to the mesh-less step "
                        f"bit for bit {same}; one card: several cards did "
                        f"not run")
    if not all(same.values()):
        raise RuntimeError("long_horizon: the sharded Newton step differs "
                           "from the mesh-less step")
    return {"step_ms": secs * 1e3, "bitwise": same}


def phase_parity_lanes(dev):
    """The lane-major LDL^T entry points (the JAX package's (K, K, B)
    layout) against the batch-first calls on the same matrices, bit for
    bit, at the kite refine's K=132, B=512 (outside every path's
    count)."""
    import torch
    from polympc_torch.ops import ldlt
    rng = np.random.default_rng(37)
    M, b = diag_dominant(512, 132, rng, dev)
    Ml, bl = M.movedim(0, -1).contiguous(), b.movedim(0, -1).contiguous()
    F, d = ldlt.ldlt_factor(M)
    x, F2, d2 = ldlt.ldlt_factor_solve(M, b)
    checks = {
        "ldlt_factor_lanes": (ldlt.ldlt_factor_lanes(Ml), (F, d)),
        "ldlt_factor_solve_lanes": (ldlt.ldlt_factor_solve_lanes(Ml, bl),
                                    (x, F2, d2)),
        "ldlt_solve_lanes": ((ldlt.ldlt_solve_lanes(
            F.movedim(0, -1), d.movedim(0, -1), bl),),
            (ldlt.ldlt_solve(F, d, b),)),
        "ldlt_inverse_lanes": ((ldlt.ldlt_inverse_lanes(Ml),),
                               (ldlt.ldlt_inverse(M),))}
    same = {n: all(bool(torch.equal(g, w.movedim(0, -1)))
                   for g, w in zip(got, want))
            for n, (got, want) in checks.items()}
    sync()
    say("parity", f"lane-major LDL^T entry points against the batch-first "
                  f"calls at B=512 K=132, bit for bit: {same}")
    if not all(same.values()):
        raise RuntimeError("a lane-major LDL^T entry point differs from "
                           "its batch-first call")


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
    start = time.perf_counter()
    card, smi = phase_device()
    import_port()
    ref = dict(np.load(REFERENCE))
    rec = dict(np.load(HEADLINE_REFERENCE))
    drec = dict(np.load(DIST_REFERENCE))
    crec = dict(np.load(CSTR_REFERENCE))
    srec = dict(np.load(SOLVERS_REFERENCE))
    orec = dict(np.load(OCP_EXTRAS_REFERENCE))
    grec = dict(np.load(SCALING_REFERENCE))
    lrec = dict(np.load(LONG_HORIZON_REFERENCE))
    phase_build()
    parity = phase_parity(ref, "cuda")
    phase_parity_dense("cuda", parity)
    phase_parity_race_car("cuda", parity)
    phase_parity_dist(drec, "cuda", parity)
    phase_parity_cstr(crec, "cuda", parity)
    phase_parity_kite_ms(orec, "cuda", parity)
    paths = {"kite": phase_kite(ref, smi, "cuda"),
             "spline_qp": phase_spline(rec, smi, "cuda")[1],
             "frame_transform": phase_frame(rec, smi, "cuda")[1],
             "race_car": phase_race_car(rec, smi, "cuda")[1]}
    _, dist_lanes, paths["dist_kite_s8"] = phase_dist(drec, smi, "cuda")
    paths["dist_sharded"] = phase_dist_sharded(drec, dist_lanes, smi,
                                               "cuda")[1]
    _, cstr_lanes, paths["cstr_b256"] = phase_cstr(crec, smi, "cuda")
    phase_parity_cstr_refine(crec, cstr_lanes, "cuda", parity)
    paths["mpc"] = phase_mpc(smi, "cuda")[1]
    paths["kite_ip_b512"] = phase_kite_ip(srec, smi, "cuda")[1]
    paths["mpc_ip"] = phase_mpc_ip(smi, "cuda")[1]
    paths["qp_solvers"] = phase_qp_solvers(srec, smi, "cuda")[1]
    paths["lqr"] = phase_lqr(smi, "cuda")[1]
    paths["nlp_extras"] = phase_nlp_extras(smi, "cuda")[1]
    _, ms_lanes, paths["kite_ms_b512"] = phase_kite_ms(orec, smi, "cuda")
    phase_parity_kite_ms_refine(orec, ms_lanes, "cuda", parity)
    paths["ocp_extras"] = phase_ocp_extras(orec, smi, "cuda")[1]
    sweep_rows, _, paths["horizon_sweep"] = phase_horizon_sweep(
        grec, smi, "cuda")
    phase_parity_sweep(grec, sweep_rows, "cuda", parity)
    paths["long_horizon"] = phase_long_horizon(lrec, smi, "cuda")[1]
    phase_parity_lanes("cuda")
    kernels = []
    for n, src, rep in KERNELS:
        by_path = {p: c[n] for p, c in paths.items()}
        kernels.append({"name": n, "route": "cuda", "source": src,
                        "replaces": rep, "launches": sum(by_path.values()),
                        "launches_by_path": by_path, **parity[n]})
    say("smoke", f"{smi}: the run took {time.perf_counter() - start:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
