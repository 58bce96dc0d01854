#!/usr/bin/env python3
"""Time the kernels of several source trees in one process on one NVIDIA
card, in turns, and print how far their outputs differ.

    python3 kernel_ab.py [--nvcc=FLAG ...] DIR [DIR ...]

Each DIR holds kernel sources with the port's C interface (bbt_epoch.cu,
ldlt.cu, admm_epoch.cu and the ldlt_device.cuh they include):
polympc_torch/csrc of this checkout, or of another commit unpacked with
`git archive` into a directory that .gitignore lists (build/, say).  Each
is compiled by nvcc for sm_90a into its own library under build/kernel_ab/
and bound with the argument types of ops/_build.py.  The inputs are made
once from a seed by chip_smoke.py's own helpers and every library runs
them in turn, first to last and back:

  * the BBT epoch (random diagonally dominant quasi-definite KKTs in the
    kite's and the race car's BBT patterns, B=512, 50 ADMM iterations) at
    128 and 256 threads per block, held against the PyTorch mirror of its
    algorithm (the largest per-lane relative difference, not gated), and
    the BBT solve at 256;
  * the explicit inverse (random quasi-definite, B=1024, K=72) at 256;
  * the LDL^T factor + solve, solve and factor (diagonally dominant
    indefinite matrices, B=512, K=132 and 165) at 256;
  * the dense boxADMM epoch (random quasi-definite KKTs at the spline QP's
    shape, B=4096, n=32, m=15, and at K=132, B=512, n=77, m=55; 25
    iterations) at every block size of 32, 64, 128 and 256 threads that a
    library takes.

A time is chip_smoke.cuda_ms's: the median of 10 samples, each of
back-to-back launches filling about 2 ms between two CUDA events.  Each
--nvcc=FLAG adds FLAG to every compilation (--nvcc=-fmad=false, say, to
hold two trees' outputs apart from the compiler's fused multiply-adds).  For the
LDL^T kernels and the epoch each line also prints the largest |first DIR -
other| of the outputs on the same inputs ("max_abs_diff"; for F its upper
triangle and d, the lower triangle being the recurrence's scratch in one
design and zeros in another).

Prints the card's name and power limit, then one JSON line per shape.
Needs a card and nvcc; imports nothing of JAX.
"""
import ctypes
import hashlib
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "build", "kernel_ab")


SOURCES = ("bbt_epoch.cu", "ldlt.cu", "admm_epoch.cu")


def build(src, extra=()):
    """Compile src's kernel sources into one library."""
    from polympc_torch.ops import _build
    tag = hashlib.sha256(" ".join((os.path.abspath(src),) + tuple(
        extra)).encode()).hexdigest()[:12]
    os.makedirs(OUT, exist_ok=True)
    nvcc = _build._nvcc()
    objs, procs = [], []
    for f in SOURCES:
        obj = os.path.join(OUT, f"{tag}_{f}.o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *_build.FLAGS, *extra, "-I", src, "-c", "-o", obj,
             os.path.join(src, f)]))
    if any(p.wait() for p in procs):
        raise RuntimeError(f"nvcc failed on {src}")
    lib = os.path.join(OUT, f"{tag}.so")
    subprocess.run([nvcc, *_build.ARCH, "-shared", "-o", lib, *objs],
                   check=True)
    lib = ctypes.CDLL(lib)
    for name, (res, args) in _build._SIGNATURES.items():
        if hasattr(lib, name):
            getattr(lib, name).restype = res
            getattr(lib, name).argtypes = args
    return lib


def in_turns(dirs, launch, out_of=None):
    """launch(lib) -> a function that launches once and returns its C
    error code; each library timed first to last and back."""
    import chip_smoke as cs
    ms, out = {d: [] for d in dirs}, {}
    for d in dirs + dirs[::-1]:
        fn, result = launch(d)
        if fn() != 0:
            raise RuntimeError(f"{d}: launch failed")
        ms[d].append(cs.cuda_ms(fn))
        if out_of is not None:
            out[d] = out_of(result)
    return ms, out


def max_abs_diff(outs):
    """Largest |first - other| over the libraries' outputs (tuples of
    tensors), or None with one library."""
    first, *rest = list(outs.values())
    if not rest:
        return None
    return max((a - b).abs().max().item() for o in rest
               for a, b in zip(first, o))


def ldlt_lines(dirs, libs, stream):
    """The LDL^T factor + solve, solve and factor at B=512, K=132 and 165."""
    import torch
    import chip_smoke as cs
    from polympc_torch.ops import ldlt
    rng = np.random.default_rng(3)
    for K in (132, 165):
        A, b = cs.diag_dominant(512, K, rng, "cuda")
        B = A.shape[0]
        upper = torch.triu(torch.ones(K, K, dtype=torch.bool,
                                      device="cuda"))
        Fp, dp = ldlt.ldlt_factor_plain(A)
        calls = {
            "ldlt_factor_solve": lambda lib, x, F, d: lib.pt_ldlt_factor_solve_f32(
                A.data_ptr(), b.data_ptr(), x.data_ptr(), F.data_ptr(),
                d.data_ptr(), B, K, 256, stream),
            "ldlt_solve": lambda lib, x, F, d: lib.pt_ldlt_solve_f32(
                Fp.data_ptr(), dp.data_ptr(), b.data_ptr(), x.data_ptr(), B,
                K, 256, stream),
            "ldlt_factor": lambda lib, x, F, d: lib.pt_ldlt_factor_f32(
                A.data_ptr(), F.data_ptr(), d.data_ptr(), B, K, 256,
                stream)}
        for name, call in calls.items():
            def launch(dd, call=call):
                out = (torch.zeros_like(b), torch.zeros_like(A),
                       torch.zeros_like(b))
                return (lambda: call(libs[dd], *out)), out
            ms, outs = in_turns(dirs, launch, lambda o: (
                o[0], o[1][:, upper], o[2]))
            print(json.dumps({"kernel": name, "shape": f"B={B} K={K}",
                              "threads": 256, "ms": ms,
                              "max_abs_diff": max_abs_diff(outs)}),
                  flush=True)


def epoch_lines(dirs, libs, stream):
    """The dense boxADMM epoch at the spline QP's shape and at K=132."""
    import torch
    import chip_smoke as cs
    rng = np.random.default_rng(4)
    for n, m, B in ((32, 15, 4096), (77, 55, 512)):
        args = [t.contiguous() for t in cs.random_dense_epoch(n, m, B, rng,
                                                              "cuda")]
        outs, ms = {}, {}
        for threads in (32, 64, 128, 256):
            def launch(dd, threads=threads):
                out = [torch.empty_like(args[i]) for i in (8, 9, 10, 11, 12)]
                return (lambda: libs[dd].pt_admm_epoch_f32(
                    *(t.data_ptr() for t in args),
                    *(t.data_ptr() for t in out), B, n, m, 1e-6, 1.6, 25,
                    threads, stream)), out
            ok = []
            for d in dirs:
                fn, _ = launch(d)
                if fn() == 0:
                    ok.append(d)
            torch.cuda.synchronize()
            if not ok:
                continue
            t_ms, t_out = in_turns(ok, launch, tuple)
            for d in ok:
                ms.setdefault(d, {})[threads] = t_ms[d]
                outs.setdefault(d, t_out[d])
        print(json.dumps({"kernel": "admm_epoch", "shape": f"B={B} n={n} "
                          f"m={m} iters=25", "ms_by_threads": ms,
                          "max_abs_diff": max_abs_diff(outs)}), flush=True)


def main():
    import torch
    if not torch.cuda.is_available() or len(sys.argv) < 2:
        raise SystemExit("usage: kernel_ab.py DIR [DIR ...] on a machine "
                         "with a CUDA card")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from polympc_torch.headline import kite_problem
    from polympc_torch.ops import bbt_kernel as bk
    from polympc_torch.ops.structure import _indices, bbt_structure
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    extra = [a[len("--nvcc="):] for a in sys.argv[1:]
             if a.startswith("--nvcc=")]
    dirs = [a for a in sys.argv[1:] if not a.startswith("--nvcc=")]
    if extra:
        print(f"extra nvcc flags: {extra}", flush=True)
    libs = {d: build(d, extra) for d in dirs}
    stream = torch.cuda.current_stream().cuda_stream
    shapes = (("kite", kite_problem("cpu")[3].qp.structure),
              ("race_car", bbt_structure(11, 6, 3, 0, 0, 0, 5, 2)))
    for name, st in shapes:
        Td, Oh, Ct, Dp, vin = [t.contiguous() for t in cs.random_epoch(
            st, 512, np.random.default_rng(1), "cuda")]
        bx = _indices(st, Td.device)["bx"]
        B, L = Td.shape[0], st.S * st.k + st.a
        ref = bk.bbt_epoch_mirror(Td, Oh, Ct, Dp, vin, st, 1e-6, 1.6, 50)
        for threads in bk._THREADS:
            def launch(d):
                vout = torch.empty((B, 3, L), device="cuda")
                return (lambda: libs[d].pt_bbt_epoch_f32(
                    Td.data_ptr(), Oh.data_ptr(), Ct.data_ptr(),
                    Dp.data_ptr(), vin.data_ptr(), vout.data_ptr(),
                    bx.data_ptr(), B, st.S, st.k, st.nx, st.a, 1e-6, 1.6,
                    50, threads, stream)), vout
            ms, diff = in_turns(dirs, launch, lambda v: cs.lane_rel(
                v - ref, ref).max().item())
            print(json.dumps({"kernel": "bbt_epoch", "shape": f"{name} B={B} "
                              f"S={st.S} k={st.k} iters=50",
                              "threads": threads, "ms": ms,
                              "rel_vs_mirror": diff}), flush=True)
        rhs = vin[:, 0].contiguous()

        def launch(d):
            out = torch.empty_like(rhs)
            return (lambda: libs[d].pt_bbt_solve_f32(
                Td.data_ptr(), Oh.data_ptr(), Ct.data_ptr(), Dp.data_ptr(),
                rhs.data_ptr(), out.data_ptr(), bx.data_ptr(), B, st.S,
                st.k, st.nx, st.a, bk._SOLVE_THREADS, stream)), None
        ms, _ = in_turns(dirs, launch)
        print(json.dumps({"kernel": "bbt_solve", "shape": f"{name} B={B} "
                          f"S={st.S} k={st.k}",
                          "threads": bk._SOLVE_THREADS, "ms": ms}),
              flush=True)
    nz, m, B = 42, 30, 1024
    M = cs.quasi_definite(B, nz, m, np.random.default_rng(2), "cuda")

    def launch(d):
        inv = torch.empty_like(M)
        return (lambda: libs[d].pt_ldlt_inverse_f32(
            M.data_ptr(), inv.data_ptr(), B, nz + m, 256, stream)), None
    ms, _ = in_turns(dirs, launch)
    print(json.dumps({"kernel": "ldlt_inverse", "shape": f"B={B} K={nz + m}",
                      "threads": 256, "ms": ms}), flush=True)
    ldlt_lines(dirs, libs, stream)
    epoch_lines(dirs, libs, stream)


if __name__ == "__main__":
    main()
