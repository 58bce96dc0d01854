#!/usr/bin/env python3
"""Time the BBT epoch, the BBT solve and the explicit-inverse kernels of
several source trees in one process on one NVIDIA card, in turns.

    python3 kernel_ab.py DIR [DIR ...]

Each DIR holds kernel sources with the port's C interface (bbt_epoch.cu,
ldlt.cu and the ldlt_device.cuh they include): polympc_torch/csrc of this
checkout, or of another commit unpacked with `git archive` into a directory
that .gitignore lists (build/, say).  Each is compiled by nvcc for sm_90a
into its own library under build/kernel_ab/ and bound with the argument
types of ops/_build.py.  The inputs are made once from a seed by
chip_smoke.py's own helpers (random diagonally dominant quasi-definite KKTs
in the kite's and the race car's BBT patterns, B=512, 50 ADMM iterations;
random quasi-definite matrices, B=1024, K=72) and every library runs them
in turn, first to last and back: the epoch at 128 and 256 threads per
block, the solve and the inverse at 256.  A time is chip_smoke.cuda_ms's:
the median of 10 samples, each of back-to-back launches filling about 2 ms
between two CUDA events.  Each library's epoch is also held against the
PyTorch mirror of the redesigned kernel's algorithm (its largest per-lane
relative difference is printed, not gated).

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


def build(src):
    """Compile src/bbt_epoch.cu and src/ldlt.cu into one library."""
    from polympc_torch.ops import _build
    tag = hashlib.sha256(os.path.abspath(src).encode()).hexdigest()[:12]
    os.makedirs(OUT, exist_ok=True)
    nvcc = _build._nvcc()
    objs, procs = [], []
    for f in ("bbt_epoch.cu", "ldlt.cu"):
        obj = os.path.join(OUT, f"{tag}_{f}.o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *_build.FLAGS, "-I", src, "-c", "-o", obj,
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
    dirs = sys.argv[1:]
    libs = {d: build(d) for d in dirs}
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


if __name__ == "__main__":
    main()
