"""Build and load the hand-written CUDA kernels (``polympc_torch/csrc``).

The sources have a plain C interface: ``nvcc`` compiles them for sm_90a into
one shared library at first use, and ``ctypes`` loads it.  The library is
named by a hash of the sources and flags and lives in
``build/polympc_torch_kernels/`` beside the package, so an unchanged tree
reuses it and a changed one rebuilds.  Nothing here runs at import time:
the first CUDA launch calls :func:`library`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

__all__ = ["library", "build", "check", "LAUNCHES", "reset_launches",
           "SMEM_LIMIT_BYTES", "SWEEP_MAX_K", "check_sweep", "blocks_per_sm"]

# dynamic shared memory one block may opt into on sm_90 (232,448 bytes)
SMEM_LIMIT_BYTES = 227 * 1024
# an H100 SM: 228 KB of shared memory, of which each resident block takes
# 1 KB for itself beside its own; 2048 threads; 32 blocks
SM_SMEM_BYTES = 228 * 1024
SM_BLOCK_RESERVED_BYTES = 1024
SM_THREADS = 2048
SM_BLOCKS = 32

# Threads per block -> the largest block the Gauss-Jordan sweep's register
# tile holds (csrc/ldlt_device.cuh, with_tile: ceil(k / 32) rows per lane,
# up to 6 at 8 warps and 4 at 4).
SWEEP_MAX_K = {128: 128, 256: 192}

# Launch count of each kernel: its wrapper adds one where it launches the
# kernel on the card and nowhere else (the plain versions do not count).
LAUNCHES = {"bbt_epoch": 0, "bbt_solve": 0, "admm_epoch": 0,
            "ldlt_factor": 0, "ldlt_factor_solve": 0, "ldlt_solve": 0,
            "ldlt_inverse": 0}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
SOURCES = ("bbt_epoch.cu", "ldlt.cu", "admm_epoch.cu")
HEADERS = ("ldlt_device.cuh",)
BUILD_DIR = _PKG.parent / "build" / "polympc_torch_kernels"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P, _I, _F, _Z = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_size_t
_SIGNATURES = {
    "pt_bbt_epoch_f32": (_I, [_P] * 7 + [_I] * 5 + [_F, _F, _I, _I, _P]),
    "pt_bbt_solve_f32": (_I, [_P] * 7 + [_I] * 5 + [_I, _P]),
    "pt_bbt_epoch_smem_bytes": (_Z, [_I] * 4),
    "pt_bbt_solve_smem_bytes": (_Z, [_I] * 4),
    "pt_bbt_tile_fits": (_I, [_I] * 3),
    "pt_bbt_epoch_blocks_per_sm": (_I, [_I] * 5),
    "pt_admm_epoch_f32": (_I, [_P] * 18 + [_I, _I, _I, _F, _F, _I, _I, _P]),
    "pt_admm_epoch_smem_bytes": (_Z, [_I] * 3),
    "pt_admm_epoch_blocks_per_sm": (_I, [_I] * 3),
    "pt_ldlt_factor_f32": (_I, [_P] * 3 + [_I, _I, _I, _P]),
    "pt_ldlt_factor_solve_f32": (_I, [_P] * 5 + [_I, _I, _I, _P]),
    "pt_ldlt_solve_f32": (_I, [_P] * 4 + [_I, _I, _I, _P]),
    "pt_ldlt_smem_bytes": (_Z, [_I]),
    "pt_ldlt_blocks_per_sm": (_I, [_I, _I]),
    "pt_ldlt_inverse_f32": (_I, [_P] * 2 + [_I, _I, _I, _P]),
    "pt_ldlt_inverse_smem_bytes": (_Z, [_I]),
    "pt_ldlt_inverse_fits": (_I, [_I]),
    "pt_error_string": (ctypes.c_char_p, [_I]),
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(FLAGS).encode())
    return h.hexdigest()[:16]


def build(verbose: bool = False):
    """Compile the kernels into the build directory (if not already there)
    and return ``(path, seconds, compiler_output)``: one ``nvcc`` per
    source, all started together, then one link.  ``verbose`` adds
    ``-Xptxas -v`` (registers, shared memory and spills per kernel), which
    leaves the binary as it is."""
    extra = ("-Xptxas", "-v") if verbose else ()
    out = BUILD_DIR / f"libpolympc_torch_kernels_{_digest()}.so"
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (Path(s).stem + ".o") for s in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *FLAGS, *extra, "-I", str(CSRC), "-c", "-o", str(obj),
             str(CSRC / src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        for src, p, log in zip(SOURCES, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        lib = Path(tmp) / out.name
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(lib),
                               *(str(o) for o in objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout
                               + link.stderr)
        os.replace(lib, out)
    return out, time.perf_counter() - t0, "".join(logs)


def library():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            path, _, _ = build()
            lib = ctypes.CDLL(str(path))
            for name, (res, args) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = res
                fn.argtypes = args
            _lib = lib
        return _lib


def check(rc: int, what: str):
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = library().pt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def check_smem(smem: int, what: str):
    """Raise, naming the shape, if a kernel needs more shared memory than a
    block can have."""
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(f"{what} needs {smem} bytes of shared memory per "
                         f"block, more than the {SMEM_LIMIT_BYTES} a Hopper "
                         "block can use")


def check_sweep(k: int, threads: int, what: str):
    """Raise, naming the shape, if the kernels are not built for blocks of
    k rows at this many threads per block (:data:`SWEEP_MAX_K`)."""
    if threads not in SWEEP_MAX_K:
        raise ValueError(f"{what}: {threads} threads per block; the kernels "
                         f"are built for {sorted(SWEEP_MAX_K)}")
    if k > SWEEP_MAX_K[threads]:
        raise ValueError(f"{what}: blocks of {k} rows; at {threads} threads "
                         "per block the sweep's register tile holds up to "
                         f"{SWEEP_MAX_K[threads]}")


def blocks_per_sm(smem: int, threads: int) -> int:
    """Blocks of ``threads`` threads and ``smem`` bytes of dynamic shared
    memory one H100 SM holds by those two counts alone (registers aside:
    the kernels' launch bounds keep them from being the limit, and
    ``chip_smoke.py`` holds this count against the occupancy API's)."""
    by_smem = SM_SMEM_BYTES // (smem + SM_BLOCK_RESERVED_BYTES)
    return min(by_smem, SM_THREADS // threads, SM_BLOCKS)


def stream_of(t):
    """The current CUDA stream of a tensor's device, as a raw handle."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
