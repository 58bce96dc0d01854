"""Native (C++) host-side components of the port.

Components whose algorithms are host-shaped by definition (sequential
pivoting, data-dependent control flow on tiny problems) are C++ shared
libraries compiled on first use with the system toolchain and called
through ctypes, as in the JAX package:

  * ``qpmad.cpp`` — the dense Goldfarb-Idnani dual active-set QP solver,
    the analogue of the reference's QPMAD interface
    (src/solvers/qpmad_interface.hpp:18-126); the port keeps its own copy
    of the JAX package's source, byte for byte.

:func:`load_native` builds with the JAX package's compiler and flags
(``g++ -O3 -march=native -std=c++17``) into ``build/polympc_torch_native/``
beside the package.  The library's file name is a hash of everything that
decides its machine code (:func:`build_key`): the source, the exact
command line, the compiler's ``--version`` text, and what ``-march=native``
means on this host (the compiler's expansion of it, or the CPU model and
flags where the compiler cannot say).  So an edited source, another
compiler or flag, or a ``build/`` carried to another machine rebuilds
instead of loading a stale library.  Nothing builds at import.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path

__all__ = ["load_native", "library_path", "build_key", "NativeBuildError",
           "BUILD_DIR", "COMPILER", "FLAGS"]

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent.parent / "build" / "polympc_torch_native"
COMPILER = "g++"
FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")
_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


class NativeBuildError(RuntimeError):
    pass


def _run(cmd) -> str:
    """stdout of a command, or "" where it cannot run."""
    try:
        return subprocess.run(cmd, capture_output=True, text=True,
                              check=True).stdout
    except (subprocess.CalledProcessError, OSError):
        return ""


@functools.lru_cache(maxsize=None)
def compiler_id(compiler: str = COMPILER) -> str:
    """The compiler's ``--version`` text."""
    return _run([compiler, "--version"])


@functools.lru_cache(maxsize=None)
def host_arch(compiler: str = COMPILER) -> str:
    """What ``-march=native`` selects on this host: the compiler's own
    expansion (``-march=native -Q --help=target``), else the CPU model and
    flags from /proc/cpuinfo."""
    out = _run([compiler, "-march=native", "-Q", "--help=target"])
    if out:
        return out
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return ""
    keep = [ln for ln in lines
            if ln.split(":")[0].strip() in ("model name", "flags")]
    return "\n".join(sorted(set(keep)))


def build_key(source: bytes, cmd, compiler_text: str, arch_text: str) -> str:
    """The 16-hex-digit name of a build: a hash of the source, the command
    line (without its output path), the compiler's version text and the
    host's ``-march=native`` expansion."""
    h = hashlib.sha256()
    for part in (source, "\0".join(cmd).encode(), compiler_text.encode(),
                 arch_text.encode()):
        h.update(hashlib.sha256(part).digest())
    return h.hexdigest()[:16]


def _command(src: Path):
    return [COMPILER, *FLAGS, str(src)]


def library_path(name: str) -> Path:
    """Where the library of ``<name>.cpp`` built here, now, lives."""
    src = _DIR / f"{name}.cpp"
    key = build_key(src.read_bytes(), _command(src), compiler_id(COMPILER),
                    host_arch(COMPILER))
    return BUILD_DIR / f"_{name}_{key}.so"


def load_native(name: str) -> ctypes.CDLL:
    """Compile (if needed) and load ``<name>.cpp`` as a shared library."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        src = _DIR / f"{name}.cpp"
        so = library_path(name)
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(so.name + f".tmp{os.getpid()}")
            cmd = _command(src)
            cmd[-1:-1] = ["-o", str(tmp)]
            try:
                subprocess.run(cmd, check=True, capture_output=True,
                               text=True)
            except (subprocess.CalledProcessError, FileNotFoundError) as e:
                detail = getattr(e, "stderr", str(e))
                raise NativeBuildError(
                    f"building {name}.cpp failed: {detail}") from e
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        _LIBS[name] = lib
        return lib
