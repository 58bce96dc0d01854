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
beside the package, keyed by a hash of the source, so an edited source
rebuilds and a stale library is never loaded.  Nothing builds at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

__all__ = ["load_native", "NativeBuildError", "BUILD_DIR"]

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent.parent / "build" / "polympc_torch_native"
_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


class NativeBuildError(RuntimeError):
    pass


def load_native(name: str) -> ctypes.CDLL:
    """Compile (if needed) and load ``<name>.cpp`` as a shared library."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        src = _DIR / f"{name}.cpp"
        digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
        so = BUILD_DIR / f"_{name}_{digest}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(so.name + f".tmp{os.getpid()}")
            cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared",
                   "-fPIC", "-o", str(tmp), str(src)]
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
