"""Dense active-set QP solve (native Goldfarb-Idnani, host CPU) — the port
of polympc_tpu/qp/active_set.py.

The analogue of the reference's QPMAD interface
(src/solvers/qpmad_interface.hpp:18-126).  Active-set pivoting is
data-dependent sequential control flow, so the solver is C++ on the host
(``polympc_torch/native/qpmad.cpp``, the JAX package's source) in both
packages: use it for small set-up QPs and as an independent high-accuracy
oracle against the ADMM and interior-point solvers.  The duals follow the
common ``Hx + h + A'y + y_box = 0`` convention.

Host execution is this solver's contract, not a fallback: each lane's data
is copied to the CPU in float64, solved there lane after lane, and the
results are moved back to the caller's device and dtype.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from polympc_torch.native import load_native
from polympc_torch.qp.types import QPData, QPSolution

__all__ = ["qp_active_set_solve"]

_f64p = ctypes.POINTER(ctypes.c_double)


def _lib():
    fn = load_native("qpmad").qpmad_solve
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int,
                   _f64p, _f64p, _f64p, _f64p, _f64p, _f64p, _f64p,
                   _f64p, _f64p, _f64p,
                   ctypes.c_int, ctypes.c_double,
                   ctypes.POINTER(ctypes.c_int)]
    return fn


def qp_active_set_solve(qp: QPData, max_iter: int = 500,
                        tol: float = 1e-10) -> QPSolution:
    """Solve a batch of QPs (every tensor of ``qp`` with a leading lane axis
    B) exactly, to working precision, with the native dual active-set
    method on the host, one lane after another.  H must be positive
    definite on every lane.  Returns a batched QPSolution on the caller's
    device and dtype (res_prim, res_dual and rho are zero)."""
    dt, dev = qp.H.dtype, qp.H.device
    host = [np.ascontiguousarray(t.detach().to("cpu", torch.float64).numpy())
            for t in qp]
    H, h, A, al, au, xl, xu = host
    B, n = h.shape
    m = al.shape[1]
    x = np.zeros((B, n))
    y = np.zeros((B, max(m, 1)))
    ybox = np.zeros((B, n))
    status = np.zeros(B, np.int32)
    iters = np.zeros(B, np.int32)
    solve = _lib()
    p = lambda a: a.ctypes.data_as(_f64p)
    for b in range(B):
        lane = [np.ascontiguousarray(a[b]) for a in host]
        out = [np.zeros(n), np.zeros(max(m, 1)), np.zeros(n)]
        it = ctypes.c_int(0)
        status[b] = solve(n, m, *(p(a) for a in lane), *(p(o) for o in out),
                          max_iter, tol, ctypes.byref(it))
        x[b], y[b], ybox[b] = out
        iters[b] = it.value
    back = lambda a, kind=dt: torch.as_tensor(a, dtype=kind, device=dev)
    zero = torch.zeros(B, dtype=dt, device=dev)
    return QPSolution(x=back(x), y=back(y[:, :m]), y_box=back(ybox),
                      status=back(status, torch.int32),
                      iters=back(iters, torch.int32), res_prim=zero,
                      res_dual=zero.clone(),
                      rho=torch.zeros((B, m), dtype=dt, device=dev))
