"""Batched unpivoted LDL^T factor, factor+solve and solve — the port of
polympc_tpu/ops/ldlt.py (``ldlt_factor``, ``ldlt_factor_solve``,
``ldlt_solve``).

Storage convention (packed, one square + one diagonal per instance), as in
the JAX package:
  F[i, k] = L[k, i]   for k > i     (L^T in the strict upper triangle)
  d[i]    = D[i, i]                 (separate (K,) diagonal)
  lower triangle and diagonal of F = what the recurrence left there (the
  Schur-complement values; never read)

The factor is unpivoted on purpose: the certify pass (nlp/refine.py) feeds
it indefinite Newton-KKT matrices and its iterative-refinement sweeps are
tuned to this factor's growth, so a pivoted solve would change which lanes
certify.

Each function has a plain PyTorch version (``*_plain``) and a wrapper that
dispatches on the device: a CUDA float32 tensor launches the hand-written
kernel in ``csrc/ldlt.cu``, a CPU tensor takes the plain version, and any
other CUDA input raises.  Inputs are batch-major (B, K, K) / (B, K).
"""
from __future__ import annotations

import torch

from polympc_torch.ops import _build

__all__ = ["ldlt_factor", "ldlt_factor_solve", "ldlt_solve",
           "ldlt_factor_plain", "ldlt_factor_solve_plain", "ldlt_solve_plain"]

_THREADS = 256


def ldlt_factor_plain(M):
    """Packed unpivoted LDL^T of each (K, K) matrix: the JAX ``_factor_body``
    recurrence, K symmetric rank-1 updates of the trailing block.
    Returns (F (B, K, K), d (B, K))."""
    F = M.clone()
    K = F.shape[-1]
    d = F.new_empty(F.shape[:-1])
    for i in range(K):
        row = F[:, i, :].clone()
        di = row[:, i]
        dinv = 1.0 / di
        w = row[:, i + 1:]
        F[:, i + 1:, i + 1:] -= w[:, :, None] * (w * dinv[:, None])[:, None, :]
        F[:, i, i + 1:] = w * dinv[:, None]
        d[:, i] = di
    return F, d


def ldlt_solve_plain(F, d, b):
    """Solve (L D L^T) x = b against a packed factor: forward, diagonal and
    backward substitution.  F (B, K, K), d (B, K), b (B, K) -> x (B, K)."""
    L = torch.triu(F, diagonal=1).transpose(-1, -2)
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False,
                                      unitriangular=True)
    y = y / d[..., None]
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True,
                                      unitriangular=True)
    return x[..., 0]


def ldlt_factor_solve_plain(M, b):
    """Factor + one solve: (B, K, K), (B, K) -> (x, F, d)."""
    F, d = ldlt_factor_plain(M)
    return ldlt_solve_plain(F, d, b), F, d


def _check_cuda(name, *ts):
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernel takes float32, got "
                            f"{t.dtype}")
        if t.device != ts[0].device:
            raise ValueError(f"{name}: inputs on different devices")


def _shape(name, M, b):
    if M.dim() != 3 or M.shape[1] != M.shape[2] or b.shape != M.shape[:2]:
        raise ValueError(f"{name}: expected (B, K, K) and (B, K), got "
                         f"{tuple(M.shape)} and {tuple(b.shape)}")
    return M.shape[0], M.shape[1]


def ldlt_factor(M):
    """Batched packed LDL^T of symmetric quasi-definite (B, K, K) matrices:
    returns (F (B, K, K), d (B, K)) for :func:`ldlt_solve`.  The JAX
    package returns K rounded up to its sublane multiple; here F is K x K.

    CUDA float32 launches the ``csrc/ldlt.cu`` factor kernel (one thread
    block per matrix, the matrix in shared memory); CPU takes the plain
    version."""
    if M.dim() != 3 or M.shape[1] != M.shape[2]:
        raise ValueError(f"ldlt_factor: expected (B, K, K), got "
                         f"{tuple(M.shape)}")
    B, K = M.shape[0], M.shape[1]
    if M.device.type == "cpu":
        return ldlt_factor_plain(M)
    if M.device.type != "cuda":
        raise ValueError(f"ldlt_factor: no kernel for {M.device}")
    _check_cuda("ldlt_factor", M)
    lib = _build.library()
    _build.check_smem(lib.pt_ldlt_smem_bytes(K), f"ldlt_factor at K={K}")
    M = M.contiguous()
    F = torch.empty_like(M)
    d = M.new_empty((B, K))
    if B == 0:
        return F, d
    with torch.cuda.device(M.device):
        rc = lib.pt_ldlt_factor_f32(M.data_ptr(), F.data_ptr(), d.data_ptr(),
                                    B, K, _THREADS, _build.stream_of(M))
    _build.check(rc, "ldlt_factor")
    _build.LAUNCHES["ldlt_factor"] += 1
    return F, d


def ldlt_factor_solve(M, b):
    """Batched packed LDL^T factor + solve: (B, K, K), (B, K) -> (x, F, d).

    CUDA float32 launches the ``csrc/ldlt.cu`` kernel (one thread block per
    matrix, the matrix in shared memory); CPU takes the plain version."""
    B, K = _shape("ldlt_factor_solve", M, b)
    if M.device.type == "cpu":
        return ldlt_factor_solve_plain(M, b)
    if M.device.type != "cuda":
        raise ValueError(f"ldlt_factor_solve: no kernel for {M.device}")
    _check_cuda("ldlt_factor_solve", M, b)
    lib = _build.library()
    _build.check_smem(lib.pt_ldlt_smem_bytes(K),
                      f"ldlt_factor_solve at K={K}")
    M, b = M.contiguous(), b.contiguous()
    x = torch.empty_like(b)
    F = torch.empty_like(M)
    d = torch.empty_like(b)
    if B == 0:
        return x, F, d
    with torch.cuda.device(M.device):
        rc = lib.pt_ldlt_factor_solve_f32(
            M.data_ptr(), b.data_ptr(), x.data_ptr(), F.data_ptr(),
            d.data_ptr(), B, K, _THREADS, _build.stream_of(M))
    _build.check(rc, "ldlt_factor_solve")
    _build.LAUNCHES["ldlt_factor_solve"] += 1
    return x, F, d


def ldlt_solve(F, d, b):
    """Solve (L D L^T) x = b for a batch: F, d from :func:`ldlt_factor` or
    :func:`ldlt_factor_solve`, b (B, K) -> x (B, K)."""
    B, K = _shape("ldlt_solve", F, b)
    if d.shape != b.shape:
        raise ValueError(f"ldlt_solve: d has shape {tuple(d.shape)}, "
                         f"expected {tuple(b.shape)}")
    if F.device.type == "cpu":
        return ldlt_solve_plain(F, d, b)
    if F.device.type != "cuda":
        raise ValueError(f"ldlt_solve: no kernel for {F.device}")
    _check_cuda("ldlt_solve", F, d, b)
    lib = _build.library()
    _build.check_smem(lib.pt_ldlt_smem_bytes(K), f"ldlt_solve at K={K}")
    F, d, b = F.contiguous(), d.contiguous(), b.contiguous()
    x = torch.empty_like(b)
    if B == 0:
        return x
    with torch.cuda.device(F.device):
        rc = lib.pt_ldlt_solve_f32(F.data_ptr(), d.data_ptr(), b.data_ptr(),
                                   x.data_ptr(), B, K, _THREADS,
                                   _build.stream_of(F))
    _build.check(rc, "ldlt_solve")
    _build.LAUNCHES["ldlt_solve"] += 1
    return x
