"""Batched unpivoted LDL^T factor, factor+solve, solve and explicit inverse
— the port of polympc_tpu/ops/ldlt.py (``ldlt_factor``,
``ldlt_factor_solve``, ``ldlt_solve``, ``ldlt_inverse``).

Storage convention (packed, one square + one diagonal per instance), as in
the JAX package:
  F[i, k] = L[k, i]   for k > i     (L^T in the strict upper triangle)
  d[i]    = D[i, i]                 (separate (K,) diagonal)
  lower triangle and diagonal of F = what the recurrence left there (the
  Schur-complement values; never read)
The CUDA kernels hold only the upper triangle, packed by rows
(:func:`packed_offset`), and return F with the diagonal d and zeros in
the strict lower triangle; no caller reads that triangle.

The factor is unpivoted on purpose: the certify pass (nlp/refine.py) feeds
it indefinite Newton-KKT matrices and its iterative-refinement sweeps are
tuned to this factor's growth, so a pivoted solve would change which lanes
certify.

Each function has a plain PyTorch version (``*_plain``) and a wrapper that
dispatches on the device: a CUDA float32 tensor launches the hand-written
kernel in ``csrc/ldlt.cu``, a CPU tensor takes the plain version, and any
other CUDA input raises.  Inputs are batch-major (B, K, K) / (B, K); the
``*_lanes`` entry points take the JAX package's lane-major layout
(K, K, B) / (K, B) and run the same kernels (or plain versions) through a
``movedim``.
"""
from __future__ import annotations

import torch

from polympc_torch.ops import _build

__all__ = ["ldlt_factor", "ldlt_factor_solve", "ldlt_solve", "ldlt_inverse",
           "ldlt_factor_lanes", "ldlt_solve_lanes", "ldlt_factor_solve_lanes",
           "ldlt_inverse_lanes",
           "ldlt_factor_plain", "ldlt_factor_solve_plain", "ldlt_solve_plain",
           "ldlt_inverse_plain", "sweep_inverse_mirror", "inverse_smem_bytes",
           "panel_solve_mirror", "packed_offset", "ldlt_smem_bytes",
           "LDLT_MAX_K"]

_THREADS = 256
# the factor's register chunks (csrc/ldlt_device.cuh, MAX_CHUNKS): 32 * 11
_CHUNK_MAX_K = 352


def packed_offset(j: int, K: int) -> int:
    """Where row j of the kernels' packed upper triangle starts: rows j..K-1
    of a (K, K) matrix from the diagonal on, one after another, so element
    (j, c), c >= j, lies at packed_offset(j, K) + c - j."""
    return j * K - j * (j - 1) // 2


def ldlt_smem_bytes(K: int) -> int:
    """Shared memory of one block of the factor, factor+solve and solve
    kernels: the packed upper triangle K(K+1)/2 and d in float32, then,
    8-byte aligned, the right-hand side in float64 (``pt_ldlt_smem_bytes``
    in ``csrc/ldlt.cu`` computes the same).  36,696 bytes at K = 132 (six
    blocks per SM), 56,760 at K = 165 (four)."""
    floats = (K * (K + 1) // 2 + K + 1) // 2 * 2
    return floats * 4 + K * 8


def _max_k() -> int:
    K = 1
    while K < _CHUNK_MAX_K and ldlt_smem_bytes(K + 1) <= \
            _build.SMEM_LIMIT_BYTES:
        K += 1
    return K


# the largest K the LDL^T kernels hold (shared memory): 337
LDLT_MAX_K = _max_k()


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


def ldlt_inverse_plain(M):
    """Explicit inverse of each (K, K) matrix through its packed factor: the
    identity swept forward, divided by d and swept backward (the JAX
    ``_factor_inverse_body``).  (B, K, K) -> (B, K, K)."""
    F, d = ldlt_factor_plain(M)
    L = torch.triu(F, diagonal=1).transpose(-1, -2)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    Y = torch.linalg.solve_triangular(L, eye.expand_as(M), upper=False,
                                      unitriangular=True)
    Y = Y / d[..., None]
    return torch.linalg.solve_triangular(L.transpose(-1, -2), Y, upper=True,
                                         unitriangular=True)


def sweep_inverse_mirror(M):
    """The CUDA kernels' explicit inverse, in plain PyTorch: an in-place
    unpivoted Gauss-Jordan sweep of each symmetric (K, K) matrix (the
    device primitive ``ptk::sweep_inverse`` of ``csrc/ldlt_device.cuh``,
    operation for operation).  Pivot p reads only column p: after the
    pivots before p, row p equals column p with the sign flipped at the
    swept indices j < p.  Its pivots are the unpivoted LDL^T's d.  Used by
    the tests and ``chip_smoke.py``, not on the main path.
    (B, K, K) -> (B, K, K)."""
    A = M.clone()
    K = A.shape[-1]
    sign = torch.ones(K, dtype=A.dtype, device=A.device)
    for p in range(K):
        v = A[:, :, p].clone()
        dinv = 1.0 / v[:, p]
        y = v * sign
        y[:, p] = 1.0
        yd = y * dinv[:, None]
        A[:, :, p] = 0.0
        A -= v[:, :, None] * yd[:, None, :]
        A[:, p, :] = yd
        sign[p] = -1.0
    return A


def panel_solve_mirror(F, d, b, panel=32):
    """The CUDA kernels' substitution (``ptk::solve_panels`` in
    ``csrc/ldlt_device.cuh``) in plain PyTorch, in float64 against the
    factor as given: panels of ``panel`` pivots, the unit triangle of each
    solved, then its columns applied to the rows below (forward) or, from
    the last panel up, to the rows above (backward).  Each element receives
    its terms one at a time in the kernel's order (forward by ascending
    pivot, backward by descending column), each product and difference
    rounded alone, so on the card it equals the kernel's float64 result
    before the final rounding to b's dtype.  Used by the tests and
    ``chip_smoke.py``, not on the main path.  F (B, K, K), d (B, K), b
    (B, K) -> x (B, K) in b's dtype."""
    F64, y = F.double(), b.double().clone()
    K = F.shape[-1]

    def forward(j0, j1, r0, r1):
        for j in range(j0, j1):
            lo = max(r0, j + 1)
            if lo < r1:
                y[:, lo:r1] -= F64[:, j, lo:r1] * y[:, j, None]

    def backward(c0, c1, r0, r1):
        for c in range(c1 - 1, c0 - 1, -1):
            hi = min(r1, c)
            if r0 < hi:
                y[:, r0:hi] -= F64[:, r0:hi, c] * y[:, c, None]

    for p0 in range(0, K, panel):
        p1 = min(p0 + panel, K)
        forward(p0, p1, p0, p1)
        forward(p0, p1, p1, K)
    y /= d.double()
    for p0 in reversed(range(0, K, panel)):
        p1 = min(p0 + panel, K)
        backward(p0, p1, p0, p1)
        backward(p0, p1, 0, p0)
    return y.to(b.dtype)


def inverse_smem_bytes(K: int) -> int:
    """Shared memory of one block of the inverse kernel: the matrix, staged
    in row stride K+1, and, 16-byte aligned after it, the sweep's four
    pivot vectors of 32*ceil(K/32) floats.  The sweep's register tile is
    the tighter rule: K up to ``_build.SWEEP_MAX_K[256]`` = 192 (150 KB
    here)."""
    return (K * (K + 1) + 4 + 4 * (-(-K // 32) * 32)) * 4


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
    block per matrix, its packed upper triangle in shared memory, K up to
    :data:`LDLT_MAX_K`; a larger K raises); its F's strict upper triangle,
    diagonal and d equal the plain version's bit for bit, and its strict
    lower triangle is zero where the plain version leaves the recurrence's
    Schur values (no caller reads that triangle; the JAX package documents
    it as never read).  CPU takes the plain version."""
    if M.dim() != 3 or M.shape[1] != M.shape[2]:
        raise ValueError(f"ldlt_factor: expected (B, K, K), got "
                         f"{tuple(M.shape)}")
    B, K = M.shape[0], M.shape[1]
    if M.device.type == "cpu":
        return ldlt_factor_plain(M)
    if M.device.type != "cuda":
        raise ValueError(f"ldlt_factor: no kernel for {M.device}")
    _check_cuda("ldlt_factor", M)
    _build.check_smem(ldlt_smem_bytes(K), f"ldlt_factor at K={K}")
    lib = _build.library()
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
    matrix, its packed upper triangle in shared memory, K up to
    :data:`LDLT_MAX_K`; it factors in float32 as :func:`ldlt_factor` does,
    F's strict lower triangle zero where the plain version's holds the
    recurrence's values, which no caller reads, and substitutes in float64
    against that factor, :func:`panel_solve_mirror`); CPU takes the plain
    version."""
    B, K = _shape("ldlt_factor_solve", M, b)
    if M.device.type == "cpu":
        return ldlt_factor_solve_plain(M, b)
    if M.device.type != "cuda":
        raise ValueError(f"ldlt_factor_solve: no kernel for {M.device}")
    _check_cuda("ldlt_factor_solve", M, b)
    _build.check_smem(ldlt_smem_bytes(K), f"ldlt_factor_solve at K={K}")
    lib = _build.library()
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
    :func:`ldlt_factor_solve`, b (B, K) -> x (B, K).

    CUDA float32 launches the ``csrc/ldlt.cu`` kernel (one thread block per
    matrix; it reads F's upper triangle only, substitutes in float64
    against that float32 factor by panels, :func:`panel_solve_mirror`, and
    rounds x to float32); CPU takes the plain version."""
    B, K = _shape("ldlt_solve", F, b)
    if d.shape != b.shape:
        raise ValueError(f"ldlt_solve: d has shape {tuple(d.shape)}, "
                         f"expected {tuple(b.shape)}")
    if F.device.type == "cpu":
        return ldlt_solve_plain(F, d, b)
    if F.device.type != "cuda":
        raise ValueError(f"ldlt_solve: no kernel for {F.device}")
    _check_cuda("ldlt_solve", F, d, b)
    _build.check_smem(ldlt_smem_bytes(K), f"ldlt_solve at K={K}")
    lib = _build.library()
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


def ldlt_inverse(M):
    """Batched explicit inverse of symmetric quasi-definite (B, K, K)
    matrices.  Returns (B, K, K), unpadded.

    CUDA float32 launches the ``csrc/ldlt.cu`` inverse kernel: one thread
    block per matrix inverts it in registers by the unpivoted Gauss-Jordan
    sweep (:func:`sweep_inverse_mirror` is that algorithm in PyTorch), so a
    K above the sweep's tile (192) raises, naming the shape.  CPU
    takes the plain version, which sweeps the identity through the LDL^T
    factor as the JAX package does; the two agree to rounding."""
    if M.dim() != 3 or M.shape[1] != M.shape[2]:
        raise ValueError(f"ldlt_inverse: expected (B, K, K), got "
                         f"{tuple(M.shape)}")
    B, K = M.shape[0], M.shape[1]
    if M.device.type == "cpu":
        return ldlt_inverse_plain(M)
    if M.device.type != "cuda":
        raise ValueError(f"ldlt_inverse: no kernel for {M.device}")
    _check_cuda("ldlt_inverse", M)
    _build.check_smem(inverse_smem_bytes(K), f"ldlt_inverse at K={K}")
    _build.check_sweep(K, _THREADS, f"ldlt_inverse at K={K}")
    lib = _build.library()
    M = M.contiguous()
    out = torch.empty_like(M)
    if B == 0:
        return out
    with torch.cuda.device(M.device):
        rc = lib.pt_ldlt_inverse_f32(M.data_ptr(), out.data_ptr(), B, K,
                                     _THREADS, _build.stream_of(M))
    _build.check(rc, "ldlt_inverse")
    _build.LAUNCHES["ldlt_inverse"] += 1
    return out


# the JAX package's lane-major entry points: the batch on the last axis

def _batch_first(t):
    return t.movedim(-1, 0)


def _lanes_last(t):
    return t.movedim(0, -1)


def ldlt_factor_lanes(M):
    """(K, K, B) -> packed factor F (K, K, B), diagonal d (K, B):
    :func:`ldlt_factor` on the lanes moved to the front."""
    F, d = ldlt_factor(_batch_first(M))
    return _lanes_last(F), _lanes_last(d)


def ldlt_solve_lanes(F, d, b):
    """Packed factor (K, K, B), (K, B) + right-hand side (K, B) -> solution
    (K, B): :func:`ldlt_solve` on the lanes moved to the front."""
    return _lanes_last(ldlt_solve(_batch_first(F), _batch_first(d),
                                  _batch_first(b)))


def ldlt_factor_solve_lanes(M, b):
    """(K, K, B), (K, B) -> (x (K, B), F (K, K, B), d (K, B)):
    :func:`ldlt_factor_solve` on the lanes moved to the front."""
    x, F, d = ldlt_factor_solve(_batch_first(M), _batch_first(b))
    return _lanes_last(x), _lanes_last(F), _lanes_last(d)


def ldlt_inverse_lanes(M):
    """(K, K, B) -> explicit inverse (K, K, B): :func:`ldlt_inverse` on
    the lanes moved to the front."""
    return _lanes_last(ldlt_inverse(_batch_first(M)))
