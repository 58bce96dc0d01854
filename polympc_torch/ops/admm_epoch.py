"""Fused dense boxADMM epoch: KKT LDL^T factor + ``iters`` iterations —
the port of polympc_tpu/ops/admm_epoch.py (``admm_epoch_batched``).

One boxADMM epoch (ref: box_admm.hpp:88-205) factors the KKT for the
current rho, then runs ``check_every`` operator-splitting iterations that
read nothing but the factor and a handful of vectors.  The epoch of a QP
with no collocation structure (the spline-fitting QP) runs here; a QP with
the BBT structure runs ops/bbt_kernel.py instead.

:func:`admm_epoch_plain` is the plain PyTorch version (unpivoted packed
LDL^T from ops/ldlt.py, then the iterations); :func:`admm_epoch_batched`
launches the hand-written kernel ``csrc/admm_epoch.cu`` for CUDA float32
tensors (one thread block per instance, the factor and the state in shared
memory for the whole epoch), takes the plain version for CPU tensors, and
raises for anything else.  ``m = 0`` (a box-only QP) is the same function
with an empty dual block.  No padding: the TPU kernel's n -> n8, m -> m8
padding follows its sublane layout, which Hopper does not have.
"""
from __future__ import annotations

import torch

from polympc_torch.ops import _build
from polympc_torch.ops.ldlt import ldlt_factor_plain, ldlt_solve_plain

__all__ = ["admm_epoch_batched", "admm_epoch_plain", "epoch_kernel_fits",
           "epoch_smem_bytes", "epoch_threads"]


def epoch_smem_bytes(n: int, m: int) -> int:
    """Dynamic shared memory of one instance of the kernel: the (K, K+1)
    factor, its pivots, the right-hand side, seven primal vectors (h, xl,
    xu, rb, x, q, yb) and five dual ones (al, au, rho, z, y), float32.
    ``pt_admm_epoch_smem_bytes`` in the source computes the same."""
    K = n + m
    return (K * (K + 1) + 2 * K + 7 * n + 5 * m) * 4


def epoch_kernel_fits(n: int, m: int) -> bool:
    """True if one instance's working set fits a Hopper block's shared
    memory (K = n + m up to 237); a larger KKT takes the LU epoch."""
    return epoch_smem_bytes(n, m) <= _build.SMEM_LIMIT_BYTES


def epoch_threads(K: int) -> int:
    """Block size by KKT size: a per-pivot sweep of a K-row system has at
    most K - 1 independent updates, so small K gets small blocks (fewer
    idle threads at every barrier, more blocks per SM).  Measured on an
    H100 (PERF.md): 64 threads fastest at K=47 (B=4096), 256 at K=132
    (B=512)."""
    return 64 if K <= 64 else 256


def admm_epoch_plain(kkt, h, al, au, xl, xu, rho, rb, x, z, q, y, yb, *,
                     sigma, alpha, iters):
    """One epoch in plain PyTorch: kkt (B, n+m, n+m) for the current rho;
    h, xl, xu, rb, x, q, yb (B, n); al, au, rho, z, y (B, m).  Returns the
    new (x, z, q, y, yb)."""
    n = h.shape[1]
    F, d = ldlt_factor_plain(kkt)
    rb_inv = 1.0 / rb
    rho_inv = 1.0 / rho
    a1 = 1.0 - alpha
    for _ in range(iters):
        rhs = torch.cat([sigma * x + rb * q - yb - h, z - y * rho_inv], 1)
        sol = ldlt_solve_plain(F, d, rhs)
        xt, nu = sol[:, :n], sol[:, n:]
        zt = z + (nu - y) * rho_inv
        q_u = alpha * xt + a1 * q
        q_new = torch.clamp(q_u + yb * rb_inv, min=xl, max=xu)
        yb = yb + rb * (q_u - q_new)
        x = alpha * xt + a1 * x
        q = q_new
        z_u = alpha * zt + a1 * z
        z_new = torch.clamp(z_u + y * rho_inv, min=al, max=au)
        y = y + rho * (z_u - z_new)
        z = z_new
    return x, z, q, y, yb


def _check(kkt, vecs_n, vecs_m):
    B, n = vecs_n[0].shape
    m = vecs_m[0].shape[1]
    if tuple(kkt.shape) != (B, n + m, n + m):
        raise ValueError(f"admm_epoch: KKT of shape {tuple(kkt.shape)}, "
                         f"expected {(B, n + m, n + m)}")
    for v in vecs_n:
        if tuple(v.shape) != (B, n):
            raise ValueError(f"admm_epoch: vector of shape {tuple(v.shape)}"
                             f", expected {(B, n)}")
    for v in vecs_m:
        if tuple(v.shape) != (B, m):
            raise ValueError(f"admm_epoch: vector of shape {tuple(v.shape)}"
                             f", expected {(B, m)}")
    return B, n, m


def admm_epoch_batched(kkt, h, al, au, xl, xu, rho, rb, x, z, q, y, yb, *,
                       sigma, alpha, iters, threads=None):
    """Run one fused (factor + ``iters`` iterations) ADMM epoch on a batch.

    kkt (B, n+m, n+m) assembled KKT matrices for the current rho; h, xl,
    xu, rb, x, q, yb (B, n); al, au, rho, z, y (B, m).  Returns the new
    (x, z, q, y, yb).  ``threads`` overrides the block size of the kernel
    (:func:`epoch_threads` by default)."""
    vecs_n = (h, xl, xu, rb, x, q, yb)
    vecs_m = (al, au, rho, z, y)
    B, n, m = _check(kkt, vecs_n, vecs_m)
    if kkt.device.type == "cpu":
        return admm_epoch_plain(kkt, h, al, au, xl, xu, rho, rb, x, z, q, y,
                                yb, sigma=sigma, alpha=alpha, iters=iters)
    if kkt.device.type != "cuda":
        raise ValueError(f"admm_epoch: no kernel for {kkt.device}")
    for t in (kkt,) + vecs_n + vecs_m:
        if t.dtype != torch.float32:
            raise TypeError(f"admm_epoch: the CUDA kernel takes float32, "
                            f"got {t.dtype}")
        if t.device != kkt.device:
            raise ValueError("admm_epoch: inputs on different devices")
    lib = _build.library()
    _build.check_smem(lib.pt_admm_epoch_smem_bytes(n, m),
                      f"admm_epoch at n={n}, m={m}")
    kkt = kkt.contiguous()
    ins = [t.contiguous() for t in (h, al, au, xl, xu, rho, rb,
                                    x, z, q, y, yb)]
    outs = [torch.empty_like(t) for t in (x, z, q, y, yb)]
    if B == 0:
        return tuple(outs)
    with torch.cuda.device(kkt.device):
        rc = lib.pt_admm_epoch_f32(
            kkt.data_ptr(), *(t.data_ptr() for t in ins),
            *(t.data_ptr() for t in outs), B, n, m, float(sigma),
            float(alpha), int(iters),
            int(threads or epoch_threads(n + m)), _build.stream_of(kkt))
    _build.check(rc, "admm_epoch")
    _build.LAUNCHES["admm_epoch"] += 1
    return tuple(outs)
