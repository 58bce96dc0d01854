"""Bordered-block-tridiagonal (BBT) boxADMM epoch and solve — the port of
polympc_tpu/ops/bbt_kernel.py (``bbt_admm_epoch_batched``,
``bbt_solve_batched``).

The collocation boxADMM KKT, permuted by segment (ops/structure.py), is
block-tridiagonal with thin couplings (nx boundary states) plus a dense
border for optimised parameters.  One epoch factors it once — block LDL^T
of each Schur-updated diagonal block, thin coupling solves W_s = T~_s^-1 E,
the border Schur complement inverted by unpivoted Gauss-Jordan — and runs
``iters`` over-relaxed ADMM iterations on permutation-unified vectors
(primal and dual rows interleaved by block, one elementwise update gated by
a per-row primal mask).  The CUDA kernel eliminates the same blocks but
inverts each Schur-updated diagonal block explicitly (an in-place
Gauss-Jordan sweep) and applies the inverses in every iteration, where the
plain version substitutes through LDL^T factors: :func:`bbt_epoch_mirror`
and :func:`bbt_solve_mirror` are the kernel's algorithm in PyTorch, for the
tests and ``chip_smoke.py``.

Host prep is torch indexing on the tensors' device: the block gathers
(``structure.gather_blocks``) and the permutation of the eight state
vectors into one (B, 8, L) buffer, L = S*k + a.  The epoch itself has a
plain PyTorch version (:func:`bbt_epoch_plain`, :func:`bbt_solve_plain`)
and a hand-written CUDA kernel (``csrc/bbt_epoch.cu``): a CUDA float32
tensor launches the kernel, a CPU tensor takes the plain version, and any
other CUDA input raises.
"""
from __future__ import annotations

import torch

from polympc_torch.ops import _build
from polympc_torch.ops.ldlt import (
    ldlt_factor_plain, ldlt_solve_plain, sweep_inverse_mirror,
)
from polympc_torch.ops.structure import (
    CollocStructure, _indices, gather_blocks, permute_vec, unpermute_vec,
)

__all__ = ["bbt_admm_epoch_batched", "bbt_solve_batched", "prepare_epoch",
           "bbt_kernel_fits", "epoch_smem_bytes", "epoch_threads",
           "bbt_epoch", "bbt_epoch_plain", "bbt_epoch_mirror", "bbt_solve",
           "bbt_solve_plain", "bbt_solve_mirror"]

# the thread counts per block the epoch kernel is built for (see
# epoch_threads); the single solve, which only the parity harness runs, is
# built at 256
_THREADS = (128, 256)
_SOLVE_THREADS = 256
_CHOSEN = {}


def epoch_smem_bytes(st: CollocStructure) -> int:
    """Bytes of dynamic shared memory one instance of the epoch kernel
    takes: ``pt_bbt_epoch_smem_bytes`` in ``csrc/bbt_epoch.cu`` (the S
    diagonal blocks and their inverses at row stride k+1, the couplings,
    the border, the sweep's pivot rows and ten state vectors of length
    L = S k + a), in Python, so the fit rule is known without the library
    (``chip_smoke.py`` holds the two formulas equal)."""
    S, k, nx, a = st.S, st.k, st.nx, st.a
    Sk, L = S * k, S * k + a
    piv_rows = (max(k, a) + 31) // 32 * 32
    work = (Sk * (k + 1) + Sk * nx + k * nx + 2 * Sk * a + a * a
            + max(a, nx) + k + 4 + 4 * piv_rows)
    return 4 * (work + 10 * L)


def _fitting_threads(st: CollocStructure):
    """The block sizes of :data:`_THREADS` at which the epoch kernel is
    built for the structure (the sweep's register tile holds blocks of
    max(k, a) rows, ``_build.SWEEP_MAX_K``) and one block's shared memory
    fits an SM."""
    smem = epoch_smem_bytes(st)
    return [t for t in _THREADS
            if max(st.k, st.a) <= _build.SWEEP_MAX_K[t]
            and smem <= _build.SMEM_LIMIT_BYTES
            and _build.blocks_per_sm(smem, t) > 0]


def bbt_kernel_fits(st: CollocStructure) -> bool:
    """Whether the epoch kernel runs a structure's QPs: its blocks fit the
    sweep's register tile at 128 or 256 threads and its working set fits a
    block's shared memory.  Pure Python, decided before any launch; the
    QP's epoch dispatch (``qp/box_admm.py:epoch_route``) takes the dense or
    the LU epoch where it is false, as the JAX package does with its own
    ``bbt_kernel_fits``."""
    return bool(_fitting_threads(st))


def epoch_threads(st: CollocStructure) -> int:
    """Threads per block of the epoch kernel for a structure: of the block
    sizes that fit it (:func:`bbt_kernel_fits`; raises where none does),
    the one with which an SM holds more instances at once, 256 on a tie.
    Each instance is bound by its own chain of barriers, and independent
    instances on one SM hide each other's; on the card the kite's shape
    (k=72: three instances per SM at 128 threads, two at 256, by
    registers) ran faster at 128 and the race car's (k=96: two at either,
    by shared memory) at 256 (``chip_smoke.py`` prints both)."""
    key = (st.S, st.k, st.nx, st.a)
    if key not in _CHOSEN:
        fits = _fitting_threads(st)
        if not fits:
            raise ValueError(f"bbt_epoch: no block of {_THREADS} threads "
                             f"fits {_shape_str(st)} (bbt_kernel_fits)")
        lib = _build.library()
        blocks, threads = max((lib.pt_bbt_epoch_blocks_per_sm(*key, t), t)
                              for t in fits)
        if blocks == 0:
            raise RuntimeError(f"bbt_epoch: the occupancy API places no "
                               f"block at {_shape_str(st)}, which "
                               "bbt_kernel_fits admits")
        _CHOSEN[key] = threads
    return _CHOSEN[key]


# ---------------------------------------------------------------------------
# plain PyTorch versions (permuted layout)
# ---------------------------------------------------------------------------

def _invert_small(Sp):
    """Unpivoted Gauss-Jordan inverse of (B, a, a) matrices (the border
    Schur complement of a quasi-definite KKT is strongly factorisable)."""
    A = Sp.clone()
    a = A.shape[-1]
    Inv = torch.eye(a, dtype=A.dtype, device=A.device).expand_as(A).clone()
    for i in range(a):
        d = A[:, i, i].clone()
        piv = A[:, i, :] / d[:, None]
        pivI = Inv[:, i, :] / d[:, None]
        colf = A[:, :, i].clone()
        colf[:, i] = 0.0
        A = A - colf[:, :, None] * piv[:, None, :]
        Inv = Inv - colf[:, :, None] * pivI[:, None, :]
        A[:, i, :] = piv
        Inv[:, i, :] = pivI
    return Inv


def _bbt_factor_plain(Td, Oh, Ct, Dp, st: CollocStructure):
    """Block factor of the permuted BBT system.  Returns per-block lists of
    packed factors (F_s, d_s), W_s = T~_s^-1 E (B, k, nx), the updated border
    columns C~_s (B, k, a), V_s = T~_s^-1 C~_s (B, k, a), and the inverse of
    the border Schur complement (B, a, a)."""
    S, k, nx = st.S, st.k, st.nx
    B = Td.shape[0]
    C = Ct.transpose(2, 3)
    F, d, W, Cs, V = [], [], [], [], []
    Sp = Dp
    for s in range(S):
        T, Cc = Td[:, s], C[:, s]
        if s > 0:
            bxp = st.bx[s - 1]
            O = Oh[:, s]
            T = T - O @ W[s - 1][:, bxp:bxp + nx, :] @ O.transpose(1, 2)
            Cc = Cc - O @ V[s - 1][:, bxp:bxp + nx, :]
        Fs, ds = ldlt_factor_plain(T)
        E = Td.new_zeros((B, k, nx))
        E[:, st.bx[s]:st.bx[s] + nx, :] = torch.eye(nx, dtype=Td.dtype,
                                                    device=Td.device)
        F.append(Fs)
        d.append(ds)
        W.append(_solve_multi(Fs, ds, E))
        Cs.append(Cc)
        V.append(_solve_multi(Fs, ds, Cc))
        Sp = Sp - Cc.transpose(1, 2) @ V[s]
    Gp = _invert_small(Sp) if st.a else Sp
    return F, d, W, Cs, V, Gp


def _solve_multi(F, d, Y):
    """Block solve for several right-hand sides, Y (B, k, r)."""
    if Y.shape[-1] == 0:
        return Y
    cols = [ldlt_solve_plain(F, d, Y[..., j]) for j in range(Y.shape[-1])]
    return torch.stack(cols, dim=-1)


def _bbt_solve_plain(fac, Oh, u, st: CollocStructure):
    """Solve the factored BBT system for u (B, S*k + a) permuted."""
    F, d, W, Cs, V, Gp = fac
    return _bbt_substitute(lambda s, y: ldlt_solve_plain(F[s], d[s], y),
                           W, Cs, V, Gp, Oh, u, st)


def _bbt_substitute(block_solve, W, Cs, V, Gp, Oh, u, st: CollocStructure):
    """Forward and backward block substitution of the factored BBT system,
    with ``block_solve(s, y)`` applying T~_s^-1 to y (B, k)."""
    S, k, nx, a = st.S, st.k, st.nx, st.a
    us = []
    bph = u[:, S * k:]
    for s in range(S):
        y = u[:, s * k:(s + 1) * k]
        if s > 0:
            bxp = st.bx[s - 1]
            y = y - (Oh[:, s] @ us[s - 1][:, bxp:bxp + nx, None])[..., 0]
        us.append(block_solve(s, y))
        if a:
            bph = bph - (Cs[s].transpose(1, 2) @ us[s][..., None])[..., 0]
    xp = (Gp @ bph[..., None])[..., 0] if a else bph
    xs = [None] * S
    for s in reversed(range(S)):
        x = us[s]
        if a:
            x = x - (V[s] @ xp[..., None])[..., 0]
        if s < S - 1:
            t = Oh[:, s + 1].transpose(1, 2) @ xs[s + 1][..., None]
            x = x - (W[s] @ t)[..., 0]
        xs[s] = x
    return torch.cat(xs + [xp], dim=1)


def bbt_solve_plain(Td, Oh, Ct, Dp, rhs, st: CollocStructure):
    """Factor + one solve, plain PyTorch: block storage from
    ``structure.gather_blocks`` and rhs (B, S*k + a) permuted -> the permuted
    solution (B, S*k + a)."""
    fac = _bbt_factor_plain(Td, Oh, Ct, Dp, st)
    return _bbt_solve_plain(fac, Oh, rhs, st)


def bbt_epoch_plain(Td, Oh, Ct, Dp, vin, st: CollocStructure, sigma: float,
                    alpha: float, iters: int):
    """One fused boxADMM epoch, plain PyTorch: factor once, then ``iters``
    over-relaxed iterations.  vin (B, 8, L) holds h, lo, hi, rv, pm, x, v,
    yv in the permuted order; returns vout (B, 3, L) = x, v, yv."""
    fac = _bbt_factor_plain(Td, Oh, Ct, Dp, st)
    return _admm_iterations(lambda rhs: _bbt_solve_plain(fac, Oh, rhs, st),
                            vin, sigma, alpha, iters)


def _admm_iterations(solve, vin, sigma, alpha, iters):
    """``iters`` over-relaxed boxADMM iterations on the unified permuted
    vectors, each solving the factored KKT once with ``solve(rhs)``."""
    h, lo, hi, rv, pm, x, v, yv = vin.unbind(1)
    ri = 1.0 / rv
    for _ in range(iters):
        rhs = pm * (sigma * x + rv * v - yv - h) + (1.0 - pm) * (v - yv * ri)
        sol = solve(rhs)
        t = pm * sol + (1.0 - pm) * (v + (sol - yv) * ri)
        x = pm * (alpha * sol + (1.0 - alpha) * x) + (1.0 - pm) * x
        vu = alpha * t + (1.0 - alpha) * v
        vn = torch.clamp(vu + yv * ri, min=lo, max=hi)
        yv = yv + rv * (vu - vn)
        v = vn
    return torch.stack([x, v, yv], dim=1)


# ---------------------------------------------------------------------------
# mirrors of the CUDA kernels' algorithm (explicit block inverses)
# ---------------------------------------------------------------------------

def _bbt_factor_mirror(Td, Oh, Ct, Dp, st: CollocStructure):
    """The block factor as ``csrc/bbt_epoch.cu`` computes it: each
    Schur-updated diagonal block inverted in place by the Gauss-Jordan sweep
    (:func:`~polympc_torch.ops.ldlt.sweep_inverse_mirror`), W_s = T~_s^-1 E
    read as columns bx_s..bx_s+nx of that inverse, V_s = T~_s^-1 C~_s one
    product, the border Schur complement swept by the same primitive.
    Returns (T~_s^-1 list, W, C~, V, border inverse)."""
    S, nx = st.S, st.nx
    C = Ct.transpose(2, 3)
    Ti, W, Cs, V = [], [], [], []
    Sp = Dp
    for s in range(S):
        T, Cc = Td[:, s], C[:, s]
        if s > 0:
            bxp = st.bx[s - 1]
            O = Oh[:, s]
            G = Ti[s - 1][:, bxp:bxp + nx, bxp:bxp + nx]
            T = T - O @ G @ O.transpose(1, 2)
            Cc = Cc - O @ V[s - 1][:, bxp:bxp + nx, :]
        Ti.append(sweep_inverse_mirror(T))
        W.append(Ti[s][:, :, st.bx[s]:st.bx[s] + nx])
        Cs.append(Cc)
        V.append(Ti[s] @ Cc)
        Sp = Sp - Cc.transpose(1, 2) @ V[s]
    Gp = sweep_inverse_mirror(Sp) if st.a else Sp
    return Ti, W, Cs, V, Gp


def _bbt_solve_mirror(fac, Oh, u, st: CollocStructure):
    Ti, W, Cs, V, Gp = fac
    return _bbt_substitute(lambda s, y: (Ti[s] @ y[..., None])[..., 0],
                           W, Cs, V, Gp, Oh, u, st)


def bbt_solve_mirror(Td, Oh, Ct, Dp, rhs, st: CollocStructure):
    """:func:`bbt_solve_plain` by the CUDA kernel's algorithm (explicit
    block inverses; see :func:`_bbt_factor_mirror`), for the tests and
    ``chip_smoke.py``; nothing on the main path calls it."""
    fac = _bbt_factor_mirror(Td, Oh, Ct, Dp, st)
    return _bbt_solve_mirror(fac, Oh, rhs, st)


def bbt_epoch_mirror(Td, Oh, Ct, Dp, vin, st: CollocStructure, sigma: float,
                     alpha: float, iters: int):
    """:func:`bbt_epoch_plain` by the CUDA kernel's algorithm: each
    iteration applies the explicit block inverses where the plain version
    substitutes through LDL^T factors.  For the tests and
    ``chip_smoke.py``; nothing on the main path calls it."""
    fac = _bbt_factor_mirror(Td, Oh, Ct, Dp, st)
    return _admm_iterations(lambda rhs: _bbt_solve_mirror(fac, Oh, rhs, st),
                            vin, sigma, alpha, iters)


# ---------------------------------------------------------------------------
# kernel wrappers (same signatures as the plain versions)
# ---------------------------------------------------------------------------

def _cuda_args(name, st, Td, Oh, Ct, Dp, vec):
    ts = (Td, Oh, Ct, Dp, vec)
    for t in ts:
        if t.device != Td.device:
            raise ValueError(f"{name}: inputs on different devices")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernel takes float32, got "
                            f"{t.dtype}")
    B = Td.shape[0]
    S, k, nx, a = st.S, st.k, st.nx, st.a
    want = ((B, S, k, k), (B, S, k, nx), (B, S, a, k), (B, a, a))
    for t, shp in zip(ts, want):
        if tuple(t.shape) != shp:
            raise ValueError(f"{name}: block of shape {tuple(t.shape)}, "
                             f"expected {shp}")
    return [t.contiguous() for t in ts]


def _shape_str(st):
    return f"S={st.S}, k={st.k}, nx={st.nx}, a={st.a}"


def bbt_epoch(Td, Oh, Ct, Dp, vin, st: CollocStructure, sigma: float,
              alpha: float, iters: int):
    """:func:`bbt_epoch_plain` on the device of its inputs: CUDA float32
    launches the ``csrc/bbt_epoch.cu`` kernel (one thread block per
    instance, of :func:`epoch_threads`, its explicit block inverses in
    shared memory for the whole epoch: :func:`bbt_epoch_mirror` is its
    algorithm); CPU takes the plain version."""
    if Td.device.type == "cpu":
        return bbt_epoch_plain(Td, Oh, Ct, Dp, vin, st, sigma, alpha, iters)
    if Td.device.type != "cuda":
        raise ValueError(f"bbt_epoch: no kernel for {Td.device}")
    Td, Oh, Ct, Dp, vin = _cuda_args("bbt_epoch", st, Td, Oh, Ct, Dp, vin)
    B, L = Td.shape[0], st.S * st.k + st.a
    if tuple(vin.shape) != (B, 8, L):
        raise ValueError(f"bbt_epoch: vin of shape {tuple(vin.shape)}, "
                         f"expected {(B, 8, L)}")
    threads = epoch_threads(st)
    return _launch_epoch(Td, Oh, Ct, Dp, vin, st, sigma, alpha, iters,
                         threads)


def _launch_epoch(Td, Oh, Ct, Dp, vin, st, sigma, alpha, iters, threads):
    """The epoch kernel's launch at ``threads`` per block (128 or 256) on
    contiguous CUDA float32 inputs that :func:`bbt_epoch` has checked;
    ``chip_smoke.py`` and the card tests also call it to time and hold
    both block sizes."""
    B, L = Td.shape[0], st.S * st.k + st.a
    vout = torch.empty((B, 3, L), dtype=vin.dtype, device=vin.device)
    if B == 0:
        return vout
    bx = _indices(st, Td.device)["bx"]
    with torch.cuda.device(Td.device):
        rc = _build.library().pt_bbt_epoch_f32(
            Td.data_ptr(), Oh.data_ptr(), Ct.data_ptr(), Dp.data_ptr(),
            vin.data_ptr(), vout.data_ptr(), bx.data_ptr(), B, st.S, st.k,
            st.nx, st.a, float(sigma), float(alpha), int(iters),
            int(threads), _build.stream_of(Td))
    _build.check(rc, "bbt_epoch")
    _build.LAUNCHES["bbt_epoch"] += 1
    return vout


def bbt_solve(Td, Oh, Ct, Dp, rhs, st: CollocStructure):
    """:func:`bbt_solve_plain` on the device of its inputs (CUDA float32:
    the ``csrc/bbt_epoch.cu`` factor + solve kernel, whose algorithm is
    :func:`bbt_solve_mirror`)."""
    if Td.device.type == "cpu":
        return bbt_solve_plain(Td, Oh, Ct, Dp, rhs, st)
    if Td.device.type != "cuda":
        raise ValueError(f"bbt_solve: no kernel for {Td.device}")
    Td, Oh, Ct, Dp, rhs = _cuda_args("bbt_solve", st, Td, Oh, Ct, Dp, rhs)
    B, L = Td.shape[0], st.S * st.k + st.a
    if tuple(rhs.shape) != (B, L):
        raise ValueError(f"bbt_solve: rhs of shape {tuple(rhs.shape)}, "
                         f"expected {(B, L)}")
    lib = _build.library()
    _build.check_smem(lib.pt_bbt_solve_smem_bytes(st.S, st.k, st.nx, st.a),
                      f"bbt_solve at {_shape_str(st)}")
    _build.check_sweep(max(st.k, st.a), _SOLVE_THREADS,
                       f"bbt_solve at {_shape_str(st)}")
    out = torch.empty_like(rhs)
    if B == 0:
        return out
    bx = _indices(st, Td.device)["bx"]
    with torch.cuda.device(Td.device):
        rc = lib.pt_bbt_solve_f32(
            Td.data_ptr(), Oh.data_ptr(), Ct.data_ptr(), Dp.data_ptr(),
            rhs.data_ptr(), out.data_ptr(), bx.data_ptr(), B, st.S, st.k,
            st.nx, st.a, _SOLVE_THREADS, _build.stream_of(Td))
    _build.check(rc, "bbt_solve")
    _build.LAUNCHES["bbt_solve"] += 1
    return out


# ---------------------------------------------------------------------------
# batch-major entry points (the JAX package's API)
# ---------------------------------------------------------------------------

def _check_structure(st: CollocStructure, n: int, m: int):
    if st.n != n or st.m != m:
        raise ValueError(f"structure is for n={st.n}, m={st.m}; the QP has "
                         f"n={n}, m={m}")


def prepare_epoch(kkt, h, al, au, xl, xu, rho, rb, x, z, q, y, yb,
                  st: CollocStructure):
    """Gather the blocks of ``kkt`` and pack the state into the unified
    permuted layout: returns (Td, Oh, Ct, Dp, vin).  Padding rows are inert
    primal rows (identity KKT row, free bounds)."""
    B, n = h.shape
    m = al.shape[1]
    _check_structure(st, n, m)
    inf = float("inf")
    zeros_m = h.new_zeros((B, m))
    vecs = (
        (torch.cat([h, zeros_m], 1), 0.0),
        (torch.cat([xl, al], 1), -inf),
        (torch.cat([xu, au], 1), inf),
        (torch.cat([rb, rho], 1), 1.0),
        (torch.cat([torch.ones_like(h), zeros_m], 1), 1.0),
        (torch.cat([x, zeros_m], 1), 0.0),
        (torch.cat([q, z], 1), 0.0),
        (torch.cat([yb, y], 1), 0.0),
    )
    vin = torch.stack([permute_vec(v, st, fill) for v, fill in vecs], dim=1)
    return (*gather_blocks(kkt, st), vin)


def bbt_admm_epoch_batched(kkt, h, al, au, xl, xu, rho, rb, x, z, q, y, yb,
                           *, st: CollocStructure, sigma, alpha, iters):
    """Fused BBT ADMM epoch on a batch: kkt (B, n+m, n+m) for the current
    rho, vectors batch-major.  Returns the new (x, z, q, y, yb)."""
    n = h.shape[1]
    Td, Oh, Ct, Dp, vin = prepare_epoch(kkt, h, al, au, xl, xu, rho, rb,
                                        x, z, q, y, yb, st)
    vout = bbt_epoch(Td, Oh, Ct, Dp, vin, st, sigma, alpha, iters)
    xo, vo, yvo = (unpermute_vec(u, st) for u in vout.unbind(1))
    return xo[:, :n], vo[:, n:], vo[:, :n], yvo[:, n:], yvo[:, :n]


def bbt_solve_batched(kkt, b, *, st: CollocStructure):
    """Factor + single solve of batched BBT KKT systems: (B, K, K), (B, K)
    -> (B, K)."""
    if kkt.shape[-1] != st.K or b.shape[-1] != st.K:
        raise ValueError(f"structure is for K={st.K}; got a KKT of shape "
                         f"{tuple(kkt.shape)} and rhs {tuple(b.shape)}")
    blocks = gather_blocks(kkt, st)
    u = bbt_solve(*blocks, permute_vec(b, st, 0.0), st)
    return unpermute_vec(u, st)
