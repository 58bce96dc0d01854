"""Collocation KKT structure: permutation onto bordered-block-tridiagonal
(BBT) form — the port of polympc_tpu/ops/structure.py.

The boxADMM KKT of a pseudospectral collocation NLP,

    K = [[H + sigma I + diag(rb),  A'], [A, -diag(1/rho)]],

reordered by segment — each block owning its nodes' states, controls and
constraint duals — is

    [ T_0  O_1'              C_0 ]
    [ O_1  T_1  O_2'         C_1 ]
    [      O_2  T_2          C_2 ]
    [ C_0' C_1' C_2' ...      Dp ]

where the couplings O_s are thin (a segment's defect rows touch only the nx
boundary states owned by the previous block) and the border collects the
optimised parameters and trajectory-level inequality duals
(continuous_ocp.hpp:313-376).

This module holds the static permutation (numpy, build time), the block
gathers as torch indexing on the tensors' device, and ``bbt_solve_dense``,
a dense-solve oracle of the BBT factor/solve (the JAX ``bbt_solve_jnp``).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

__all__ = ["CollocStructure", "bbt_structure", "structure_is_consistent",
           "gather_blocks", "scatter_solution", "bbt_solve_dense",
           "random_bbt_kkt"]


@dataclasses.dataclass(frozen=True)
class CollocStructure:
    """Static BBT metadata (hashable: everything is tuples/ints).

    S: number of blocks (= collocation segments);
    k: padded uniform block size (rounded to ``sublane``, as in the JAX
       package, so both packages agree on the permutation);
    a: border width (np_ + ntg);
    nx: boundary-state count; nxr: nx rounded to the sublane multiple;
    perm: (S, k) global KKT indices per block, K (= n+m) marking padding;
    border: (a,) global indices of the border rows/cols;
    bx: (S,) row offset of the boundary states within each block;
    n, m: primal/dual dimensions of the original KKT.
    """
    S: int
    k: int
    a: int
    nx: int
    nxr: int
    perm: tuple
    border: tuple
    bx: tuple
    n: int
    m: int

    @property
    def K(self) -> int:
        return self.n + self.m


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


@functools.lru_cache(maxsize=64)
def structure_is_consistent(st: CollocStructure) -> bool:
    """perm + border cover each of the K = n+m global KKT indices exactly
    once (padding slots carry the sentinel K), with the advertised S/k/a
    shapes."""
    if len(st.perm) != st.S or any(len(row) != st.k for row in st.perm):
        return False
    if len(st.border) != st.a or len(st.bx) != st.S:
        return False
    K = st.K
    idx = [i for row in st.perm for i in row if i != K]
    idx.extend(st.border)
    return sorted(idx) == list(range(K))


def bbt_structure(N: int, nx: int, nu: int, ng: int, np_: int, ntg: int,
                  order: int, segments: int, sublane: int = 8
                  ) -> CollocStructure:
    """Build the BBT permutation for a Lobatto collocation KKT.

    Node ownership: block 0 owns nodes 0..p; block s >= 1 owns nodes
    s*p+1..(s+1)*p.  Block-internal order: [x(nodes), u(nodes),
    lam_eq(nodes), lam_ineq(nodes)], padded to the uniform size k.
    """
    p, S = order, segments
    if N != p * S + 1:
        raise ValueError("bbt_structure requires a boundary-sharing "
                         f"(Lobatto) mesh: N={N} != {p}*{S}+1")
    n = N * (nx + nu) + np_
    m = N * nx + N * ng + ntg
    K = n + m
    q = 2 * nx + nu + ng
    k = _round_up((p + 1) * q, sublane)

    perm, bx = [], []
    for s in range(S):
        nodes = range(0, p + 1) if s == 0 else range(s * p + 1,
                                                     (s + 1) * p + 1)
        idx = []
        for j in nodes:
            idx.extend(range(j * nx, (j + 1) * nx))
        bx.append((len(nodes) - 1) * nx)
        for j in nodes:
            idx.extend(range(N * nx + j * nu, N * nx + (j + 1) * nu))
        for j in nodes:
            idx.extend(range(n + j * nx, n + (j + 1) * nx))
        for j in nodes:
            idx.extend(range(n + N * nx + j * ng, n + N * nx + (j + 1) * ng))
        idx.extend([K] * (k - len(idx)))
        perm.append(tuple(idx))
    border = tuple(list(range(N * (nx + nu), n))
                   + list(range(n + N * nx + N * ng, K)))
    return CollocStructure(S=S, k=k, a=np_ + ntg, nx=nx,
                           nxr=_round_up(max(nx, 1), sublane),
                           perm=tuple(perm), border=border, bx=tuple(bx),
                           n=n, m=m)


@functools.lru_cache(maxsize=32)
def _indices(st: CollocStructure, device: torch.device):
    """Index tensors of a structure on one device:
      perm (S, k); bxg (S, nx) boundary-x columns of the previous block
      (sentinel K for block 0); border (a,); order (S*k + a,) the unified
      permuted order; inv (K,) position of each global index in ``order``;
      bx (S,) int32."""
    K = st.K
    perm = np.asarray(st.perm, np.int64)
    bxg = np.full((st.S, st.nx), K, np.int64)
    for s in range(1, st.S):
        bxg[s] = perm[s - 1, st.bx[s - 1]:st.bx[s - 1] + st.nx]
    border = np.asarray(st.border, np.int64).reshape(-1)
    order = np.concatenate([perm.reshape(-1), border])
    inv = np.empty(K, np.int64)
    live = order != K
    inv[order[live]] = np.nonzero(live)[0]
    t = lambda a, dt=torch.int64: torch.as_tensor(a, dtype=dt, device=device)
    return {"perm": t(perm), "bxg": t(bxg), "border": t(border),
            "order": t(order), "inv": t(inv),
            "bx": t(np.asarray(st.bx), torch.int32),
            "pad": t(perm == K, torch.bool)}


def gather_blocks(kkt, st: CollocStructure):
    """Batched dense KKTs (B, K, K) -> BBT block storage, batch-major:

      Td (B, S, k, k)  diagonal blocks; padding rows/cols are identity;
      Oh (B, S, k, nx) couplings: Oh[:, s] = K[block s rows, boundary x of
                       block s-1] for s >= 1, zeros for s = 0;
      Ct (B, S, a, k)  border columns, transposed;
      Dp (B, a, a)     border block.
    """
    ix = _indices(st, kkt.device)
    B = kkt.shape[0]
    Kx = torch.nn.functional.pad(kkt, (0, 1, 0, 1))     # sentinel row/col 0
    perm = ix["perm"]
    Td = Kx[:, perm[:, :, None], perm[:, None, :]]
    pad2 = ix["pad"][:, :, None] | ix["pad"][:, None, :]
    eye = torch.eye(st.k, dtype=kkt.dtype, device=kkt.device)
    Td = torch.where(pad2, eye, Td)
    Oh = Kx[:, perm[:, :, None], ix["bxg"][:, None, :]]
    bd = ix["border"]
    Ct = Kx[:, bd[None, :, None], perm[:, None, :]]
    Dp = Kx[:, bd[:, None], bd[None, :]]
    return (Td.contiguous(), Oh.contiguous(), Ct.contiguous(),
            Dp.reshape(B, st.a, st.a).contiguous())


def permute_vec(vec, st: CollocStructure, fill: float):
    """(B, K) in the natural KKT order -> (B, S*k + a) in the unified
    permuted order (blocks, then border); padding slots read ``fill``."""
    ix = _indices(st, vec.device)
    vx = torch.cat([vec, vec.new_full((vec.shape[0], 1), fill)], dim=1)
    return vx[:, ix["order"]]


def unpermute_vec(u, st: CollocStructure):
    """Inverse of :func:`permute_vec`: (B, S*k + a) -> (B, K)."""
    return u[:, _indices(st, u.device)["inv"]]


def scatter_solution(xb, xp, st: CollocStructure):
    """Block solution (B, S, k) + border (B, a) -> (B, K) in the original
    ordering."""
    u = torch.cat([xb.reshape(xb.shape[0], -1), xp], dim=1)
    return unpermute_vec(u, st)


def bbt_solve_dense(Td, Oh, Ct, Dp, b, st: CollocStructure):
    """Oracle BBT factor+solve with dense per-block ``torch.linalg.solve``
    (clarity over speed): sweep the blocks, Schur-updating each diagonal
    block through the thin coupling and the border, solve the a x a border
    system, back-substitute.  b (B, S*k + a) permuted; returns the permuted
    solution (B, S*k + a)."""
    S, k, a, nx = st.S, st.k, st.a, st.nx
    B = Td.shape[0]
    bb = b[:, :S * k].reshape(B, S, k)
    bp = b[:, S * k:]
    C = Ct.transpose(2, 3)                          # (B, S, k, a)
    Tt, Ch, W, V = [], [], [], []
    Sp = Dp
    for s in range(S):
        T, Cs = Td[:, s], C[:, s]
        if s > 0:
            bxp = st.bx[s - 1]
            O = Oh[:, s]
            T = T - O @ W[s - 1][:, bxp:bxp + nx, :] @ O.transpose(1, 2)
            Cs = Cs - O @ V[s - 1][:, bxp:bxp + nx, :]
        E = Td.new_zeros((B, k, nx))
        E[:, st.bx[s]:st.bx[s] + nx, :] = torch.eye(nx, dtype=Td.dtype,
                                                    device=Td.device)
        Tt.append(T)
        Ch.append(Cs)
        W.append(torch.linalg.solve(T, E))
        V.append(torch.linalg.solve(T, Cs))
        Sp = Sp - Cs.transpose(1, 2) @ V[s]
    u = []
    bph = bp
    for s in range(S):
        y = bb[:, s]
        if s > 0:
            bxp = st.bx[s - 1]
            y = y - (Oh[:, s] @ u[s - 1][:, bxp:bxp + nx, None])[..., 0]
        u.append(torch.linalg.solve(Tt[s], y))
        bph = bph - (Ch[s].transpose(1, 2) @ u[s][..., None])[..., 0]
    xp = torch.linalg.solve(Sp, bph) if a else bph
    xb = [None] * S
    for s in reversed(range(S)):
        x = u[s] - (V[s] @ xp[..., None])[..., 0]
        if s < S - 1:
            t = (Oh[:, s + 1].transpose(1, 2) @ xb[s + 1][..., None])
            x = x - (W[s] @ t)[..., 0]
        xb[s] = x
    return torch.cat([torch.stack(xb, dim=1).reshape(B, S * k), xp], dim=1)


def random_bbt_kkt(st: CollocStructure, B: int, seed: int = 0,
                   dtype=torch.float32, device=None):
    """Random quasi-definite (B, K, K) KKTs whose every nonzero lies in the
    BBT pattern of ``st`` (diagonal blocks, thin couplings, border), for
    kernel parity checks: symmetric, primal diagonal shifted positive and
    dual diagonal negative by more than each row's off-diagonal sum."""
    g = np.random.default_rng(seed)
    K = st.K
    mask = np.zeros((K + 1, K + 1), bool)
    perm = np.asarray(st.perm)
    border = np.asarray(st.border, np.int64)
    for s in range(st.S):
        p = perm[s]
        mask[p[:, None], p[None, :]] = True
        if s > 0:
            cols = perm[s - 1, st.bx[s - 1]:st.bx[s - 1] + st.nx]
            mask[p[:, None], cols[None, :]] = True
        mask[p[:, None], border[None, :]] = True
    mask[border[:, None], border[None, :]] = True
    mask = mask[:K, :K]
    mask = mask | mask.T
    lower = np.tril(g.normal(size=(B, K, K)), -1)
    M = (lower + lower.transpose(0, 2, 1)) * mask
    shift = np.abs(M).sum(axis=2) + 1.0
    sign = np.where(np.arange(K) < st.n, 1.0, -1.0)
    idx = np.arange(K)
    M[:, idx, idx] = sign * shift
    return torch.as_tensor(M, dtype=dtype, device=device)
