"""Quasi-Newton Hessian updates and regularisation for the SQP's QP
subproblems — the port of polympc_tpu/nlp/hessian.py, batch-first.

Every matrix carries a leading lane axis: a dense B is (B, n, n), a
:class:`BlockHessian` holds (B, N, ., .) node blocks, and s, y are (B, n).
Each update is decided per lane: a lane whose step is degenerate (its skip
test fails) keeps its B unchanged while the others update.

  * ``bfgs_update``: damped BFGS keeping B positive definite (bfgs.hpp:23-52,
    Nocedal & Wright Procedure 18.2);
  * ``sr1_update``: safeguarded symmetric rank one (sr1.hpp:22-36);
  * ``block_bfgs_update``: the sparsity-preserving damped BFGS of the
    collocation NLP (continuous_ocp.hpp:2304-2431), on node-diagonal blocks
    plus the parameter arrow;
  * ``regularize``: make each lane's H safely positive definite.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from polympc_torch.utils.solver_utils import block_diag_scatter

__all__ = ["bfgs_update", "sr1_update", "regularize",
           "BlockHessian", "block_hessian_identity", "block_hessian_matvec",
           "block_bfgs_update", "assemble_block_hessian"]


def _mv(A, v):
    return (A @ v[..., None])[..., 0]


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _outer(a, b):
    return a[..., :, None] * b[..., None, :]


def _damped(sBs, sy, v, y):
    """The damped secant r = theta y + (1 - theta) v per lane, theta = 1
    where the curvature test s'y >= 0.2 s'Bs holds."""
    theta = torch.where(sy >= 0.2 * sBs, torch.ones_like(sBs),
                        0.8 * sBs / torch.clamp(sBs - sy, min=1e-16))
    r = theta[:, None] * y + (1.0 - theta)[:, None] * v
    return r


def bfgs_update(B, s, y):
    """Damped BFGS update keeping each lane's B (B, n, n) positive definite.

    theta damps y toward B s when the curvature condition s'y >= 0.2 s'Bs
    fails (Nocedal & Wright, Procedure 18.2).  Lanes with a degenerate step
    (s ~ 0) keep their B."""
    Bs = _mv(B, s)
    sBs = _dot(s, Bs)
    r = _damped(sBs, _dot(s, y), Bs, y)
    sr = _dot(s, r)
    ok = (sBs > 1e-14) & (sr > 1e-14)
    B_new = B - _outer(Bs, Bs) / torch.clamp(sBs, min=1e-16)[:, None, None] \
        + _outer(r, r) / torch.clamp(sr, min=1e-16)[:, None, None]
    return torch.where(ok[:, None, None], B_new, B)


def sr1_update(B, s, y):
    """Safeguarded symmetric-rank-1 update (Nocedal & Wright eq. 6.24),
    skipped per lane where |s'(y - Bs)| < 1e-6 ||s|| ||y - Bs||."""
    d = y - _mv(B, s)
    sd = _dot(s, d)
    ok = torch.abs(sd) >= 1e-6 * torch.linalg.vector_norm(s, dim=-1) \
        * torch.linalg.vector_norm(d, dim=-1) + 1e-16
    B_new = B + _outer(d, d) / torch.where(ok, sd, torch.ones_like(sd))[
        :, None, None]
    return torch.where(ok[:, None, None], B_new, B)


class BlockHessian(NamedTuple):
    """Compact storage of a collocation-structured quasi-Newton Hessian per
    lane: node-diagonal (xx, uu, xu) blocks plus the dense parameter arrow
    — the sparsity pattern the reference's block-BFGS touches
    (continuous_ocp.hpp:2304-2431)."""
    xx: torch.Tensor   # (B, N, nx, nx)
    uu: torch.Tensor   # (B, N, nu, nu)
    xu: torch.Tensor   # (B, N, nx, nu)
    ap: torch.Tensor   # (B, N*(nx+nu), np)  all-variables x parameters
    pp: torch.Tensor   # (B, np, np)


def block_hessian_identity(N: int, nx: int, nu: int, np_: int, B: int,
                           dtype=torch.float64, device="cuda"
                           ) -> BlockHessian:
    """B0 = I in block storage, for B lanes."""
    eye = lambda k: torch.eye(k, dtype=dtype, device=device).expand(
        B, N, k, k).clone()
    return BlockHessian(
        xx=eye(nx), uu=eye(nu),
        xu=torch.zeros((B, N, nx, nu), dtype=dtype, device=device),
        ap=torch.zeros((B, N * (nx + nu), np_), dtype=dtype, device=device),
        pp=torch.eye(np_, dtype=dtype, device=device).expand(
            B, np_, np_).clone())


def _split_nodes(v, N, nx, nu):
    """z-ordered (B, n) -> (vx (B, N, nx), vu (B, N, nu), vp (B, np))."""
    B = v.shape[0]
    vx = v[:, :N * nx].reshape(B, N, nx)
    vu = v[:, N * nx:N * (nx + nu)].reshape(B, N, nu)
    return vx, vu, v[:, N * (nx + nu):]


def block_hessian_matvec(H: BlockHessian, s, N: int, nx: int, nu: int):
    """v = H s per lane without materialising the dense matrix."""
    B = s.shape[0]
    sx, su, sp = _split_nodes(s, N, nx, nu)
    vx = torch.einsum("bkij,bkj->bki", H.xx, sx) + torch.einsum(
        "bkij,bkj->bki", H.xu, su)
    vu = torch.einsum("bkji,bkj->bki", H.xu, sx) + torch.einsum(
        "bkij,bkj->bki", H.uu, su)
    va = torch.cat([vx.reshape(B, -1), vu.reshape(B, -1)], dim=1)
    if H.pp.shape[-1]:
        sa = s[:, :N * (nx + nu)]
        va = va + _mv(H.ap, sp)
        vp = _mv(H.ap.transpose(1, 2), sa) + _mv(H.pp, sp)
        return torch.cat([va, vp], dim=1)
    return va


def block_bfgs_update(H: BlockHessian, s, y, N: int, nx: int, nu: int
                      ) -> BlockHessian:
    """Sparsity-preserving damped BFGS (continuous_ocp.hpp:2304-2431): the
    global damped rank-2 update -vv'/s'v + rr'/s'r (v = H s,
    r = theta y + (1 - theta) v) restricted to the node-diagonal blocks and
    the parameter arrow.  Lanes with a degenerate step keep their H."""
    v = block_hessian_matvec(H, s, N, nx, nu)
    sBs = _dot(s, v)
    r = _damped(sBs, _dot(s, y), v, y)
    sr = _dot(s, r)
    ok = (sBs > 1e-14) & (sr > 1e-14)
    zero = torch.zeros_like(sBs)
    ci = torch.where(ok, 1.0 / torch.clamp(sBs, min=1e-16), zero)
    cr = torch.where(ok, 1.0 / torch.clamp(sr, min=1e-16), zero)

    vx, vu, vp = _split_nodes(v, N, nx, nu)
    rx, ru, rp = _split_nodes(r, N, nx, nu)
    c4 = lambda c: c[:, None, None, None]

    def upd(a, b):
        return c4(cr) * torch.einsum("bki,bkj->bkij", a[0], a[1]) \
            - c4(ci) * torch.einsum("bki,bkj->bkij", b[0], b[1])
    xx = H.xx + upd((rx, rx), (vx, vx))
    uu = H.uu + upd((ru, ru), (vu, vu))
    xu = H.xu + upd((rx, ru), (vx, vu))
    if H.pp.shape[-1]:
        va = v[:, :N * (nx + nu)]
        ra = r[:, :N * (nx + nu)]
        c3 = lambda c: c[:, None, None]
        ap = H.ap + c3(cr) * _outer(ra, rp) - c3(ci) * _outer(va, vp)
        pp = H.pp + c3(cr) * _outer(rp, rp) - c3(ci) * _outer(vp, vp)
    else:
        ap, pp = H.ap, H.pp
    return BlockHessian(xx=xx, uu=uu, xu=xu, ap=ap, pp=pp)


def assemble_block_hessian(H: BlockHessian, N: int, nx: int, nu: int):
    """Dense (B, n, n) matrices from block storage (for the QP)."""
    XX = block_diag_scatter(H.xx)
    UU = block_diag_scatter(H.uu)
    XU = block_diag_scatter(H.xu)
    top = torch.cat([XX, XU], dim=2)
    mid = torch.cat([XU.transpose(1, 2), UU], dim=2)
    D = torch.cat([top, mid], dim=1)
    if H.pp.shape[-1]:
        D = torch.cat([torch.cat([D, H.ap], dim=2),
                       torch.cat([H.ap.transpose(1, 2), H.pp], dim=2)],
                      dim=1)
    return D


def _gershgorin_shift(Hs, floor):
    d = torch.diagonal(Hs, dim1=-2, dim2=-1)
    radii = torch.sum(torch.abs(Hs), dim=-1) - torch.abs(d)
    return torch.clamp(-torch.amin(d - radii, dim=-1) + floor, min=0.0)


def regularize(H, mode: str, eps: float):
    """Make each lane's H safely positive definite for the QP subproblem.

    "gershgorin": shift by the most negative Gershgorin disc bound.
    "mirror"/"clip": Newton-Schulz matrix sign, |H| = sign(H) H (40 steps of
    X <- 1.5 X - 0.5 X^3), then |H| + ridge ("mirror", negative eigenvalues
    flipped) or (H + |H|)/2 + ridge ("clip"); a lane whose sign iteration
    produced non-finite values takes the Gershgorin shift instead.
    "eigmin": shift by a power-iteration estimate of the most negative
    eigenvalue.  "ridge": fixed relative ridge.  "eigen": mirror negative
    eigenvalues by ``torch.linalg.eigh``.  Call under
    :class:`~polympc_torch.utils.precision.full_precision`: the sign
    iteration needs full-float32 matmuls.
    """
    if mode == "none":
        return H
    n = H.shape[-1]
    eye = torch.eye(n, dtype=H.dtype, device=H.device)
    if mode == "gershgorin":
        shift = _gershgorin_shift(H, eps)
        return H + shift[:, None, None] * eye
    Hs = 0.5 * (H + H.transpose(-1, -2))
    diag = torch.diagonal(Hs, dim1=-2, dim2=-1)
    scale = torch.clamp(torch.amax(torch.abs(diag), dim=-1), min=1.0)
    if mode in ("mirror", "clip"):
        # the scaling must be a guaranteed spectral-norm upper bound
        # (Newton-Schulz converges only for ||X0||_2 < sqrt(3)): the smaller
        # of the max-abs-row-sum and Frobenius norms
        nrm_inf = torch.amax(torch.sum(torch.abs(Hs), dim=-1), dim=-1)
        nrm_fro = torch.sqrt(torch.sum(Hs * Hs, dim=(-2, -1)))
        nrm = torch.clamp(torch.minimum(nrm_inf, nrm_fro), min=1e-12)
        X = Hs / (1.01 * nrm)[:, None, None]
        for _ in range(40):
            X = 1.5 * X - 0.5 * ((X @ X) @ X)
        XH = X @ Hs
        absH = 0.5 * (XH + XH.transpose(-1, -2))
        Hm = absH if mode == "mirror" else 0.5 * (Hs + absH)
        Hm = Hm + (eps * scale)[:, None, None] * eye
        gersh = Hs + _gershgorin_shift(Hs, eps * scale)[:, None, None] * eye
        ok = torch.isfinite(Hm).all(dim=-1).all(dim=-1)
        return torch.where(ok[:, None, None], Hm, gersh)
    if mode == "eigmin":
        idx = torch.arange(n, dtype=H.dtype, device=H.device)
        v = (torch.cos(idx * 1.7) + 0.3).expand(H.shape[0], n)
        mv = lambda A, x: (A @ x[..., None])[..., 0]
        for _ in range(12):
            v = mv(Hs, mv(Hs, v))
            v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1),
                                min=1e-30)[:, None]
        nrm2 = torch.sqrt(torch.clamp(
            torch.linalg.vector_norm(mv(Hs, mv(Hs, v)), dim=-1), min=1e-30))
        c = 1.05 * nrm2
        w = (torch.sin(idx * 2.3) + 0.2).expand(H.shape[0], n)
        for _ in range(20):
            w = c[:, None] * w - mv(Hs, w)
            w = w / torch.clamp(torch.linalg.vector_norm(w, dim=-1),
                                min=1e-30)[:, None]
        lam_min = torch.sum(w * mv(Hs, w), dim=-1)
        shift = 1.1 * torch.clamp(-lam_min, min=0.0) + eps * scale
        return Hs + shift[:, None, None] * eye
    if mode == "ridge":
        return Hs + (eps * scale)[:, None, None] * eye
    if mode == "eigen":
        w, V = torch.linalg.eigh(Hs)
        floor = eps * torch.clamp(torch.amax(torch.abs(w), dim=-1), min=1.0)
        w = torch.maximum(torch.abs(w), floor[:, None])
        return (V * w[:, None, :]) @ V.transpose(-1, -2)
    raise ValueError(f"unknown regularisation mode {mode!r}")
