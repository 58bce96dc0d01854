"""Hessian regularisation for the SQP's QP subproblems — the port of
``regularize`` in polympc_tpu/nlp/hessian.py (the quasi-Newton updates are
ported in slice 3).  Batch-first: H is (B, n, n) and every reduction is per
lane."""
from __future__ import annotations

import torch

__all__ = ["regularize"]


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
