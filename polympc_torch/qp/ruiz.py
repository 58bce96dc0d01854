"""Ruiz equilibration preconditioner for QPs, batch-first — the port of
polympc_tpu/qp/ruiz.py.

Iterative sqrt-inf-norm row/column scaling of the KKT matrix [H A'; A 0]
plus cost scaling, as in the OSQP paper section 5.1, per lane.  Scaled
problem: H' = c*D H D, h' = c*D h, A' = E A D, al' = E al, au' = E au,
xl' = xl/D, xu' = xu/D.  Recover: x = D x', y = E y' / c,
y_box = y'_box / (D c).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from polympc_torch.qp.types import QPData

__all__ = ["RuizScaling", "ruiz_equilibrate", "unscale_solution"]


class RuizScaling(NamedTuple):
    d: torch.Tensor  # (B, n) primal scaling
    e: torch.Tensor  # (B, m) dual scaling
    c: torch.Tensor  # (B,) cost scaling


def _amax(v, dim):
    return torch.amax(torch.abs(v), dim=dim)


def ruiz_equilibrate(qp: QPData, iters: int = 4):
    """Equilibrate every lane's QP; returns (scaled_qp, RuizScaling).

    ``iters`` sweeps (the reference caps at 4,
    qp_preconditioners.hpp:153-235)."""
    B, n = qp.h.shape
    m = qp.A.shape[-2]
    dt, dev = qp.H.dtype, qp.H.device
    H, h, A = qp.H, qp.h, qp.A
    d = torch.ones((B, n), dtype=dt, device=dev)
    e = torch.ones((B, m), dtype=dt, device=dev)
    c = torch.ones(B, dtype=dt, device=dev)
    for _ in range(iters):
        # column norms of [H; A] -> d update; row norms of A -> e update
        cn = _amax(H, 1)
        if m:
            cn = torch.maximum(cn, _amax(A, 1))
        delta_d = 1.0 / torch.sqrt(torch.clamp(cn, min=1e-12))
        H = H * delta_d[:, :, None] * delta_d[:, None, :]
        h = h * delta_d
        if m:
            delta_e = 1.0 / torch.sqrt(torch.clamp(_amax(A, 2), min=1e-12))
            A = A * delta_e[:, :, None] * delta_d[:, None, :]
            e = e * delta_e
        d = d * delta_d
        # cost scaling (OSQP section 5.1: gamma = 1/max(mean col-norm of H,
        # ||h||_inf))
        mean_col = torch.mean(_amax(H, 1), dim=1)
        scale = torch.maximum(mean_col, _amax(h, 1)) if n else mean_col
        gamma = 1.0 / torch.clamp(scale, min=1e-12)
        H = H * gamma[:, None, None]
        h = h * gamma[:, None]
        c = c * gamma
    scaled = QPData(H=H, h=h, A=A,
                    al=e * qp.al if m else qp.al,
                    au=e * qp.au if m else qp.au,
                    xl=qp.xl / d, xu=qp.xu / d)
    return scaled, RuizScaling(d=d, e=e, c=c)


def unscale_solution(x, y, y_box, s: RuizScaling):
    """Map a scaled-problem solution back to the original problem
    (ref: qp_preconditioners.hpp:316-352)."""
    c = s.c[:, None]
    return s.d * x, s.e * y / c, y_box / (s.d * c)
