"""Orthogonal projection of a function onto a polynomial basis on [a, b] —
the port of polympc_tpu/basis/projection.py (ref:
src/polynomials/projection.hpp:17-77).

The coefficients come from quadrature against the orthogonal basis at
build time, in numpy (they are constant data).  :meth:`Projection.eval`
reconstructs the function at torch points on their device by the
Clenshaw recurrence; calling the projection with numpy points evaluates
the Vandermonde form in numpy, as the JAX package's ``__call__`` does.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from polympc_torch.basis import nodes as _nodes
from polympc_torch.basis.basis import Basis

__all__ = ["Projection", "project"]


@dataclasses.dataclass(frozen=True)
class Projection:
    kind: str           # "chebyshev" | "legendre"
    a: float
    b: float
    coeffs: np.ndarray  # (order+1,)

    def __call__(self, t):
        """Evaluate the projection at t in [a, b] (numpy, build-time)."""
        x = 2.0 * (np.asarray(t) - self.a) / (self.b - self.a) - 1.0
        vander = (_nodes.chebyshev_vandermonde if self.kind == "chebyshev"
                  else _nodes.legendre_vandermonde)
        out = vander(np.atleast_1d(x), len(self.coeffs) - 1) @ self.coeffs
        return out if np.ndim(t) else out[0]

    def eval(self, t: torch.Tensor) -> torch.Tensor:
        """Evaluate the projection at a tensor of points t in [a, b] (any
        shape) on t's device, by the Clenshaw recurrence of the basis:
        T_{k+1} = 2x T_k - T_{k-1} (Chebyshev) or
        (k+1) L_{k+1} = (2k+1) x L_k - k L_{k-1} (Legendre)."""
        x = 2.0 * (t - self.a) / (self.b - self.a) - 1.0
        c = [float(v) for v in self.coeffs]
        N = len(c) - 1
        b1 = torch.zeros_like(x)
        b2 = torch.zeros_like(x)
        if self.kind == "chebyshev":
            for k in range(N, 0, -1):
                b1, b2 = c[k] + 2.0 * x * b1 - b2, b1
            return c[0] + x * b1 - b2
        # Legendre: alpha_k(x) = (2k+1)/(k+1) x, beta_{k+1} = -(k+1)/(k+2)
        for k in range(N, 0, -1):
            b1, b2 = (c[k] + (2 * k + 1) / (k + 1) * x * b1
                      - (k + 1) / (k + 2) * b2), b1
        return c[0] + x * b1 - 0.5 * b2


def project(f, basis: Basis, a: float = -1.0, b: float = 1.0) -> Projection:
    """Project f: [a, b] -> R onto the basis.

    Chebyshev: c_n = <f, T_n>_w / ||T_n||_w^2 with the Chebyshev weight
    quadrature (ref: projection.hpp:34-56).  Legendre:
    c_n = (2n+1)/2 sum_k w_k f(x_k) L_n(x_k) with LGL weights (ref:
    legendre.hpp:181-233).  At Lobatto points the discrete norm of the
    last polynomial is aliased (pi for T_N, 2/N for L_N)."""
    x = basis.nodes
    t = 0.5 * (b - a) * x + 0.5 * (b + a)
    fv = np.asarray([f(ti) for ti in t], dtype=np.float64)
    N = basis.order
    if basis.kind == "chebyshev":
        w = _nodes.chebyshev_quadrature_weights(N)
        V = _nodes.chebyshev_vandermonde(x, N)
        norms = np.full(N + 1, np.pi / 2.0)
        norms[0] = np.pi
        norms[N] = np.pi
    else:
        w = basis.quad_weights
        V = _nodes.legendre_vandermonde(x, N)
        norms = 2.0 / (2.0 * np.arange(N + 1) + 1.0)
        norms[N] = 2.0 / N
    coeffs = (V.T @ (w * fv)) / norms
    return Projection(kind=basis.kind, a=float(a), b=float(b), coeffs=coeffs)
