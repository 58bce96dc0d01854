"""Splines: equidistant cubic splines and Lagrange interpolation — the port
of polympc_tpu/basis/splines.py.

``CubicSpline`` holds the (n_segments, 4) Horner coefficient table as numpy
float64 (what the fit computes) and, made once at construction, as tensors
on the spline's device in float64 and float32.  Evaluation picks the table
of the argument's dtype, so a spline can sit inside dynamics that
``torch.func`` transforms (the race car's curvature lookup): no tensor is
first made inside a transform.  The segment lookup is floor -> long ->
``index_select``, which batches under ``vmap``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["CubicSpline", "fit_cubic_spline", "cubic_spline_eval",
           "cubic_spline_eval_np", "lagrange_interp"]


@dataclasses.dataclass(frozen=True)
class CubicSpline:
    """Equidistant natural (or periodic) cubic spline y(x) on
    [x0, x0 + n*h].

    ``coeffs`` is (n_segments, 4) Horner coefficients [a, b, c, d] per
    segment: y = a + b*s + c*s^2 + d*s^3 with s = x - x_left(segment).
    """
    x0: float
    h: float
    coeffs: np.ndarray  # (n_segments, 4) float64
    periodic: bool = False
    device: str = "cuda"

    def __post_init__(self):
        c = np.asarray(self.coeffs, np.float64)
        object.__setattr__(self, "coeffs", c)
        object.__setattr__(self, "_tables", {
            dt: torch.as_tensor(c, dtype=dt, device=self.device)
            for dt in (torch.float64, torch.float32)})

    @property
    def num_segments(self) -> int:
        return self.coeffs.shape[0]

    def table(self, dtype):
        """The coefficient table as a tensor of ``dtype`` on the spline's
        device (float64 and float32 are made at construction)."""
        t = self._tables.get(dtype)
        return t if t is not None else self._tables[torch.float64].to(dtype)

    def __call__(self, x):
        return cubic_spline_eval(self, x)


def fit_cubic_spline(x0: float, h: float, y: np.ndarray,
                     periodic: bool = False,
                     device="cuda") -> CubicSpline:
    """Fit a natural (or periodic) cubic spline through equidistant samples
    y: the tridiagonal moment system for the second derivatives M_i in
    numpy, then per-segment Horner coefficients."""
    y = np.asarray(y, dtype=np.float64)
    n = len(y) - 1  # segments
    if periodic:
        # cyclic system for M_0..M_{n-1}, M_n = M_0 (y[n] == y[0] assumed)
        A = np.zeros((n, n))
        rhs = np.zeros(n)
        for i in range(n):
            A[i, (i - 1) % n] = 1.0
            A[i, i] = 4.0
            A[i, (i + 1) % n] = 1.0
            rhs[i] = 6.0 / h**2 * (y[(i + 1) % n + 0] - 2 * y[i]
                                   + y[(i - 1) % n])
        M = np.zeros(n + 1)
        M[:n] = np.linalg.solve(A, rhs)
        M[n] = M[0]
    else:
        M = np.zeros(n + 1)
        if n > 1:
            A = np.diag(np.full(n - 1, 4.0)) + np.diag(np.ones(n - 2), 1) \
                + np.diag(np.ones(n - 2), -1)
            rhs = 6.0 / h**2 * (y[2:] - 2 * y[1:-1] + y[:-2])
            M[1:-1] = np.linalg.solve(A, rhs)
    coeffs = np.zeros((n, 4))
    for i in range(n):
        coeffs[i, 0] = y[i]
        coeffs[i, 1] = (y[i + 1] - y[i]) / h - h * (2 * M[i] + M[i + 1]) / 6.0
        coeffs[i, 2] = M[i] / 2.0
        coeffs[i, 3] = (M[i + 1] - M[i]) / (6.0 * h)
    return CubicSpline(x0=float(x0), h=float(h), coeffs=coeffs,
                       periodic=periodic, device=device)


def _segment(spline: CubicSpline, x):
    """Local offset s and the coefficient rows (..., 4) at x.  The periodic
    wrap is ``torch.remainder``, which equals ``jnp.mod`` for negative
    arguments."""
    n = spline.num_segments
    rel = (x - spline.x0) / spline.h
    if spline.periodic:
        rel = torch.remainder(rel, n)
    idx = torch.clamp(torch.floor(rel).long(), 0, n - 1)
    s = (rel - idx) * spline.h
    ck = spline.table(x.dtype).index_select(0, idx.reshape(-1))
    return s, ck.reshape(*idx.shape, 4)


def cubic_spline_eval(spline: CubicSpline, x):
    """Horner evaluation with clamped (or wrapped) segment lookup
    (ref: splines.hpp:61-84); differentiable in x."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, dtype=torch.float64, device=spline.device)
    s, ck = _segment(spline, x)
    return ck[..., 0] + s * (ck[..., 1] + s * (ck[..., 2] + s * ck[..., 3]))


def _derivatives(spline: CubicSpline, x):
    """(y, dy/dx, d2y/dx2) at x: the Horner polynomial and its two
    derivatives on the segment, what automatic differentiation of
    :func:`cubic_spline_eval` gives (the lookup is piecewise constant)."""
    s, ck = _segment(spline, x)
    a, b, c, d = ck.unbind(-1)
    y = a + s * (b + s * (c + s * d))
    dy = b + s * (2.0 * c + s * (3.0 * d))
    ddy = 2.0 * c + s * (6.0 * d)
    return y, dy, ddy


def cubic_spline_eval_np(spline: CubicSpline, x: np.ndarray) -> np.ndarray:
    """Pure-numpy spline evaluation for build-time code paths; the same
    math as :func:`cubic_spline_eval`."""
    c = np.asarray(spline.coeffs)
    n = c.shape[0]
    rel = (np.asarray(x) - spline.x0) / spline.h
    if spline.periodic:
        rel = np.mod(rel, n)
    idx = np.clip(np.floor(rel).astype(int), 0, n - 1)
    s = (rel - idx) * spline.h
    ck = c[idx]
    return ck[..., 0] + s * (ck[..., 1] + s * (ck[..., 2] + s * ck[..., 3]))


def lagrange_interp(nodes, bary_w, values, t):
    """Barycentric Lagrange interpolation at a scalar t.

    nodes: (N,) interpolation nodes; bary_w: (N,) barycentric weights;
    values: (N, ...) data at nodes.  Exactness at a node is handled by the
    epsilon-free barycentric trick (ref: splines.hpp:101-139,
    polymath.h:154-286).  All tensors on one device.
    """
    nodes = torch.as_tensor(nodes)
    bary_w = torch.as_tensor(bary_w, device=nodes.device)
    values = torch.as_tensor(values, device=nodes.device)
    d = t - nodes
    exact = torch.abs(d) < 1e-13
    any_exact = torch.any(exact)
    d_safe = torch.where(exact, torch.ones_like(d), d)
    c = bary_w / d_safe
    w = torch.where(any_exact, exact.to(values.dtype), c / torch.sum(c))
    w = w / torch.where(any_exact, torch.sum(w), torch.ones_like(w[0]))
    return torch.tensordot(w, values, dims=([0], [0]))
