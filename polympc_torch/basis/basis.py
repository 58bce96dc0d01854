"""Collocation basis objects: Chebyshev, Legendre, and multi-segment meshes.

These are *build-time* objects (plain Python, numpy float64 data).  Solver
code turns their arrays into tensors on the solve's device — the analogue of
the reference's compile-time template instantiation
(``Chebyshev<PolyOrder,GAUSS_LOBATTO,Scalar>``, ebyshev.hpp:27-94;
``Spline<Polynomial,NumSegments>``, splines.hpp:22-46).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from polympc_torch.basis import nodes as _nodes

__all__ = ["Basis", "Chebyshev", "Legendre", "LegendreGauss",
           "LegendreRadau", "SegmentedBasis"]


@dataclasses.dataclass(frozen=True)
class Basis:
    """One collocation segment: order+1 nodes on [-1, 1].

    Attributes:
      order:   polynomial order N (order+1 nodes).
      kind:    "chebyshev" | "legendre".
      nodes:   (N+1,) ascending nodes on [-1, 1].
      D:       (N+1, N+1) spectral differentiation matrix on [-1, 1].
      quad_weights: (N+1,) integration weights on [-1, 1]
                    (Clenshaw-Curtis for Chebyshev, LGL for Legendre).
      bary_w:  (N+1,) barycentric interpolation weights.
    """
    order: int
    kind: str
    nodes: np.ndarray
    D: np.ndarray
    quad_weights: np.ndarray
    bary_w: np.ndarray

    @property
    def num_nodes(self) -> int:
        return self.order + 1

    @property
    def has_left_endpoint(self) -> bool:
        return bool(np.isclose(self.nodes[0], -1.0))

    @property
    def has_right_endpoint(self) -> bool:
        return bool(np.isclose(self.nodes[-1], 1.0))

    def integrate(self, f: Callable, a: float = -1.0, b: float = 1.0):
        """Quadrature of f over [a, b] (ref: ebyshev.hpp:182-195)."""
        t = 0.5 * (b - a) * self.nodes + 0.5 * (b + a)
        vals = np.asarray([f(ti) for ti in t])
        return 0.5 * (b - a) * np.tensordot(self.quad_weights, vals, axes=1)

    def interp_matrix(self, t: np.ndarray) -> np.ndarray:
        """Barycentric Lagrange interpolation matrix: P[k, i] = l_i(t_k), so
        that values_at_t = P @ values_at_nodes.  Exact at the nodes."""
        t = np.atleast_1d(np.asarray(t, dtype=np.float64))
        d = t[:, None] - self.nodes[None, :]
        exact = np.isclose(d, 0.0, atol=1e-14)
        d = np.where(exact, 1.0, d)
        c = self.bary_w[None, :] / d
        P = c / np.sum(c, axis=1, keepdims=True)
        row_has_exact = exact.any(axis=1)
        P[row_has_exact] = exact[row_has_exact].astype(np.float64)
        return P


def Chebyshev(order: int) -> Basis:
    """Chebyshev-Gauss-Lobatto basis (ref: ebyshev.hpp:27-214)."""
    x = _nodes.cgl_nodes(order)
    return Basis(
        order=order,
        kind="chebyshev",
        nodes=x,
        D=_nodes.diff_matrix(x),
        quad_weights=_nodes.clenshaw_curtis_weights(order),
        bary_w=_nodes.barycentric_weights(x),
    )


def Legendre(order: int) -> Basis:
    """Legendre-Gauss-Lobatto basis (ref: legendre.hpp:19-285)."""
    x, w = _nodes.lgl_nodes(order)
    return Basis(
        order=order,
        kind="legendre",
        nodes=x,
        D=_nodes.diff_matrix(x),
        quad_weights=w,
        bary_w=_nodes.barycentric_weights(x),
    )


def LegendreGauss(order: int) -> Basis:
    """Legendre-Gauss basis: strictly interior nodes, quadrature exact to
    degree 2*order + 1 — the GAUSS scheme of the reference's enum
    (polynomial_math.hpp:25; never implemented there).  For quadrature,
    projection and pseudospectral integration; collocation transcription
    requires an endpoint node to pin the initial condition (use Radau or
    Lobatto)."""
    x, w = _nodes.lg_nodes(order)
    return Basis(order=order, kind="gauss", nodes=x,
                 D=_nodes.diff_matrix(x), quad_weights=w,
                 bary_w=_nodes.barycentric_weights(x))


def LegendreRadau(order: int, flip: bool = False) -> Basis:
    """Legendre-Gauss-Radau basis — the GAUSS_RADAU scheme
    (polynomial_math.hpp:25).  Includes the left endpoint (segment start;
    IC-pinnable), quadrature exact to degree 2*order.  ``flip=True`` gives
    the right-endpoint (Radau-IIA, stiffly-accurate) flavour used by the
    implicit pseudospectral integrator."""
    x, w = _nodes.lgr_nodes(order, flip=flip)
    return Basis(order=order, kind="radau" if not flip else "radau2",
                 nodes=x, D=_nodes.diff_matrix(x), quad_weights=w,
                 bary_w=_nodes.barycentric_weights(x))


@dataclasses.dataclass(frozen=True)
class SegmentedBasis:
    """Multi-segment (composite / spectral-element) collocation mesh.

    num_nodes = order * num_segments + 1 — adjacent segments share their
    boundary node (ref: splines.hpp:29-46).  Segment s owns global nodes
    [s*order, s*order + order].

    ``seg_idx`` is the (num_segments, order+1) static gather map from global
    node index to per-segment nodes; transcription code uses it with
    ``x[seg_idx]`` to evaluate per-segment defects without a global sparse
    differentiation matrix (replacing the Kronecker-composite sparse D of
    continuous_ocp.hpp:313-339).
    """
    basis: Basis
    num_segments: int

    @property
    def order(self) -> int:
        return self.basis.order

    @property
    def shares_boundary(self) -> bool:
        """Lobatto-type bases (both endpoints in the node set) share the
        boundary node between adjacent segments; Radau/Gauss segments stack
        without sharing (no right-endpoint node to share)."""
        return self.basis.has_left_endpoint and self.basis.has_right_endpoint

    @property
    def num_nodes(self) -> int:
        if self.shares_boundary:
            return self.basis.order * self.num_segments + 1
        return (self.basis.order + 1) * self.num_segments

    @property
    def _stride(self) -> int:
        """Global node-index stride between segment starts."""
        return self.basis.order if self.shares_boundary else \
            self.basis.order + 1

    @property
    def seg_idx(self) -> np.ndarray:
        p = self.basis.order
        s = np.arange(self.num_segments)[:, None]
        k = np.arange(p + 1)[None, :]
        return s * self._stride + k

    def time_nodes(self, t0: float, tf: float) -> np.ndarray:
        """Global time grid: per-segment affine maps of the [-1,1] nodes
        (ref: continuous_ocp.hpp:50-55, without the reversal)."""
        st = self._stride
        p = self.basis.order
        dt = (tf - t0) / self.num_segments
        t = np.empty(self.num_nodes)
        for s in range(self.num_segments):
            a = t0 + s * dt
            seg_t = a + 0.5 * dt * (self.basis.nodes + 1.0)
            t[s * st: s * st + p + 1] = seg_t
        if self.basis.has_left_endpoint:
            t[0] = t0
        if self.basis.has_right_endpoint:
            t[-1] = tf
        return t

    def composite_diff_matrix(self, t0: float, tf: float) -> np.ndarray:
        """Dense composite differentiation matrix on the global grid.

        Block-overlapped copies of (2/dt) * D; at shared boundary nodes the
        left segment's row is kept (either is a valid one-sided derivative;
        defect constraints use per-segment rows anyway).  For tests and the
        legacy-style ``ode_collocation`` API.
        """
        st = self._stride
        p = self.basis.order
        n = self.num_nodes
        dt = (tf - t0) / self.num_segments
        Dg = np.zeros((n, n))
        scale = 2.0 / dt
        for s in range(self.num_segments):
            i0 = s * st
            # at a shared boundary node keep the left segment's row
            r0 = 1 if (s > 0 and self.shares_boundary) else 0
            Dg[i0 + r0:i0 + p + 1, i0:i0 + p + 1] = scale * self.basis.D[r0:]
        return Dg

    def quadrature_weights(self, t0: float, tf: float) -> np.ndarray:
        """Global quadrature weights: per-segment (dt/2)*w, summed at shared
        boundary nodes (so sum(w) = tf - t0)."""
        st = self._stride
        p = self.basis.order
        dt = (tf - t0) / self.num_segments
        w = np.zeros(self.num_nodes)
        for s in range(self.num_segments):
            w[s * st: s * st + p + 1] += 0.5 * dt * self.basis.quad_weights
        return w

    def continuity_matrix(self) -> np.ndarray:
        """For non-boundary-sharing meshes (Radau/Gauss): the static
        ((num_segments-1), num_nodes) operator R with R @ X = x(seg s at
        tau=1) - x(seg s+1 at tau=-1) — the inter-segment state continuity
        constraints that shared nodes provide for free on Lobatto meshes.
        Returns an empty (0, num_nodes) matrix when boundaries are shared.
        """
        S = self.num_segments
        if self.shares_boundary or S == 1:
            return np.zeros((0, self.num_nodes))
        st = self._stride
        p = self.basis.order
        r_end = self.basis.interp_matrix(1.0)[0]     # eval at segment end
        r_head = self.basis.interp_matrix(-1.0)[0]   # eval at segment start
        R = np.zeros((S - 1, self.num_nodes))
        for s in range(S - 1):
            R[s, s * st: s * st + p + 1] = r_end
            R[s, (s + 1) * st: (s + 1) * st + p + 1] -= r_head
        return R

    def interp_matrix(self, t, t0: float, tf: float) -> np.ndarray:
        """Global barycentric interpolation matrix at arbitrary times t in
        [t0, tf]: each query is interpolated within its containing segment
        (ref: mpc_wrapper.hpp:245-281 Lagrange solution interpolation)."""
        t = np.atleast_1d(np.asarray(t, dtype=np.float64))
        st = self._stride
        p = self.basis.order
        dt = (tf - t0) / self.num_segments
        P = np.zeros((len(t), self.num_nodes))
        seg = np.clip(((t - t0) / dt).astype(int), 0, self.num_segments - 1)
        for k, (tk, s) in enumerate(zip(t, seg)):
            tau = 2.0 * (tk - (t0 + s * dt)) / dt - 1.0
            P[k, s * st: s * st + p + 1] = self.basis.interp_matrix(tau)[0]
        return P
