"""Setup-time collocation node/weight/matrix computation (numpy, float64).

Collocation data (nodes, quadrature weights, differentiation matrices) depends
only on the *static* polynomial order, so it is computed once at problem-build
time in numpy float64 and handed to the solvers as constants.  This
replaces the reference's compile-time computation in
``src/polynomials/ebyshev.hpp:111-214`` and ``src/polynomials/legendre.hpp:126-197``.

Convention: nodes are ASCENDING on [-1, 1] (node 0 = left endpoint = t0).  The
reference uses descending CGL nodes and reverse-ordered trajectories
(``continuous_ocp.hpp:55,158``); we deliberately do NOT copy that quirk.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "cgl_nodes", "lgl_nodes", "lg_nodes", "lgr_nodes",
    "barycentric_weights", "diff_matrix",
    "clenshaw_curtis_weights", "lgl_weights", "chebyshev_quadrature_weights",
    "legendre_vandermonde", "chebyshev_vandermonde",
    "legendre_galerkin_tensor", "poly_mul", "poly_diff",
]


def cgl_nodes(order: int) -> np.ndarray:
    """Chebyshev-Gauss-Lobatto nodes, ascending on [-1, 1].

    x_k = -cos(k*pi/N), k = 0..N  (ref: ebyshev.hpp:111-117, descending there).
    """
    if order < 1:
        raise ValueError(f"polynomial order must be >= 1, got {order}")
    k = np.arange(order + 1)
    x = -np.cos(np.pi * k / order)
    # exact endpoints / midpoint
    x[0], x[-1] = -1.0, 1.0
    if order % 2 == 0:
        x[order // 2] = 0.0
    return x


def lgl_nodes(order: int, tol: float = 1e-15, max_iter: int = 100):
    """Legendre-Gauss-Lobatto nodes (ascending) and weights.

    Nodes are the roots of (1-x^2) L'_N(x); found by Newton iteration on the
    Legendre recurrence (the classical Gauss-Lobatto algorithm).  Weights
    w_k = 2 / (N(N+1) L_N(x_k)^2)  (ref: legendre.hpp:126-197).
    """
    n = order
    if n < 1:
        raise ValueError(f"polynomial order must be >= 1, got {n}")
    if n == 1:
        return np.array([-1.0, 1.0]), np.array([1.0, 1.0])
    # Chebyshev-Gauss-Lobatto initial guess
    x = -np.cos(np.pi * np.arange(n + 1) / n)
    P = np.zeros((n + 1, n + 1))
    x_old = np.full_like(x, 2.0)
    for _ in range(max_iter):
        if np.max(np.abs(x - x_old)) <= tol:
            break
        x_old = x.copy()
        P[:, 0] = 1.0
        P[:, 1] = x
        for j in range(2, n + 1):
            P[:, j] = ((2 * j - 1) * x * P[:, j - 1] - (j - 1) * P[:, j - 2]) / j
        # Newton step for roots of (1-x^2) L'_N
        x = x_old - (x * P[:, n] - P[:, n - 1]) / ((n + 1) * P[:, n])
    x[0], x[-1] = -1.0, 1.0
    if n % 2 == 0:
        x[n // 2] = 0.0
    P[:, 0] = 1.0
    P[:, 1] = x
    for j in range(2, n + 1):
        P[:, j] = ((2 * j - 1) * x * P[:, j - 1] - (j - 1) * P[:, j - 2]) / j
    w = 2.0 / (n * (n + 1) * P[:, n] ** 2)
    return x, w


def lgl_weights(order: int) -> np.ndarray:
    return lgl_nodes(order)[1]


def lg_nodes(order: int):
    """Legendre-Gauss nodes and weights: order+1 strictly interior points on
    (-1, 1), quadrature exact to polynomial degree 2*order + 1 — the GAUSS
    member of the reference's collocation_scheme enum
    (polynomial_math.hpp:25), which the reference never implements beyond
    the enum."""
    if order < 0:
        raise ValueError(f"polynomial order must be >= 0, got {order}")
    x, w = np.polynomial.legendre.leggauss(order + 1)
    return x, w


def lgr_nodes(order: int, flip: bool = False):
    """Legendre-Gauss-Radau nodes and weights: order+1 points including the
    LEFT endpoint x = -1 (``flip=True``: the RIGHT endpoint +1, the
    Radau-IIA / stiffly-accurate flavour), quadrature exact to degree
    2*order — the GAUSS_RADAU member of the reference's scheme enum
    (polynomial_math.hpp:25).

    Nodes are the roots of L_n + L_{n+1} with n = order (which include -1);
    weights: w = 2/(n+1)^2 at the endpoint, (1 - x_i)/((n+1)^2 L_n(x_i)^2)
    inside (Abramowitz & Stegun 25.4.31).
    """
    n = order            # n+1 total points
    if n < 1:
        raise ValueError(f"Radau needs order >= 1, got {n}")
    c = np.zeros(n + 2)
    c[n] = 1.0
    c[n + 1] = 1.0
    x = np.polynomial.legendre.legroots(c)
    x = np.sort(np.real(x))
    x[0] = -1.0
    Ln = legendre_vandermonde(x, n)[:, n]
    w = np.empty(n + 1)
    w[0] = 2.0 / (n + 1) ** 2
    w[1:] = (1.0 - x[1:]) / ((n + 1) ** 2 * Ln[1:] ** 2)
    if flip:
        x, w = -x[::-1], w[::-1]
    return x, w


def barycentric_weights(x: np.ndarray) -> np.ndarray:
    """Barycentric interpolation weights for arbitrary distinct nodes."""
    n = len(x)
    w = np.ones(n)
    for i in range(n):
        w[i] = 1.0 / np.prod(x[i] - np.delete(x, i))
    # normalise to avoid overflow for large orders
    return w / np.max(np.abs(w))


def diff_matrix(x: np.ndarray) -> np.ndarray:
    """Spectral differentiation matrix for arbitrary nodes (barycentric form).

    D[i, j] = (w_j / w_i) / (x_i - x_j) for i != j; D[i, i] = -sum_j D[i, j].
    The negative-row-sum diagonal enforces exact differentiation of constants
    (ref: ebyshev.hpp:198-214, legendre.hpp:156-179 use basis-specific closed
    forms; the barycentric form is equivalent and general).
    """
    n = len(x)
    w = barycentric_weights(x)
    dx = x[:, None] - x[None, :]
    np.fill_diagonal(dx, 1.0)
    D = (w[None, :] / w[:, None]) / dx
    np.fill_diagonal(D, 0.0)
    np.fill_diagonal(D, -np.sum(D, axis=1))
    return D


def clenshaw_curtis_weights(order: int) -> np.ndarray:
    """Clenshaw-Curtis quadrature weights on [-1,1] at CGL nodes (ascending).

    Integrates polynomials of degree <= order exactly for even orders
    (ref: ebyshev.hpp:121-159).
    """
    n = order
    if n == 0:
        return np.array([2.0])
    k = np.arange(n + 1)
    theta = np.pi * k / n
    w = np.ones(n + 1)
    jmax = n // 2
    for j in range(1, jmax + 1):
        b = 1.0 if 2 * j == n else 2.0
        w -= b * np.cos(2.0 * j * theta) / (4.0 * j * j - 1.0)
    w *= 2.0 / n
    w[0] *= 0.5
    w[-1] *= 0.5
    return w


def chebyshev_quadrature_weights(order: int) -> np.ndarray:
    """Gauss-Chebyshev-Lobatto weights (pi/N, halved at endpoints) for
    projections w.r.t. the Chebyshev weight 1/sqrt(1-x^2)
    (ref: ebyshev.hpp:162-169)."""
    n = order
    w = np.full(n + 1, np.pi / n)
    w[0] *= 0.5
    w[-1] *= 0.5
    return w


def chebyshev_vandermonde(x: np.ndarray, order: int) -> np.ndarray:
    """V[i, j] = T_j(x_i), Chebyshev polynomials of the first kind."""
    n = len(x)
    V = np.zeros((n, order + 1))
    V[:, 0] = 1.0
    if order >= 1:
        V[:, 1] = x
    for j in range(2, order + 1):
        V[:, j] = 2.0 * x * V[:, j - 1] - V[:, j - 2]
    return V


def legendre_vandermonde(x: np.ndarray, order: int) -> np.ndarray:
    """V[i, j] = L_j(x_i) via the three-term recurrence
    (ref: legendre.hpp:236-263)."""
    n = len(x)
    V = np.zeros((n, order + 1))
    V[:, 0] = 1.0
    if order >= 1:
        V[:, 1] = x
    for j in range(2, order + 1):
        V[:, j] = ((2 * j - 1) * x * V[:, j - 1] - (j - 1) * V[:, j - 2]) / j
    return V


def poly_mul(p1: np.ndarray, p2: np.ndarray) -> np.ndarray:
    """Truncating product of two monomial-coefficient polynomials: the
    result keeps len(p1) coefficients (higher orders dropped), ascending
    powers — the behaviour of the reference's fixed-size poly_mul
    (polynomial_math.hpp:43-78).  NOTE: the reference's loop overwrites
    instead of accumulating coinciding powers (``product[i+j] = ...``); this
    implementation accumulates, which is the mathematically correct product.
    """
    p1 = np.asarray(p1, np.float64)
    p2 = np.asarray(p2, np.float64)
    full = np.convolve(p1, p2)
    return full[: len(p1)]


def poly_diff(p: np.ndarray) -> np.ndarray:
    """Derivative of a monomial-coefficient polynomial, same fixed length
    (ascending powers, zero-padded) — polynomial_math.hpp:81-93."""
    p = np.asarray(p, np.float64)
    out = np.zeros_like(p)
    k = np.arange(1, len(p))
    out[: len(p) - 1] = k * p[1:]
    return out


def legendre_galerkin_tensor(order: int, normalized: bool = False) -> np.ndarray:
    """Galerkin product tensor G[i, j, k] = ∫_{-1}^{1} L_i L_j L_k dx.

    Used for spectral (Galerkin) products: if f = Σ a_i L_i and
    g = Σ b_j L_j then the coefficients of f·g projected back onto the
    basis are  c_k = Σ_ij G[i,j,k] a_i b_j / ||L_k||².

    With ``normalized=True`` each k-slice is multiplied by the norm factor
    1/||L_k||² = (2k+1)/2, matching the tensor the reference stores
    (legendre.hpp:266-285 bakes NormFactors[k] in — computed there by
    quadrature but left disabled in the constructor at legendre.hpp:122;
    enabled here).  The default (raw integrals) is the convention used by
    the rest of this package.
    """
    # integrand degree is 3*order: exact with >= (3*order+1)/2 Gauss points
    npts = int(np.ceil((3 * order + 1) / 2)) + 1
    x, w = np.polynomial.legendre.leggauss(npts)
    V = legendre_vandermonde(x, order)            # (npts, order+1)
    G = np.einsum("qi,qj,qk,q->ijk", V, V, V, w)
    if normalized:
        k = np.arange(order + 1)
        G = G * ((2.0 * k + 1.0) / 2.0)[None, None, :]
    return G
