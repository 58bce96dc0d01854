"""LQR / CARE / Lyapunov solvers, batch-first and differentiable — the port
of polympc_tpu/control/lqr.py (ref: src/control/lqr.hpp:10-231).

Every function takes one system, ``(n, n)`` matrices, or a batch of them,
``(B, n, n)``, and returns results of the same kind; a batch holds many
linearisation points at once.  The algorithms are the JAX package's:

  - Lyapunov equations by the Kronecker-form linear solve
    ``(I (x) A' + A' (x) I) vec(P) = -vec(Q)`` (the reference does a Schur
    back-substitution, lqr.hpp:29-53; same equation);
  - CARE by Newton-Kleinman from the Bass stabilising initialisation
    (the role of init_newton_care, lqr.hpp:144-175), ``num_newton`` steps,
    with the reference's exact quartic line search (lqr.hpp:93-142) as an
    option.  The reference leaves its Newton refinement disabled
    (lqr.hpp:183-185); here, as in the JAX package, it runs.

Everything is plain ``torch.linalg`` and so differentiable through
autograd.  Every entry point runs under :func:`full_precision` (no TF32),
as the JAX functions run at ``Precision.HIGHEST``.
"""
from __future__ import annotations

import torch

from polympc_torch.utils.precision import full_precision

__all__ = ["lyapunov", "care", "lqr", "pinv"]


def _lanes(*mats):
    """Give every matrix a leading lane axis: returns (batched matrices,
    True if the inputs were unbatched).  Unbatched matrices beside batched
    ones are broadcast to the batch."""
    single = all(m.ndim == 2 for m in mats)
    if single:
        return tuple(m[None] for m in mats), True
    B = max(m.shape[0] for m in mats if m.ndim == 3)
    return tuple(m.expand(B, *m.shape[-2:]) if m.ndim == 2 else m
                 for m in mats), False


def _out(t, single):
    return t[0] if single else t


def _t(m):
    return m.transpose(-1, -2)


@full_precision()
def pinv(a, eps: float = 1e-9):
    """SVD pseudo-inverse of (..., r, c) matrices (ref: lqr.hpp:10-25):
    singular values below ``eps`` times the largest are dropped."""
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    keep = s > eps * torch.amax(s, dim=-1, keepdim=True)
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    return (_t(vh) * s_inv[..., None, :]) @ _t(u)


def _lyapunov(A, Q):
    """A' P + P A + Q = 0 on lanes: A, Q (B, n, n)."""
    B, n, _ = A.shape
    In = torch.eye(n, dtype=A.dtype, device=A.device)
    At = _t(A)
    # kron(I, A') + kron(A' , I), row-major vec as in the JAX package
    K = (torch.einsum("ij,bkl->bikjl", In, At)
         + torch.einsum("bij,kl->bikjl", At, In)).reshape(B, n * n, n * n)
    p = torch.linalg.solve(K, -Q.reshape(B, n * n))
    P = p.reshape(B, n, n)
    return 0.5 * (P + _t(P))


@full_precision()
def lyapunov(A, Q):
    """Solve the continuous Lyapunov equation  A' P + P A + Q = 0  for P
    (Kronecker-form solve; ref: lqr.hpp:29-53)."""
    (A, Q), single = _lanes(A, Q)
    return _out(_lyapunov(A, Q), single)


def _care_residual(P, A, B, Q, R_inv):
    return _t(A) @ P + P @ A - P @ B @ R_inv @ _t(B) @ P + Q


def _care_exact_step(a, b, c):
    """Exact line search for the Newton-CARE step per lane (ref:
    lqr.hpp:93-142, ``line_search_care``): minimise the quartic

        f(t) = a (1-t)^2 - 2 b (1-t) t^2 + c t^4

    over t in [1e-5, 2] (a = tr(R^2), b = tr(R V), c = tr(V^2), V = H G H)
    by a 129-point grid and four Newton polish steps of the best point, as
    the JAX package does (f has at most three critical points, so the grid
    brackets the global minimiser).  a, b, c (B,); returns t (B,)."""
    quartic = lambda a, b, c, t: (a * (1 - t) ** 2 - 2 * b * (1 - t) * t ** 2
                                  + c * t ** 4)
    f = lambda t: quartic(a, b, c, t)
    fp = lambda t: (-2 * a * (1 - t) - 2 * b * (2 * t - 3 * t ** 2)
                    + 4 * c * t ** 3)
    fpp = lambda t: 2 * a - 4 * b + 12 * b * t + 12 * c * t ** 2
    ts = torch.linspace(1e-5, 2.0, 129, dtype=a.dtype, device=a.device)
    grid = quartic(a[:, None], b[:, None], c[:, None], ts)
    t = ts[torch.argmin(grid, dim=1)]
    for _ in range(4):
        d2 = fpp(t)
        step = fp(t) / torch.where(torch.abs(d2) > 1e-300, d2,
                                   torch.ones_like(d2))
        t2 = torch.clamp(t - step, 1e-5, 2.0)
        t = torch.where(f(t2) <= f(t), t2, t)
    # degenerate direction (V ~ 0): the full Newton step is exact
    return torch.where(c > 1e-300 * torch.clamp(a, min=1.0), t,
                       torch.ones_like(t))


def _care(A, B, Q, R, num_newton, shift, line_search):
    """CARE on lanes: A, Q (L, n, n), B (L, n, m), R (L, m, m)."""
    n = A.shape[-1]
    R_inv = torch.linalg.inv(R)
    In = torch.eye(n, dtype=A.dtype, device=A.device)
    # Bass initialisation: beta above max Re(eig(A)) by the Gershgorin
    # row-sum bound; (A + beta I) W + W (A + beta I)' = 2 B B'; then
    # K0 = B' W^-1 makes A - B K0 Hurwitz for a controllable (A, B)
    if shift is None:
        beta = torch.amax(torch.sum(torch.abs(A), dim=-1), dim=-1) + 0.5
    else:
        beta = torch.full(A.shape[:1], float(shift), dtype=A.dtype,
                          device=A.device)
    M = -(A + beta[:, None, None] * In)
    W = _lyapunov(_t(M), 2.0 * B @ _t(B))
    # ridge for stabilisable-but-uncontrollable systems
    tr = torch.diagonal(W, dim1=-2, dim2=-1).sum(-1)
    W = W + (1e-10 * tr)[:, None, None] * In
    K0 = _t(torch.linalg.solve(_t(W), B))
    P = _lyapunov(A - B @ K0, Q + _t(K0) @ R @ K0)
    G = B @ R_inv @ _t(B)
    for _ in range(num_newton):
        K = R_inv @ _t(B) @ P
        Acl = A - B @ K
        if line_search:
            # Newton direction H: Acl' H + H Acl + R(X) = 0, then the exact
            # quartic step (lqr.hpp:108-127)
            RX = _care_residual(P, A, B, Q, R_inv)
            H = _lyapunov(Acl, RX)
            V = H @ G @ H
            t = _care_exact_step(torch.sum(RX * RX, dim=(-2, -1)),
                                 torch.sum(RX * V, dim=(-2, -1)),
                                 torch.sum(V * V, dim=(-2, -1)))
            P = P + t[:, None, None] * H
        else:
            P = _lyapunov(Acl, Q + _t(K) @ R @ K)
        P = 0.5 * (P + _t(P))
    return P


@full_precision()
def care(A, B, Q, R, num_newton: int = 30, shift: float | None = None,
         line_search: bool = False):
    """Continuous algebraic Riccati equation

        A'P + PA - P B R^-1 B' P + Q = 0

    by ``num_newton`` Newton-Kleinman steps from the Bass stabilising
    initialisation (Kleinman 1968: each step solves the Lyapunov equation
    of the current closed loop).  ``line_search=True`` takes X + t H along
    the Newton direction with t minimising ||R(X + tH)||_F^2 over
    [1e-5, 2] (the reference's exact quartic line search).  A, Q (n, n) or
    (B, n, n); B (n, m) or (B, n, m); R (m, m) or (B, m, m)."""
    (A, B, Q, R), single = _lanes(A, B, Q, R)
    return _out(_care(A, B, Q, R, num_newton, shift, line_search), single)


@full_precision()
def lqr(A, B, Q, R, M=None, num_newton: int = 30):
    """Infinite-horizon continuous LQR gain (ref: lqr.hpp:193-229).

    Returns (K, P) with u = -K x minimising  integral x'Qx + u'Ru + 2x'Mu;
    with a cross term M the CARE is solved for A - B R^-1 M' and
    Q - M R^-1 M'."""
    mats = (A, B, Q, R) if M is None else (A, B, Q, R, M)
    lanes, single = _lanes(*mats)
    A, B, Q, R = lanes[:4]
    R_inv = torch.linalg.inv(R)
    if M is None:
        M = torch.zeros(B.shape, dtype=A.dtype, device=A.device)
    else:
        M = lanes[4]
    A_t = A - B @ R_inv @ _t(M)
    Q_t = Q - M @ R_inv @ _t(M)
    P = _care(A_t, B, Q_t, R, num_newton, None, False)
    K = R_inv @ (_t(B) @ P + _t(M))
    return _out(K, single), _out(P, single)
