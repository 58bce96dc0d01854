"""Trust-region Newton and projected-gradient solvers, batch-first — the
port of polympc_tpu/nlp/tr.py.

Equivalents of the reference's experimental solvers in
``src/solvers/trust_region_tests/`` (trust_region_test.cpp:131-216:
Nocedal Alg. 6.2 with the Alg. 4.3 Levenberg lambda iteration for the
subproblem; gradproj_test.cpp:37-88: projected gradient with Armijo
backtracking on a box), for small unconstrained or box-constrained smooth
problems where the SQP stack is overkill.

``f(x)`` (or ``f(x, p)``) is written for one point x (n,), as in the JAX
package; the solvers take one start point (n,) or a batch (B, n), take
derivatives per lane with ``torch.func`` and run every lane until its own
stop, freezing finished lanes (results come back with the start point's
shape).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.func import grad, jacrev, vmap

from polympc_torch.utils import status as st
from polympc_torch.utils.precision import full_precision

__all__ = ["trust_region_solve", "projected_gradient_solve", "TRSolution"]


class TRSolution(NamedTuple):
    x: torch.Tensor
    cost: torch.Tensor
    grad_norm: torch.Tensor
    status: torch.Tensor       # utils.status: SOLVED / MAX_ITER_EXCEEDED
    iters: torch.Tensor


def _funcs(f, p):
    """(per-lane value, batched value, batched gradient) of f."""
    fx = (lambda x: f(x, p)) if p is not None else f
    return fx, vmap(fx), vmap(grad(fx))


def _unbatch(sol: TRSolution, single: bool) -> TRSolution:
    return TRSolution(*(t[0] for t in sol)) if single else sol


@full_precision()
def trust_region_solve(f: Callable, x0, p=None, max_iter: int = 100,
                       eps: float = 1e-6, radius0: float = 0.1,
                       radius_max: float = 1e3, eta: float = 0.0,
                       lambda_iters: int = 3) -> TRSolution:
    """Trust-region Newton for min_x f(x, p) (Nocedal Alg. 6.2).

    The subproblem min_p g'p + p'Bp/2, ||p|| <= radius is solved by
    ``lambda_iters`` Levenberg iterations (Alg. 4.3,
    trust_region_test.cpp:140-161) of
    lambda += (p'p / q'q) (||p|| - radius) / radius on (B + lambda I) p = -g
    with Cholesky solves; an indefinite shift (a failed factor) doubles
    lambda, the reference's ``cholesky.info() != Success`` branch.  rho =
    ared/pred > eta accepts; the radius halves when rho < 0.1 and doubles
    (capped) when rho > 0.75 and the step reached 0.8 of it
    (trust_region_test.cpp:183-199).  Stops when ||grad||_inf < eps."""
    single = x0.ndim == 1
    x = (x0[None] if single else x0).clone()
    B, n = x.shape
    dt, dev = x.dtype, x.device
    fx, f_b, grad_b = _funcs(f, p)
    hess_b = vmap(jacrev(grad(fx)))
    In = torch.eye(n, dtype=dt, device=dev)

    def chol_solve(Bm, lam, g):
        """Factor Bm + lam I per lane; returns (ok, p, q = L^-1 p), ok
        False where the shift is not positive definite."""
        L, info = torch.linalg.cholesky_ex(Bm + lam[:, None, None] * In)
        ok = info == 0
        L = torch.where(ok[:, None, None], L, In)
        pv = torch.cholesky_solve(-g[..., None], L)
        q = torch.linalg.solve_triangular(L, pv, upper=False)
        return ok, pv[..., 0], q[..., 0]

    def subproblem(Bm, g, radius):
        lam = torch.full_like(radius, 0.1)
        for _ in range(lambda_iters):
            ok, pv, qv = chol_solve(Bm, lam, g)
            pn = torch.linalg.vector_norm(pv, dim=1)
            lam_new = lam + (pv * pv).sum(1) / torch.clamp(
                (qv * qv).sum(1), min=1e-30) * (pn - radius) / radius
            lam = torch.where(ok, torch.clamp(lam_new, min=0.0), 2.0 * lam)
        ok, pv, _ = chol_solve(Bm, lam, g)
        gn = torch.clamp(torch.linalg.vector_norm(g, dim=1), min=1e-30)
        steep = -g * torch.clamp(radius / gn, max=1.0)[:, None]
        return torch.where(ok[:, None], pv, steep)

    radius = torch.full((B,), float(radius0), dtype=dt, device=dev)
    it = torch.zeros(B, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    while True:
        run = ~done & (it < max_iter)
        if not bool(run.any()):
            break
        g = grad_b(x)
        Bm = hess_b(x)
        cost = f_b(x)
        pv = subproblem(Bm, g, radius)
        pred = -((g * pv).sum(1) + 0.5 * (pv * (Bm @ pv[..., None])[..., 0]
                                          ).sum(1))
        cost_step = f_b(x + pv)
        ared = cost - cost_step
        rho = ared / torch.where(pred.abs() > 1e-30, pred,
                                 torch.full_like(pred, 1e-30))
        accept = (rho > eta) & torch.isfinite(cost_step)
        x2 = torch.where(accept[:, None], x + pv, x)
        pn = torch.linalg.vector_norm(pv, dim=1)
        radius2 = torch.where(
            rho < 0.1, 0.5 * radius,
            torch.where((rho > 0.75) & (pn >= 0.8 * radius),
                        torch.clamp(2.0 * radius, max=radius_max), radius))
        conv = torch.amax(grad_b(x2).abs(), dim=1) < eps
        # finished lanes keep their state (the JAX package's while_loop
        # under vmap)
        x = torch.where(run[:, None], x2, x)
        radius = torch.where(run, radius2, radius)
        done = torch.where(run, conv, done)
        it = it + run.to(torch.int32)
    g = grad_b(x)
    sol = TRSolution(
        x=x, cost=f_b(x), grad_norm=torch.amax(g.abs(), dim=1),
        status=torch.where(done, st.SOLVED, st.MAX_ITER_EXCEEDED).to(
            torch.int32), iters=it)
    return _unbatch(sol, single)


@full_precision()
def projected_gradient_solve(f: Callable, x0, lb, ub, p=None,
                             max_iter: int = 100, eps: float = 1e-6,
                             alpha0: float = 0.9, beta: float = 0.3,
                             c: float = 1e-5, ls_trials: int = 20
                             ) -> TRSolution:
    """Projected gradient for min f(x, p) s.t. lb <= x <= ub
    (gradproj_test.cpp:37-88).

    Each iteration projects the step x - alpha g onto the box for the
    fixed ladder alpha = alpha0 beta^k, k < ``ls_trials`` (all trials of
    all lanes in one batch), and takes the first trial that passes the
    Armijo test; termination on the projected-gradient residual
    ||x - proj(x - g)||_inf <= eps.

    The Armijo test is the reference's as the JAX package writes it,
    f(x_step) <= f(x) - alpha c g'(x_step - x) (gradproj_test.cpp:68):
    g'(x_step - x) is negative for a descent step, so the test asks the
    trial to be *worse* than f(x) by at most alpha c |g'd|, the opposite
    sign of the textbook sufficient-decrease test.  The port keeps it to
    stay equal to the JAX package (flagged in ROADMAP.md queue 3)."""
    single = x0.ndim == 1
    x = (x0[None] if single else x0)
    B, n = x.shape
    dt, dev = x.dtype, x.device
    _, f_b, grad_b = _funcs(f, p)
    lb = torch.as_tensor(lb, dtype=dt, device=dev)
    ub = torch.as_tensor(ub, dtype=dt, device=dev)
    proj = lambda v: torch.clamp(v, min=lb, max=ub)
    L = ls_trials
    alphas = alpha0 * torch.as_tensor(beta, dtype=dt, device=dev) ** \
        torch.arange(L, device=dev)

    x = proj(x.clone())
    it = torch.zeros(B, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    while True:
        run = ~done & (it < max_iter)
        if not bool(run.any()):
            break
        val = f_b(x)
        g = grad_b(x)
        xs = proj(x[:, None, :] - alphas[None, :, None] * g[:, None, :])
        fs = f_b(xs.reshape(B * L, n)).reshape(B, L)
        # the reference's sign (see the docstring)
        gd = (g[:, None, :] * (xs - x[:, None, :])).sum(2)
        ok = (fs <= val[:, None] - alphas[None] * c * gd) & torch.isfinite(fs)
        sel = torch.argmax(ok.to(torch.int32), dim=1)
        pick = xs[torch.arange(B, device=dev), sel]
        x2 = torch.where(ok.any(1)[:, None], pick, x)
        resid = torch.amax((x2 - proj(x2 - grad_b(x2))).abs(), dim=1)
        x = torch.where(run[:, None], x2, x)
        done = torch.where(run, resid <= eps, done)
        it = it + run.to(torch.int32)
    g = grad_b(x)
    sol = TRSolution(
        x=x, cost=f_b(x), grad_norm=torch.amax((x - proj(x - g)).abs(), dim=1),
        status=torch.where(done, st.SOLVED, st.MAX_ITER_EXCEEDED).to(
            torch.int32), iters=it)
    return _unbatch(sol, single)
