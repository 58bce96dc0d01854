"""KKT residual certification and mixed-precision Newton-KKT refinement,
batch-first — the port of polympc_tpu/nlp/refine.py.

  * :func:`kkt_residual`: the unscaled KKT infinity norm (stationarity,
    feasibility, complementarity) per lane, in the dtype of ``z``;
  * :func:`refine_solution`: a few full-Newton steps per lane on the
    active-set KKT system, residuals and iterates in float64, from an fp32
    solve.  The linear solve may run in float32 (``solve_dtype``): then each
    step factors the max-row-equilibrated Newton matrix by the unpivoted
    LDL^T (ops/ldlt.py: the CUDA kernel for CUDA tensors, its plain version
    on the CPU) and runs two iterative-refinement sweeps against it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from polympc_torch.nlp.sqp import (constraints_fn, derivative_fns,
                                   exact_hessian_fn)
from polympc_torch.nlp.types import NLP, NLPBounds
from polympc_torch.ops.ldlt import ldlt_factor_solve, ldlt_solve
from polympc_torch.utils.precision import full_precision
from polympc_torch.utils.timing import span

__all__ = ["kkt_residual", "refine_solution", "newton_system",
           "KKTResidual"]

f64 = torch.float64


class KKTResidual(NamedTuple):
    stationarity: torch.Tensor     # (B,) ||grad_f + J' lam + lam_box||_inf
    feasibility: torch.Tensor      # (B,) max constraint/bound violation
    complementarity: torch.Tensor  # (B,) max |dual * distance-to-bound|
    max: torch.Tensor              # (B,) overall KKT error


def _amax0(v):
    """Per-lane max over the last axis with initial value 0."""
    if v.shape[-1] == 0:
        return v.new_zeros(v.shape[:-1])
    return torch.clamp(torch.amax(v, dim=-1), min=0.0)


def _mv(A, v):
    return (A @ v[..., None])[..., 0]


def _eval_parts(nlp: NLP, z, p):
    grad_fn, jac_fn = derivative_fns(nlp, p)
    return grad_fn(z), constraints_fn(nlp, p)(z), jac_fn(z)


def _row_bounds(nlp: NLP, bounds: NLPBounds, B, dt):
    z = torch.zeros((B, nlp.ne), dtype=dt, device=bounds.gl.device)
    cl = torch.cat([z, bounds.gl.to(dt).expand(B, nlp.ni)], dim=1)
    cu = torch.cat([z, bounds.gu.to(dt).expand(B, nlp.ni)], dim=1)
    return cl, cu


def _kkt_from_parts(g, c, J, z, lam, lam_box, cl, cu, lbx, ubx
                    ) -> KKTResidual:
    """KKT error from pre-evaluated derivative parts (g, c, J)."""
    stat = _amax0(torch.abs(g + _mv(J.transpose(1, 2), lam) + lam_box))
    feas_c = _amax0(torch.maximum(torch.clamp(c - cu, min=0.0),
                                  torch.clamp(cl - c, min=0.0)))
    feas_x = _amax0(torch.maximum(torch.clamp(z - ubx, min=0.0),
                                  torch.clamp(lbx - z, min=0.0)))
    feas = torch.maximum(feas_c, feas_x)

    def comp_term(v, lo, up, y):
        inf = torch.full_like(v, float("inf"))
        d_lo = torch.where(torch.isfinite(lo), v - lo, inf)
        d_up = torch.where(torch.isfinite(up), up - v, inf)
        d = torch.minimum(torch.abs(d_lo), torch.abs(d_up))
        d = torch.where(torch.isfinite(d), d, torch.zeros_like(d))
        return _amax0(torch.abs(y) * d)

    comp = torch.maximum(comp_term(c, cl, cu, lam),
                         comp_term(z, lbx, ubx, lam_box))
    return KKTResidual(stationarity=stat, feasibility=feas,
                       complementarity=comp,
                       max=torch.maximum(stat, torch.maximum(feas, comp)))


def _lane_bounds(nlp, bounds, B, dt):
    lbx = bounds.lbx.to(dt).expand(B, nlp.n)
    ubx = bounds.ubx.to(dt).expand(B, nlp.n)
    return (*_row_bounds(nlp, bounds, B, dt), lbx, ubx)


@full_precision()
def kkt_residual(nlp: NLP, z, lam, lam_box, bounds: NLPBounds, p=None
                 ) -> KKTResidual:
    """Unscaled KKT error of each lane's (z, lam, lam_box) in the dtype of
    ``z``.  Stationarity is grad_f + J'lam + lam_box; rows live in
    [cl, cu]; lam_box is the net box dual."""
    dt = z.dtype
    cl, cu, lbx, ubx = _lane_bounds(nlp, bounds, z.shape[0], dt)
    g, c, J = _eval_parts(nlp, z, p)
    return _kkt_from_parts(g, c, J, z, lam.to(dt), lam_box.to(dt), cl, cu,
                           lbx, ubx)


# The largest K whose float32 Newton-KKT solve takes the unpivoted LDL^T:
# the JAX package's rule (its ``_newton_kkt_solve`` takes the LDL^T kernel
# where ``pallas_fits(K)``, polympc_tpu/ops/ldlt.py:67, holds: K <= 206)
# rather than all the kernels hold (``LDLT_MAX_K`` = 337).  Which lanes
# the certify certifies depends on the route: on the horizon sweep's S=4
# Newton matrices (K=252) the unpivoted factor with two IR sweeps leaves
# residuals near 1e-7 where the pivoted LU reaches 1e-11 (PERF.md §6,
# the horizon sweep).
REFINE_LDLT_MAX_K = 206


def _newton_kkt_solve(M, r, ir: int = 2):
    """Batched symmetric Newton-KKT solve.  float32 up to K =
    ``REFINE_LDLT_MAX_K``: unpivoted LDL^T factor + ``ir``
    iterative-refinement sweeps against the same matrix (residual at full
    float32); float64, or a larger K (the JAX package's ``pallas_fits``
    rule, decided by the shape): ``torch.linalg.solve``."""
    if M.dtype != torch.float32 or M.shape[-1] > REFINE_LDLT_MAX_K:
        return torch.linalg.solve(M, r)
    x, F, d = ldlt_factor_solve(M, r)
    for _ in range(ir):
        x = x + ldlt_solve(F, d, r - _mv(M, x))
    return x


def _cast_params(p, dt):
    if p is None:
        return None
    return {k: v.to(dt) if torch.is_floating_point(v) else v
            for k, v in p.items()}


def _active_set(z, c, cl, cu, lbx, ubx, act_tol):
    """Active rows/bounds at (z, c) as float64 masks, with the bound each
    active entry sits on: (ac, b_c, ax, b_x)."""
    act_lo_c = (c - cl) <= act_tol
    act_up_c = (cu - c) <= act_tol
    b_c = torch.where(act_lo_c, cl, cu)
    b_c = torch.where(torch.isfinite(b_c), b_c, torch.zeros_like(b_c))
    act_lo_x = (z - lbx) <= act_tol
    act_up_x = (ubx - z) <= act_tol
    b_x = torch.where(act_lo_x, lbx, ubx)
    b_x = torch.where(torch.isfinite(b_x), b_x, torch.zeros_like(b_x))
    return ((act_lo_c | act_up_c).to(f64), b_c,
            (act_lo_x | act_up_x).to(f64), b_x)


def _newton_system(W, g, c, J, z, lam, act, delta: float = 1e-6):
    """The active-set Newton-KKT system of one refinement step, symmetric
    max-row equilibrated: returns (Ms, rs, dscale) with the step
    ``dscale * solve(Ms, rs)``.  ``delta`` regularises the matrix only
    (it keeps the fp32 LDL^T pivots away from zero), not the residual."""
    ac, b_c, ax, b_x = act
    n = z.shape[1]
    free = 1.0 - ax
    t = ax * (b_x - z)
    Wd_t = _mv(W, t) + delta * t
    rz = free * (g + _mv(J.transpose(1, 2), ac * lam) + Wd_t) - ax * t
    In = torch.eye(n, dtype=f64, device=z.device)
    Wm = free[:, :, None] * (W + delta * In) * free[:, None, :] \
        + torch.diag_embed(ax)
    if c.shape[1]:
        rc = ac * ((c - b_c) + _mv(J, t))
        Jm = (ac[:, :, None] * J) * free[:, None, :]
        Dc = delta * ac + (1.0 - ac)
        M = torch.cat([torch.cat([Wm, Jm.transpose(1, 2)], dim=2),
                       torch.cat([Jm, torch.diag_embed(-Dc)], dim=2)], dim=1)
        r = torch.cat([rz, rc], dim=1)
    else:
        M, r = Wm, rz
    # symmetric Jacobi (max-row) equilibration before the low-precision
    # solve; exact in fp64: applied and undone outside the factorisation
    dscale = 1.0 / torch.sqrt(torch.clamp(
        torch.amax(torch.abs(M), dim=2), min=1e-10))
    Ms = (dscale[:, :, None] * M) * dscale[:, None, :]
    return Ms, dscale * (-r), dscale


def _hessian_fn(nlp: NLP, p_md, md):
    """The Lagrangian Hessian evaluated in ``md`` and returned in float64
    (``nlp.sqp.exact_hessian_fn``: the NLP's own ``lag_hessian``, else the
    JAX package's whole-vector fallback)."""
    hess = exact_hessian_fn(nlp, p_md)
    return lambda zz, ll: hess(zz.to(md), ll.to(md)).to(f64)


@full_precision()
def newton_system(nlp: NLP, z, lam, bounds: NLPBounds, p=None,
                  act_tol: float = 1e-3, matrix_dtype=None):
    """The equilibrated Newton-KKT system (Ms, rs) in float64 that the
    first step of :func:`refine_solution` factors at (z, lam): the matrices
    the certify pass hands to the LDL^T kernels."""
    md = f64 if matrix_dtype is None else matrix_dtype
    z, lam = z.to(f64), lam.to(f64)
    p64 = _cast_params(p, f64)
    cl, cu, lbx, ubx = _lane_bounds(nlp, bounds, z.shape[0], f64)
    g, c, J = _eval_parts(nlp, z, p64)
    W = _hessian_fn(nlp, _cast_params(p, md), md)(z, lam)
    act = _active_set(z, c, cl, cu, lbx, ubx, act_tol)
    Ms, rs, _ = _newton_system(W, g, c, J, z, lam, act)
    return Ms, rs


@full_precision()
def refine_solution(nlp: NLP, z, lam, lam_box, bounds: NLPBounds, p=None,
                    iters: int = 2, act_tol: float = 1e-3,
                    solve_dtype=None, matrix_dtype=None,
                    return_residual: bool = False,
                    kkt_solver: str = "ldlt", solve_ir: int = 2,
                    return_last: bool = False):
    """Newton-KKT refinement in float64 of a batch of solutions.

    ``solve_dtype`` sets the precision of the inner linear solve only;
    residuals, Jacobians and iterates live in float64.  ``matrix_dtype``
    sets the precision of the Lagrangian Hessian evaluation (the W block,
    which only preconditions the step).  ``kkt_solver``: "ldlt" (the LDL^T
    path for float32 solves) or "lu" (``torch.linalg.solve``).

    ``solve_ir`` is accepted and not applied: the float32 solve always runs
    two refinement sweeps, as the JAX package's does (its ``solve_ir`` never
    reaches ``_newton_kkt_solve``).

    Each step detects the active set at the current iterate, eliminates the
    box-dual block and the inactive multipliers, and solves

        [ Wm   Jm' ] [dz  ]   [ (1-ax)*(g + J'(ac*lam) + (W+dI)t) - ax*t ]
        [ Jm  -Dc  ] [dlam] = [ ac*((c - b_c) + J(ax*t))                 ]
          (RHS negated)

    then assigns the active box duals from fp64 stationarity at the new
    point.  The iterate always advances; the returned point is the best
    iterate by fp64 KKT residual.  Returns (z, lam, lam_box)
    [+ (residual,) if return_residual] [+ last (z, lam, lam_box) if
    return_last], each with a leading lane axis.
    """
    if kkt_solver not in ("ldlt", "lu"):
        raise ValueError("kkt_solver must be 'ldlt' or 'lu'")
    del solve_ir
    with span("refine.solve", B=z.shape[0], iters=iters):
        return _refine(nlp, z, lam, lam_box, bounds, p, iters, act_tol,
                       solve_dtype, matrix_dtype, return_residual,
                       kkt_solver, return_last)


def _refine(nlp: NLP, z, lam, lam_box, bounds: NLPBounds, p, iters,
            act_tol, solve_dtype, matrix_dtype, return_residual, kkt_solver,
            return_last):
    sd = f64 if solve_dtype is None else solve_dtype
    md = f64 if matrix_dtype is None else matrix_dtype
    z, lam, lam_box = z.to(f64), lam.to(f64), lam_box.to(f64)
    B = z.shape[0]
    n, m = nlp.n, nlp.m
    p64 = _cast_params(p, f64)
    p_md = p64 if md == f64 else _cast_params(p, md)
    cl, cu, lbx, ubx = _lane_bounds(nlp, bounds, B, f64)
    grad_fn, jac_fn = derivative_fns(nlp, p64)
    con_fn = constraints_fn(nlp, p64)
    hess = _hessian_fn(nlp, p_md, md)

    def residual_of(z, lam, lam_box, g, c, J):
        return _kkt_from_parts(g, c, J, z, lam, lam_box, cl, cu, lbx,
                               ubx).max

    def derivatives(z):
        with span("refine.derivatives"):
            return grad_fn(z), con_fn(z), jac_fn(z)

    cur = (z, lam, lam_box, *derivatives(z))
    best = (z, lam, lam_box)
    best_r = residual_of(*cur)
    for _ in range(iters):
        with span("refine.step"):
            z, lam, lam_box, g, c, J = cur
            act = _active_set(z, c, cl, cu, lbx, ubx, act_tol)
            ac, ax = act[0], act[2]
            with span("refine.derivatives"):
                W = hess(z, lam)
            Ms, rs, dscale = _newton_system(W, g, c, J, z, lam, act)
            with span("refine.kkt_solve"):
                if kkt_solver == "ldlt":
                    sol = _newton_kkt_solve(Ms.to(sd), rs.to(sd))
                else:
                    sol = torch.linalg.solve(Ms.to(sd), rs.to(sd))
            sol = dscale * sol.to(f64)
            ok = torch.isfinite(sol).all(1)[:, None]
            dz = torch.where(ok, sol[:, :n], torch.zeros_like(z))
            z2 = torch.clamp(z + dz, min=lbx, max=ubx)
            lam2 = torch.where(ok, ac * (lam + sol[:, n:]), lam) if m \
                else lam
            g2, c2, J2 = derivatives(z2)
            lam_box2 = torch.where(
                ok, -ax * (g2 + _mv(J2.transpose(1, 2), lam2)), lam_box)
            cur = (z2, lam2, lam_box2, g2, c2, J2)
            r_new = residual_of(*cur)
            improved = (r_new <= best_r)[:, None]
            best = tuple(torch.where(improved, a, b)
                         for a, b in zip((z2, lam2, lam_box2), best))
            best_r = torch.minimum(r_new, best_r)
    out = best
    if return_residual:
        out = out + (best_r,)
    if return_last:
        out = out + cur[:3]
    return out
