"""SQP solver with l1-merit or filter line search, batch-first — the port
of ``sqp_solve`` in polympc_tpu/nlp/sqp.py.

Every lane solves its own NLP from its own start point.  One iteration:
the Lagrangian Hessian (exact, Gauss-Newton, or a quasi-Newton matrix
carried per lane: dense damped BFGS, SR1, or the collocation NLP's
block-BFGS), regularised (nlp/hessian.py); the QP subproblem in the step
with bounds shifted by the iterate, solved by boxADMM dual-warm-started
with the current multipliers; a fixed ladder of ``ls_max_iter`` trial step
lengths tau^i evaluated for every lane at once, of which the first that
meets the l1-merit Armijo test or the Fletcher-Leyffer filter is taken
(with the JAX package's two-tier fallback); then one first-order
evaluation at the new point serves the quasi-Newton secant, the
termination test and the next linearisation.

A lane stops once its termination test passes or after ``max_iter``
iterations; the lanes still running are gathered into a smaller batch for
the next iteration, so each lane stops at the iteration it would stop at
alone (the JAX package freezes finished lanes under ``vmap`` instead).
Per-lane state (quasi-Newton matrix, filter, trace) is gathered with the
lanes.
"""
from __future__ import annotations

import torch
from torch.func import grad, jacrev, vmap

from polympc_torch.nlp import graphed
from polympc_torch.nlp.hessian import (
    BlockHessian, assemble_block_hessian, bfgs_update, block_bfgs_update,
    block_hessian_identity, regularize, sr1_update,
)
from polympc_torch.nlp.types import (
    NLP, NLPBounds, SQPSettings, SQPSolution, unbounded,
)
from polympc_torch.qp.box_admm import _nonzero, box_admm_solve
from polympc_torch.qp.box_admm import first_epoch as _qp_first_epoch
from polympc_torch.qp.types import QPData
from polympc_torch.utils import status as st
from polympc_torch.utils.precision import full_precision
from polympc_torch.utils.timing import span

__all__ = ["sqp_solve", "first_epoch"]


def _inf_norm(v):
    if v.shape[-1] == 0:
        return v.new_zeros(v.shape[:-1])
    return torch.amax(torch.abs(v), dim=-1)


def _mv(A, v):
    return (A @ v[..., None])[..., 0]


def _constraints(nlp: NLP, x, p):
    """Stacked general constraints c(x) = [c_e; c_i], (B, ne+ni)."""
    parts = []
    if nlp.eq is not None:
        parts.append(nlp.eq(x, p))
    if nlp.ineq is not None:
        parts.append(nlp.ineq(x, p))
    return torch.cat(parts, dim=-1) if parts else x.new_zeros(
        (x.shape[0], 0))


def _lane(fn):
    """A batch-first callable (B, n) -> (B, ...) as a one-lane function."""
    return lambda xi, *a: fn(xi[None], *(v[None] for v in a))[0]


def _grad(nlp: NLP, x, p):
    if nlp.cost_grad is not None:
        return nlp.cost_grad(x, p)
    return vmap(grad(_lane(lambda v: nlp.cost(v, p))))(x)


def _jac(nlp: NLP, x, p):
    parts = []
    if nlp.eq is not None:
        parts.append(nlp.eq_jac(x, p) if nlp.eq_jac is not None else
                     vmap(jacrev(_lane(lambda v: nlp.eq(v, p))))(x))
    if nlp.ineq is not None:
        parts.append(nlp.ineq_jac(x, p) if nlp.ineq_jac is not None else
                     vmap(jacrev(_lane(lambda v: nlp.ineq(v, p))))(x))
    return torch.cat(parts, dim=1) if parts else x.new_zeros(
        (x.shape[0], 0, nlp.n))


def _lag_hessian(nlp: NLP, x, lam, p):
    if nlp.lag_hessian is not None:
        return nlp.lag_hessian(x, lam, p)

    def lagr(xi, li):
        val = nlp.cost(xi[None], p)[0]
        if nlp.m:
            val = val + _constraints(nlp, xi[None], p)[0] @ li
        return val
    return vmap(jacrev(grad(lagr)))(x, lam)


def derivative_fns(nlp: NLP, p):
    """(grad, jac) callables on (B, n): the NLP's structured hooks where it
    has them, per-lane ``torch.func`` otherwise; on a card replayed as
    CUDA graphs (nlp/graphed.py)."""
    return (lambda x: graphed.call(_grad, nlp, x, p),
            lambda x: graphed.call(_jac, nlp, x, p))


def constraints_fn(nlp: NLP, p):
    """The stacked constraints c(x) (B, m) as :func:`derivative_fns`
    evaluates them: on a card replayed as CUDA graphs."""
    return lambda x: graphed.call(_constraints, nlp, x, p)


def exact_hessian_fn(nlp: NLP, p):
    """The exact Lagrangian Hessian (x (B, n), lam (B, m)) -> (B, n, n):
    the NLP's hook where it has one, per-lane ``torch.func`` otherwise; on
    a card replayed as CUDA graphs (nlp/graphed.py)."""
    return lambda x, lam: graphed.call(_lag_hessian, nlp, x, lam, p)


def _box_bounds(nlp: NLP, bounds: NLPBounds | None, B, n, dt, dev):
    """(lbx, ubx, cl, cu) per lane, infinite where ``bounds`` is None."""
    if bounds is None:
        bounds = unbounded(nlp, dt, dev)
    return (bounds.lbx.to(dt).expand(B, n), bounds.ubx.to(dt).expand(B, n),
            *_row_bounds(nlp, bounds, B, dt))


def _subproblem(H, g, A, c, cl, cu, lbx, ubx, x, settings: SQPSettings):
    """The QP in the step: regularised Hessian, bounds shifted by x."""
    with span("sqp.regularize"):
        H = regularize(H, settings.reg, settings.reg_eps)
    return QPData(H=H, h=g, A=A, al=cl - c, au=cu - c, xl=lbx - x,
                  xu=ubx - x)


@full_precision()
def first_epoch(nlp: NLP, x0, p=None, bounds: NLPBounds | None = None,
                lam0=None, lam_box0=None,
                settings: SQPSettings = SQPSettings()):
    """The inputs of the first boxADMM epoch that :func:`sqp_solve` runs
    from the same arguments (exact or Gauss-Newton Hessian): its first
    QP, built as the solve builds it, handed to
    ``qp.box_admm.first_epoch`` with the multipliers as dual warm start.
    Returns the 13 arguments of ``ops.admm_epoch``.  The kernels' checks
    take the SQP paths' first epochs from here."""
    B, n = x0.shape
    dt, dev = x0.dtype, x0.device
    lbx, ubx, cl, cu = _box_bounds(nlp, bounds, B, n, dt, dev)
    if settings.hessian == "exact":
        hess_fn = exact_hessian_fn(nlp, p)
    elif settings.hessian == "gauss_newton":
        hess_fn = lambda x, lam: nlp.gn_hessian(x, p)
    else:
        raise ValueError(f"first_epoch: hessian={settings.hessian!r} "
                         "carries its matrix in the solve's state")
    x = torch.clamp(x0.to(dt), min=lbx, max=ubx)
    lam = torch.zeros((B, nlp.m), dtype=dt, device=dev) if lam0 is None \
        else lam0.to(dt)
    grad_fn, jac_fn = derivative_fns(nlp, p)
    qp = _subproblem(hess_fn(x, lam), grad_fn(x), jac_fn(x),
                     _constraints(nlp, x, p), cl, cu, lbx, ubx, x, settings)
    return _qp_first_epoch(qp, y0=lam, y_box0=lam_box0, settings=settings.qp)


def _row_bounds(nlp: NLP, bounds: NLPBounds, B, dt):
    z = torch.zeros((B, nlp.ne), dtype=dt, device=bounds.gl.device)
    cl = torch.cat([z, bounds.gl.to(dt).expand(B, nlp.ni)], dim=1)
    cu = torch.cat([z, bounds.gu.to(dt).expand(B, nlp.ni)], dim=1)
    return cl, cu


def _violation_l1(c, cl, cu, x, lbx, ubx):
    """l1 constraint violation for the merit function
    (ref: sqp_base.hpp:423-474), summed over the last axis."""
    vc = torch.sum(torch.clamp(c - cu, min=0.0) + torch.clamp(cl - c, min=0.0),
                   dim=-1)
    vx = torch.sum(torch.clamp(x - ubx, min=0.0)
                   + torch.clamp(lbx - x, min=0.0), dim=-1)
    return vc + vx


def _violation_inf(c, cl, cu, x, lbx, ubx):
    vc = _inf_norm(torch.clamp(torch.maximum(c - cu, cl - c), min=0.0))
    vx = _inf_norm(torch.clamp(torch.maximum(x - ubx, lbx - x), min=0.0))
    return torch.maximum(vc, vx)


_QN_KEYS = tuple("H" + f for f in BlockHessian._fields)


@full_precision()
def sqp_solve(nlp: NLP, x0, p=None, bounds: NLPBounds | None = None,
              lam0=None, lam_box0=None,
              settings: SQPSettings = SQPSettings()) -> SQPSolution:
    """Solve a batch of NLPs from start points x0 (B, n).

    p: parameter dict forwarded to every problem callable (shared by all
    lanes).  bounds: each tensor (n,)/(ni,) shared, or (B, n)/(B, ni) per
    lane.  lam0 (B, m), lam_box0 (B, n): optional dual warm starts.
    """
    with span("sqp.solve", B=x0.shape[0], n=x0.shape[1], m=nlp.m):
        return _sqp_solve(nlp, x0, p, bounds, lam0, lam_box0, settings)


def _sqp_solve(nlp: NLP, x0, p, bounds, lam0, lam_box0,
               settings: SQPSettings) -> SQPSolution:
    if not settings.validate():
        raise ValueError("invalid SQP settings")
    B, n = x0.shape
    m = nlp.m
    dt, dev = x0.dtype, x0.device
    lbx, ubx, cl, cu = _box_bounds(nlp, bounds, B, n, dt, dev)

    cost_fn = lambda x: nlp.cost(x, p)
    con_fn = lambda x: _constraints(nlp, x, p)
    grad_fn, jac_fn = derivative_fns(nlp, p)
    con_at = constraints_fn(nlp, p)
    mode = settings.hessian
    if mode == "gauss_newton":
        if nlp.gn_hessian is None:
            raise ValueError("hessian='gauss_newton' requires nlp.gn_hessian")
        hess_fn = lambda x, lam: nlp.gn_hessian(x, p)
    elif mode != "exact":
        hess_fn = None  # the quasi-Newton modes carry their matrix per lane
    else:
        hess_fn = exact_hessian_fn(nlp, p)
    if mode == "block_bfgs":
        if nlp.block_structure is None:
            raise ValueError(
                "hessian='block_bfgs' requires nlp.block_structure "
                "(set by ocp.transcribe)")
        bs_N, bs_nx, bs_nu, bs_np = nlp.block_structure
    filt = settings.line_search == "filter"
    T = settings.trace_iters

    L = settings.ls_max_iter
    alphas = settings.tau ** torch.arange(L, dtype=dt, device=dev)

    def hessian(s, x, lam):
        if mode == "block_bfgs":
            return assemble_block_hessian(
                BlockHessian(*(s[k] for k in _QN_KEYS)), bs_N, bs_nx, bs_nu)
        if hess_fn is None:
            return s["Bq"]
        return hess_fn(x, lam)

    def body(s, cl, cu, lbx, ubx):
        x, lam, lam_box, g, c, A, f0 = (s[k] for k in (
            "x", "lam", "lam_box", "g", "c", "A", "f"))
        b = x.shape[0]
        with span("sqp.hessian"):
            H = hessian(s, x, lam)
        qp = _subproblem(H, g, A, c, cl, cu, lbx, ubx, x, settings)
        qs = box_admm_solve(qp, y0=lam, y_box0=lam_box, settings=settings.qp)
        p_ok = (torch.isfinite(qs.x).all(1) & torch.isfinite(qs.y).all(1)
                & torch.isfinite(qs.y_box).all(1))[:, None]
        pstep = torch.where(p_ok, qs.x, torch.zeros_like(qs.x))
        lam_qp = torch.where(p_ok, qs.y, lam)
        lam_box_qp = torch.where(p_ok, qs.y_box, lam_box)
        pstep = torch.clamp(pstep, min=lbx - x, max=ubx - x)

        with span("sqp.line_search"):
            # line search over the fixed trial ladder, every lane at once
            v0 = _violation_l1(c, cl, cu, x, lbx, ubx)
            dphi_f = torch.sum(g * pstep, dim=1)
            xt = (x[:, None, :] + alphas[None, :, None] * pstep[:, None, :]
                  ).reshape(b * L, n)
            trial_f = cost_fn(xt).reshape(b, L)
            trial_v = _violation_l1(con_fn(xt).reshape(b, L, m), cl[:, None],
                                    cu[:, None], xt.reshape(b, L, n),
                                    lbx[:, None], ubx[:, None])
            bad = torch.isnan(trial_f) | torch.isnan(trial_v)
            inf = torch.full_like(trial_f, float("inf"))
            trial_f = torch.where(bad, inf, trial_f)
            trial_v = torch.where(bad, inf, trial_v)

            if filt:
                # Fletcher-Leyffer filter acceptance (line_search.hpp:16-98): a
                # trial must improve cost or violation by the margins against
                # every filter entry and the current point
                gma, beta = settings.filter_gamma, settings.filter_beta
                ff, fv = s["filt_f"][:, None, :], s["filt_v"][:, None, :]
                ok_entries = ((trial_f[:, :, None] <= ff - gma * fv)
                              | (trial_v[:, :, None] <= beta * fv)).all(2)
                ok_current = ((trial_f <= (f0 - gma * v0)[:, None])
                              | (trial_v <= (beta * v0)[:, None]))
                ok = ok_entries & ok_current
                improve = (trial_f < f0[:, None]) | (trial_v < v0[:, None])
                score = trial_f + trial_v
            else:
                mu = torch.clamp(settings.merit_mu_safety + torch.maximum(
                    _inf_norm(lam_qp), _inf_norm(lam_box_qp)),
                    max=settings.merit_mu_max)
                phi0 = f0 + mu * v0
                dphi = dphi_f - mu * v0
                score = trial_f + mu[:, None] * trial_v
                ok = score <= (phi0[:, None] + settings.eta * alphas[None]
                               * dphi[:, None])
                improve = score < phi0[:, None]
            first = torch.argmax(ok.to(torch.int32), dim=1)
            finite = torch.isfinite(trial_f) & torch.isfinite(trial_v)
            improve = improve & finite
            best = torch.argmin(torch.where(improve, score, inf), dim=1)
            smallest = L - 1 - torch.argmax(
                torch.flip(finite, [1]).to(torch.int32), dim=1)
            any_fin = finite.any(1)
            fallback = torch.where(improve.any(1), best,
                                   torch.where(any_fin, smallest,
                                               torch.zeros_like(smallest)))
            sel = torch.where(ok.any(1), first, fallback)
            alpha = torch.where(any_fin, alphas[sel], torch.zeros_like(v0))
            f_sel = trial_f.gather(1, sel[:, None])[:, 0]

        new = {}
        if filt:
            # augment the filter with the departed point unless the step is
            # a sufficient-cost-decrease (f-type) step; a ring buffer of
            # filter_depth entries indexed by the lane's iteration
            f_type = (dphi_f < 0) & (f_sel <= f0 + settings.eta * alpha
                                     * dphi_f)
            slot = torch.arange(settings.filter_depth, device=dev)[None] == \
                torch.remainder(s["it"], settings.filter_depth)[:, None]
            put = slot & ~f_type[:, None]
            new["filt_f"] = torch.where(put, f0[:, None], s["filt_f"])
            new["filt_v"] = torch.where(put, v0[:, None], s["filt_v"])

        x2 = x + alpha[:, None] * pstep
        lam2 = lam + alpha[:, None] * (lam_qp - lam) if m else lam
        lam_box2 = lam_box + alpha[:, None] * (lam_box_qp - lam_box)
        with span("sqp.derivatives"):
            g2 = grad_fn(x2)
            c2 = con_at(x2)
            A2 = jac_fn(x2)
        f2 = torch.where(any_fin, f_sel, f0)
        At = A2.transpose(1, 2)

        if hess_fn is None:
            s_vec = x2 - x
            y_vec = (g2 + _mv(At, lam2)) - (g + _mv(A.transpose(1, 2), lam2)) \
                if m else g2 - g
            if mode == "block_bfgs":
                Hb = block_bfgs_update(
                    BlockHessian(*(s[k] for k in _QN_KEYS)), s_vec, y_vec,
                    bs_N, bs_nx, bs_nu)
                new.update(zip(_QN_KEYS, Hb))
            else:
                upd = bfgs_update if mode == "bfgs" else sr1_update
                new["Bq"] = upd(s["Bq"], s_vec, y_vec)

        ps = _inf_norm(alpha[:, None] * pstep)
        ds = _inf_norm(alpha[:, None] * (lam_qp - lam))
        vi = _violation_inf(c2, cl, cu, x2, lbx, ubx)
        stat = _inf_norm(g2 + _mv(At, lam2) + lam_box2)
        lam_scale = torch.clamp(torch.maximum(_inf_norm(lam2),
                                              _inf_norm(lam_box2)), min=1.0)
        conv = ((ps <= settings.eps_prim)
                & (ds <= settings.eps_dual * lam_scale)
                & (vi <= settings.eps_viol)
                & (stat <= settings.eps_stat * lam_scale))
        if T:
            # the per-iteration record [cost, violation, primal step, dual
            # step] at row it, for the first T iterations
            row = torch.stack([f2, vi, ps, ds], dim=1).to(dt)
            put = (torch.arange(T, device=dev)[None] == s["it"][:, None]
                   )[:, :, None]
            new["trace"] = torch.where(put, row[:, None, :], s["trace"])
        new.update({"x": x2, "lam": lam2, "lam_box": lam_box2,
                    "it": s["it"] + 1, "done": conv,
                    "qp_iters": s["qp_iters"] + qs.iters, "ps": ps,
                    "ds": ds, "vi": vi, "g": g2, "c": c2, "A": A2, "f": f2})
        return new

    x0 = torch.clamp(x0.to(dt), min=lbx, max=ubx)
    with span("sqp.derivatives"):
        derivs = {"g": grad_fn(x0), "c": con_at(x0), "A": jac_fn(x0),
                  "f": cost_fn(x0)}
    inf = torch.full((B,), float("inf"), dtype=dt, device=dev)
    S = {"x": x0,
         "lam": torch.zeros((B, m), dtype=dt, device=dev) if lam0 is None
         else lam0.to(dt),
         "lam_box": torch.zeros((B, n), dtype=dt, device=dev)
         if lam_box0 is None else lam_box0.to(dt),
         "it": torch.zeros(B, dtype=torch.int32, device=dev),
         "done": torch.zeros(B, dtype=torch.bool, device=dev),
         "qp_iters": torch.zeros(B, dtype=torch.int32, device=dev),
         "ps": inf, "ds": inf.clone(), "vi": inf.clone(), **derivs}
    if mode == "block_bfgs":
        S.update(zip(_QN_KEYS, block_hessian_identity(
            bs_N, bs_nx, bs_nu, bs_np, B, dt, dev)))
    elif hess_fn is None:
        S["Bq"] = torch.eye(n, dtype=dt, device=dev).expand(B, n, n).clone()
    if filt:
        # empty filter entries (f = +inf, v = 0) accept everything
        S["filt_f"] = torch.full((B, settings.filter_depth), float("inf"),
                                 dtype=dt, device=dev)
        S["filt_v"] = torch.zeros((B, settings.filter_depth), dtype=dt,
                                  device=dev)
    if T:
        S["trace"] = torch.full((B, T, 4), float("nan"), dtype=dt,
                                device=dev)
    while True:
        with span("sqp.iter") as it:
            with span("sqp.gather"):
                active = ~S["done"] & (S["it"] < settings.max_iter)
                idx, lanes = _nonzero(active)
                it.set(lanes=lanes)
                if lanes == 0:
                    break
                take = lambda t: t.index_select(0, idx)
                sub = ({k: take(v) for k, v in S.items()}, take(cl),
                       take(cu), take(lbx), take(ubx))
            new = body(*sub)
            for k, v in new.items():
                S[k] = S[k].index_copy(0, idx, v.to(S[k].dtype))

    status = torch.where(S["done"], st.SOLVED, st.MAX_ITER_EXCEEDED).to(
        torch.int32)
    return SQPSolution(x=S["x"], lam=S["lam"], lam_box=S["lam_box"],
                       status=status, iters=S["it"], qp_iters=S["qp_iters"],
                       cost=S["f"], primal_step=S["ps"], dual_step=S["ds"],
                       violation=S["vi"], trace=S.get("trace"))
