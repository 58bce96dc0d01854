"""Box-constrained OSQP-style ADMM QP solver, batch-first — the port of
``box_admm_solve`` in polympc_tpu/qp/box_admm.py.

The operator-splitting method of Stellato et al. (OSQP) with a separate
splitting for the box constraints, so the KKT system is (n+m) x (n+m):

  [ H + sigma*I + diag(rb)   A' ] [x~]   [ sigma*x + rb*q - yb - h ]
  [ A                -diag(1/rho)] [nu] = [ z - y/rho ]

Every lane solves its own QP.  The solve runs in epochs: the KKT is built
for the lane's current rho, ``check_every`` iterations run against one
factorisation, then residuals, infeasibility certificates and adaptive rho
are evaluated per lane.  A lane stops once it converged, diverged or was
certified infeasible, or after ``max_epochs``; lanes still running are
gathered into a smaller batch for the next epoch, so every lane stops at
the epoch it would stop at alone.

Epochs run through ``kkt_solver`` and the shapes, decided before any
launch in the JAX package's order (:func:`epoch_route`): "kernel" runs the
fused BBT epoch (ops/bbt_kernel.py) when a ``structure`` of this QP fits
that kernel, else the fused dense LDL^T epoch (ops/admm_epoch.py) when the
KKT fits that one — each the CUDA kernel for CUDA float32, its plain
version on the CPU — else the LU epoch, which "lu" and "inverse" always
run.  ``equil_iters > 0``
solves the Ruiz-equilibrated problem (warm start scaled in, termination and
rho on the scaled problem, solution scaled back); ``polish`` runs the
active-set polish (OSQP section 5.5) on the solution.
"""
from __future__ import annotations

import torch

from polympc_torch.ops.admm_epoch import admm_epoch_batched, epoch_kernel_fits
from polympc_torch.ops.bbt_kernel import (
    bbt_admm_epoch_batched, bbt_kernel_fits,
)
from polympc_torch.ops.structure import structure_is_consistent
from polympc_torch.qp.ruiz import ruiz_equilibrate, unscale_solution
from polympc_torch.qp.types import QPData, QPSolution, ADMMSettings
from polympc_torch.utils import status as st
from polympc_torch.utils.precision import full_precision
from polympc_torch.utils.timing import count, span

__all__ = ["box_admm_solve", "admm_solve", "classify_constraints",
           "rho_vector", "penalties", "epoch_route", "first_epoch"]


def _inf_norm(v):
    """Per-lane max |v| over the last axis (0 for an empty axis)."""
    if v.shape[-1] == 0:
        return v.new_zeros(v.shape[:-1])
    return torch.amax(torch.abs(v), dim=-1)


def _mv(A, v):
    return (A @ v[..., None])[..., 0]


def _nonzero(mask):
    """(indices of the true entries of a 1-D mask, their number).  The
    host reads the number, so it waits here for the work queued before:
    a blocking read, under the "sync" span and counter."""
    with span("sync"):
        count("sync")
        idx = torch.nonzero(mask).flatten()
        return idx, idx.numel()


def classify_constraints(al, au, settings: ADMMSettings):
    """Per-row constraint type: (is_eq, is_loose) boolean masks
    (ref: qp_base.hpp:195-222)."""
    is_loose = (al < -settings.loose_bound) & (au > settings.loose_bound)
    is_eq = (au - al) < settings.eq_tol
    return is_eq, is_loose & ~is_eq


def rho_vector(rho_base, al, au, settings: ADMMSettings):
    """Per-constraint penalty: equalities get rho*rho_eq_scale, loose rows
    rho_min (ref: box_admm.hpp:357-396).  rho_base (B,), al/au (B, m)."""
    is_eq, is_loose = classify_constraints(al, au, settings)
    rb = rho_base[:, None].expand_as(al)
    rho = torch.where(is_eq, rb * settings.rho_eq_scale, rb)
    rho = torch.where(is_loose, torch.full_like(rho, settings.rho_min), rho)
    return torch.clamp(rho, settings.rho_min, settings.rho_max)


def penalties(rho_base, qp: QPData, settings: ADMMSettings):
    """Per-lane penalty vectors for base penalties rho_base (B,): rho (B, m)
    for the general rows and rb (B, n) for the box rows (equality boxes get
    rho*rho_eq_scale, loose boxes rho_min)."""
    rho = rho_vector(rho_base, qp.al, qp.au, settings)
    box_eq, box_loose = classify_constraints(qp.xl, qp.xu, settings)
    rb = rho_base[:, None].expand_as(qp.xl)
    rb = torch.where(box_eq, rb * settings.rho_eq_scale, rb)
    rb = torch.where(box_loose, torch.full_like(rb, settings.rho_min), rb)
    return rho, torch.clamp(rb, settings.rho_min, settings.rho_max)


def _support(b, v):
    """Per-lane sum b*v with the convention 0*inf = 0."""
    return torch.sum(torch.where(v == 0.0, torch.zeros_like(v), b * v),
                     dim=-1)


def _infeasibility_certificates(qp: QPData, dx, dy, dyb, eps_inf):
    """OSQP section 3.4 primal/dual infeasibility tests on the per-epoch
    increments, per lane."""
    nrm_y = torch.maximum(_inf_norm(dy), _inf_norm(dyb))
    Atdy = _mv(qp.A.transpose(1, 2), dy) + dyb
    supp_p = (_support(qp.au, torch.clamp(dy, min=0.0))
              + _support(qp.al, torch.clamp(dy, max=0.0))
              + _support(qp.xu, torch.clamp(dyb, min=0.0))
              + _support(qp.xl, torch.clamp(dyb, max=0.0)))
    prim_inf = ((nrm_y > 0.0) & (_inf_norm(Atdy) <= eps_inf * nrm_y)
                & (supp_p <= -eps_inf * nrm_y))

    nrm_x = _inf_norm(dx)
    Adx = _mv(qp.A, dx)
    tol = (eps_inf * nrm_x)[:, None]

    def cone_ok(v, lo, up):
        up_ok = torch.where(torch.isfinite(up), v <= tol, True)
        lo_ok = torch.where(torch.isfinite(lo), v >= -tol, True)
        return torch.all(up_ok & lo_ok, dim=-1)

    dual_inf = ((nrm_x > 0.0) & (_inf_norm(_mv(qp.H, dx)) <= tol[:, 0])
                & (torch.sum(qp.h * dx, dim=-1) <= -tol[:, 0])
                & cone_ok(Adx, qp.al, qp.au) & cone_ok(dx, qp.xl, qp.xu))
    return prim_inf, dual_inf


def _build_kkt(qp: QPData, rho, rho_box, sigma):
    """(B, n+m, n+m) KKT matrices for the lanes' current penalties."""
    n = qp.H.shape[-1]
    m = qp.A.shape[-2]
    eye = torch.eye(n, dtype=qp.H.dtype, device=qp.H.device)
    K11 = qp.H + sigma * eye + torch.diag_embed(rho_box.to(qp.H.dtype))
    if m == 0:
        return K11
    top = torch.cat([K11, qp.A.transpose(1, 2)], dim=2)
    bot = torch.cat([qp.A, torch.diag_embed(-1.0 / rho)], dim=2)
    return torch.cat([top, bot], dim=1)


def _residuals(qp: QPData, x, z, q, y, yb):
    """OSQP primal/dual residuals extended with the box split, per lane."""
    Ax = _mv(qp.A, x)
    Hx = _mv(qp.H, x)
    ATy = _mv(qp.A.transpose(1, 2), y)
    r_prim = torch.maximum(_inf_norm(Ax - z), _inf_norm(x - q))
    r_dual = _inf_norm(Hx + qp.h + ATy + yb)
    prim_scale = torch.maximum(torch.maximum(_inf_norm(Ax), _inf_norm(z)),
                               torch.maximum(_inf_norm(x), _inf_norm(q)))
    dual_scale = torch.maximum(torch.maximum(_inf_norm(Hx), _inf_norm(ATy)),
                               torch.maximum(_inf_norm(qp.h), _inf_norm(yb)))
    return r_prim, r_dual, prim_scale, dual_scale


def _dense_epoch(kkt, qp: QPData, rho, rb, state, settings: ADMMSettings):
    """``check_every`` iterations against one LU factorisation (or explicit
    inverse) per lane — the JAX package's LU epoch."""
    x, z, q, y, yb = state
    n = x.shape[1]
    m = z.shape[1]
    if settings.kkt_solver == "inverse":
        kinv = torch.linalg.inv(kkt)
        solve = lambda rhs: _mv(kinv, rhs)
    else:
        LU, piv = torch.linalg.lu_factor(kkt)
        solve = lambda rhs: torch.linalg.lu_solve(LU, piv, rhs[..., None])[
            ..., 0]
    a, sigma = settings.alpha, settings.sigma
    for _ in range(settings.check_every):
        rhs = sigma * x + rb * q - yb - qp.h
        if m:
            rhs = torch.cat([rhs, z - y / rho], dim=1)
        sol = solve(rhs)
        xt = sol[:, :n]
        x_new = a * xt + (1 - a) * x
        q_u = a * xt + (1 - a) * q
        q_new = torch.clamp(q_u + yb / rb, min=qp.xl, max=qp.xu)
        yb = yb + rb * (q_u - q_new)
        if m:
            zt = z + (sol[:, n:] - y) / rho
            z_u = a * zt + (1 - a) * z
            z_new = torch.clamp(z_u + y / rho, min=qp.al, max=qp.au)
            y = y + rho * (z_u - z_new)
            z = z_new
        x, q = x_new, q_new
    return x, z, q, y, yb


def epoch_route(n: int, m: int, settings: ADMMSettings) -> str:
    """The epoch a QP of n primals and m rows takes, chosen by shape before
    any launch in the JAX package's order (its ``_make_epoch_fn``):
    ``"bbt"`` (the BBT epoch kernel) for ``kkt_solver="kernel"`` with a
    consistent structure of this QP's n and m that the kernel fits
    (``bbt_kernel_fits``); else ``"dense_kernel"`` (the dense epoch kernel)
    for ``kkt_solver="kernel"`` where ``epoch_kernel_fits(n, m)``; else
    ``"lu"`` (the batched LU or inverse epoch)."""
    stc = settings.structure
    if settings.kkt_solver == "kernel":
        if (stc is not None and stc.n == n and stc.m == m
                and structure_is_consistent(stc) and bbt_kernel_fits(stc)):
            return "bbt"
        if epoch_kernel_fits(n, m):
            return "dense_kernel"
    return "lu"


def _epoch(kkt, qp: QPData, rho, rb, state, settings: ADMMSettings):
    """One epoch on a batch of lanes through :func:`epoch_route`'s route
    (the JAX package's ``_make_epoch_fn`` as a direct call)."""
    route = epoch_route(qp.h.shape[1], qp.al.shape[1], settings)
    if route == "lu":
        return _dense_epoch(kkt, qp, rho, rb, state, settings)
    kw = dict(sigma=float(settings.sigma), alpha=float(settings.alpha),
              iters=int(settings.check_every))
    args = (kkt, qp.h, qp.al, qp.au, qp.xl, qp.xu, rho, rb, *state)
    if route == "bbt":
        return bbt_admm_epoch_batched(*args, st=settings.structure, **kw)
    return admm_epoch_batched(*args, **kw)


def _polish(qp: QPData, x, y, yb, rp, rd, settings: ADMMSettings):
    """Active-set polish (OSQP section 5.5), per lane: guess the active set
    from the ADMM solution, solve the equality-constrained KKT exactly (one
    dense LU), keep the polished point only where it improves both
    residuals."""
    B, n = x.shape
    m = y.shape[1]
    dt, dev = x.dtype, x.device
    tol = 10.0 * settings.eps_abs + 1e-9
    Ax = _mv(qp.A, x)
    act_lo = (Ax - qp.al) <= tol
    act_up = (qp.au - Ax) <= tol
    b_act = torch.where(act_lo, qp.al, qp.au)
    actb_lo = (x - qp.xl) <= tol
    actb_up = (qp.xu - x) <= tol
    bb_act = torch.where(actb_lo, qp.xl, qp.xu)
    b_act = torch.where(torch.isfinite(b_act), b_act, torch.zeros_like(b_act))
    bb_act = torch.where(torch.isfinite(bb_act), bb_act,
                         torch.zeros_like(bb_act))
    af = (act_lo | act_up).to(dt)
    abf = (actb_lo | actb_up).to(dt)
    dl = settings.polish_delta
    In = torch.eye(n, dtype=dt, device=dev).expand(B, n, n)
    box_row = torch.cat([torch.diag_embed(abf),
                         qp.A.new_zeros((B, n, m)),
                         torch.diag_embed((1.0 - abf) - dl * abf)], dim=2)
    top = torch.cat([qp.H + dl * In, qp.A.transpose(1, 2), In], dim=2)
    mid = torch.cat([af[:, :, None] * qp.A,
                     torch.diag_embed((1.0 - af) - dl * af),
                     qp.A.new_zeros((B, m, n))], dim=2)
    J = torch.cat([top, mid, box_row], dim=1)
    rhs = torch.cat([-qp.h, af * b_act, abf * bb_act], dim=1)
    # a singular system reports info != 0 and keeps the ADMM point, as a
    # non-finite solve does in the JAX package
    sol, info = torch.linalg.solve_ex(J, rhs)
    xp = torch.clamp(sol[:, :n], min=qp.xl, max=qp.xu)
    yp = sol[:, n:n + m]
    ybp = sol[:, n + m:]
    zp = torch.clamp(_mv(qp.A, xp), min=qp.al, max=qp.au)
    rp_p, rd_p, _, _ = _residuals(qp, xp, zp, xp, yp, ybp)
    ok = ((info == 0) & torch.isfinite(xp).all(1) & torch.isfinite(yp).all(1)
          & torch.isfinite(ybp).all(1) & (rp_p <= rp) & (rd_p <= rd))
    keep = ok[:, None]
    return (torch.where(keep, xp, x), torch.where(keep, yp, y),
            torch.where(keep, ybp, yb), torch.where(ok, rp_p, rp),
            torch.where(ok, rd_p, rd))


def _take(qp: QPData, idx):
    return QPData(*(t.index_select(0, idx) for t in qp))


@full_precision()
def box_admm_solve(qp: QPData, x0=None, y0=None, y_box0=None,
                   settings: ADMMSettings = ADMMSettings()) -> QPSolution:
    """Solve a batch of box-constrained QPs (every tensor of ``qp`` has a
    leading lane axis B).

    x0, y0, y_box0: optional (B, n) / (B, m) / (B, n) warm starts.

    Gradients flow through the solution by implicit differentiation of the
    KKT conditions at the converged active set (:class:`_ImplicitQP`, the
    JAX package's ``custom_vjp``), not by unrolling the iterations.  Only a
    call where some field of ``qp`` requires grad enters it; every other
    call runs the solve directly.
    """
    if not settings.validate():
        raise ValueError("invalid ADMM settings")
    with span("qp.solve"):
        if torch.is_grad_enabled() and any(t.requires_grad for t in qp):
            out = _ImplicitQP.apply(settings, x0, y0, y_box0, *qp)
            return QPSolution(*out)
        return _box_admm_raw(qp, x0, y0, y_box0, settings)


def _start(qp: QPData, x0, y0, y_box0, settings: ADMMSettings):
    """The solve's starting point: (qp, scaling) after the Ruiz
    equilibration (scaling None without it) and the first epoch's state
    (x, z, q, y, yb) in that scaling."""
    B, n = qp.h.shape
    m = qp.al.shape[1]
    dt, dev = qp.H.dtype, qp.H.device
    x = torch.zeros((B, n), dtype=dt, device=dev) if x0 is None \
        else x0.to(dt)
    y = torch.zeros((B, m), dtype=dt, device=dev) if y0 is None \
        else y0.to(dt)
    yb = torch.zeros((B, n), dtype=dt, device=dev) if y_box0 is None \
        else y_box0.to(dt)
    scaling = None
    if settings.equil_iters > 0:
        qp, scaling = ruiz_equilibrate(qp, iters=settings.equil_iters)
        # inverse of unscale_solution: x = d x~, y = e y~ / c,
        # yb = yb~ / (d c)
        c = scaling.c[:, None]
        x = x / scaling.d
        y = y * c / scaling.e
        yb = yb * scaling.d * c
    return qp, scaling, (x, _mv(qp.A, x), x, y, yb)


@full_precision()
def first_epoch(qp: QPData, x0=None, y0=None, y_box0=None,
                settings: ADMMSettings = ADMMSettings()):
    """The inputs of :func:`box_admm_solve`'s first epoch on ``qp`` from
    the same warm starts: the 13 arguments of ``ops.admm_epoch`` (kkt, h,
    al, au, xl, xu, rho, rho_box, x, z, q, y, yb), every lane at the first
    penalty, in the Ruiz scaling where ``settings.equil_iters > 0``.  The
    kernels' checks take their inputs from here."""
    qp, _, state = _start(qp, x0, y0, y_box0, settings)
    B = qp.h.shape[0]
    rho, rb = penalties(torch.full((B,), settings.rho, dtype=qp.H.dtype,
                                   device=qp.H.device), qp, settings)
    return (_build_kkt(qp, rho, rb, settings.sigma), qp.h, qp.al, qp.au,
            qp.xl, qp.xu, rho, rb, *state)


def _check(qp: QPData, old, state, new, settings: ADMMSettings):
    """One epoch's end for its lanes: the divergence guard (freeze at the
    last finite state), residuals, infeasibility certificates, adaptive
    rho and the stopping test; returns the lanes' new solve state."""
    finite = (torch.isfinite(new[0]).all(1) & torch.isfinite(new[3]).all(1)
              & torch.isfinite(new[4]).all(1))
    x2, z2, q2, y2, yb2 = (torch.where(finite[:, None], a, b)
                           for a, b in zip(new, state))
    rp2, rd2, ps, ds = _residuals(qp, x2, z2, q2, y2, yb2)
    eps_p = settings.eps_abs + settings.eps_rel * ps
    eps_d = settings.eps_abs + settings.eps_rel * ds
    conv = (rp2 <= eps_p) & (rd2 <= eps_d)
    div2 = old["div"] | ~finite
    pinf2, dinf2 = _infeasibility_certificates(
        qp, x2 - state[0], y2 - state[3], yb2 - state[4], settings.eps_inf)
    pinf2 = old["pinf"] | (pinf2 & finite & ~conv)
    dinf2 = old["dinf"] | (dinf2 & finite & ~conv)
    rho_base = old["rho"]
    if settings.adaptive_rho:
        num = rp2 / torch.clamp(ps, min=1e-12)
        den = rd2 / torch.clamp(ds, min=1e-12)
        scale = torch.clamp(torch.sqrt(num / torch.clamp(den, min=1e-12)),
                            1e-3, 1e3)
        rho_base = torch.clamp(rho_base * scale, settings.rho_min,
                               settings.rho_max)
    return {"x": x2, "z": z2, "q": q2, "y": y2, "yb": yb2,
            "rho": rho_base, "epoch": old["epoch"] + 1,
            "done": conv | div2 | pinf2 | dinf2, "rp": rp2, "rd": rd2,
            "div": div2, "pinf": pinf2, "dinf": dinf2}


def _box_admm_raw(qp: QPData, x0, y0, y_box0,
                  settings: ADMMSettings) -> QPSolution:
    B, n = qp.h.shape
    dt, dev = qp.H.dtype, qp.H.device
    qp, scaling, (x, z, q, y, yb) = _start(qp, x0, y0, y_box0, settings)

    inf = torch.full((B,), float("inf"), dtype=dt, device=dev)
    false = torch.zeros(B, dtype=torch.bool, device=dev)
    S = {"x": x, "z": z, "q": q, "y": y, "yb": yb,
         "rho": torch.full((B,), settings.rho, dtype=dt, device=dev),
         "epoch": torch.zeros(B, dtype=torch.int32, device=dev),
         "done": false, "rp": inf, "rd": inf.clone(), "div": false.clone(),
         "pinf": false.clone(), "dinf": false.clone()}

    while True:
        with span("qp.epoch"):
            with span("qp.gather"):
                active = ~S["done"] & (S["epoch"] < settings.max_epochs)
                idx, lanes = _nonzero(active)
                if lanes == 0:
                    break
                sub = _take(qp, idx)
                old = {k: v.index_select(0, idx) for k, v in S.items()}
            state = (old["x"], old["z"], old["q"], old["y"], old["yb"])
            with span("qp.kkt"):
                rho, rb = penalties(old["rho"], sub, settings)
                kkt = _build_kkt(sub, rho, rb, settings.sigma)
            with span("qp.kernel"):
                new = _epoch(kkt, sub, rho, rb, state, settings)
            with span("qp.check"):
                upd = _check(sub, old, state, new, settings)
            for k, v in upd.items():
                S[k] = S[k].index_copy(0, idx, v.to(S[k].dtype))

    x, y, yb, done = S["x"], S["y"], S["yb"], S["done"]
    if settings.polish:
        x, y, yb, rp, rd = _polish(qp, x, y, yb, S["rp"], S["rd"], settings)
        eps_p = settings.eps_abs + settings.eps_rel * torch.maximum(
            _inf_norm(_mv(qp.A, x)), _inf_norm(x))
        eps_d = settings.eps_abs + settings.eps_rel * torch.maximum(
            _inf_norm(_mv(qp.H, x)), _inf_norm(qp.h))
        done = done | ((rp <= eps_p) & (rd <= eps_d) & ~S["div"])
        S["rp"], S["rd"] = rp, rd
    status = torch.full((B,), st.MAX_ITER_EXCEEDED, dtype=torch.int32,
                        device=dev)
    status = torch.where(done, st.SOLVED, status)
    status = torch.where(S["dinf"], st.INCONSISTENT, status)
    status = torch.where(S["pinf"], st.INFEASIBLE, status)
    status = torch.where(S["div"], st.UNSOLVED, status).to(torch.int32)
    rho_final, _ = penalties(S["rho"], qp, settings)
    if scaling is not None:
        x, y, yb = unscale_solution(x, y, yb, scaling)
    return QPSolution(x=x, y=y, y_box=yb, status=status,
                      iters=(S["epoch"] * settings.check_every).to(
                          torch.int32),
                      res_prim=S["rp"], res_dual=S["rd"], rho=rho_final)


def _bound_weights(lo, up, dt):
    """Split a bound cotangent between the lower and the upper bound of a
    row; an equality row (both active) gives each half, so the cotangent
    is not counted twice."""
    lo_f, up_f = lo.to(dt), up.to(dt)
    denom = torch.clamp(lo_f + up_f, min=1.0)
    return lo_f / denom, up_f / denom


class _ImplicitQP(torch.autograd.Function):
    """The QP solution map with its implicit-differentiation VJP
    (OptNet-style; the JAX package's ``_solve_vjp``).

    The forward is the batch-first solve.  The backward fixes each lane's
    active set at ``tol = 10 eps_abs + 1e-8``; at the solution (x, y, y_box)
    then solve

        F1 = H x + h + A'y + y_box                     = 0
        F2_i = act_i (A_i x - b_i) + (1 - act_i) y_i   = 0
        F3_i = actb_i (x_i - bb_i) + (1 - actb_i) ybox_i = 0,

    so v = J^-T [x_bar; y_bar; ybox_bar] (J regularised by 1e-10 I: the
    active-set KKT can be singular at degenerate solutions) and every
    parameter's cotangent is -v' dF/dtheta.  The dense solve is
    ``torch.linalg.solve``, as ``jnp.linalg.solve`` in the JAX package."""

    @staticmethod
    def forward(ctx, settings, x0, y0, y_box0, *fields):
        qp = QPData(*fields)
        sol = _box_admm_raw(qp, x0, y0, y_box0, settings)
        ctx.settings = settings
        ctx.save_for_backward(qp.H, qp.A, qp.al, qp.au, qp.xl, qp.xu,
                              sol.x, sol.y)
        ctx.mark_non_differentiable(sol.status, sol.iters, sol.res_prim,
                                    sol.res_dual, sol.rho)
        return tuple(sol)

    @staticmethod
    @full_precision()
    def backward(ctx, x_bar, y_bar, yb_bar, *_):
        H, A, al, au, xl, xu, x, y = ctx.saved_tensors
        B, n = x.shape
        m = y.shape[1]
        dt, dev = x.dtype, x.device
        tol = 10.0 * ctx.settings.eps_abs + 1e-8
        Ax = _mv(A, x)
        act_lo = (Ax - al) <= tol
        act_up = (au - Ax) <= tol
        actb_lo = (x - xl) <= tol
        actb_up = (xu - x) <= tol
        af = (act_lo | act_up).to(dt)
        abf = (actb_lo | actb_up).to(dt)
        In = torch.eye(n, dtype=dt, device=dev).expand(B, n, n)
        zeros = lambda r, c: torch.zeros((B, r, c), dtype=dt, device=dev)
        J = torch.cat([
            torch.cat([H, A.transpose(1, 2), In], 2),
            torch.cat([af[:, :, None] * A, torch.diag_embed(1.0 - af),
                       zeros(m, n)], 2),
            torch.cat([torch.diag_embed(abf), zeros(n, m),
                       torch.diag_embed(1.0 - abf)], 2)], 1)
        J = J + 1e-10 * torch.eye(2 * n + m, dtype=dt, device=dev)
        rhs = torch.cat([x_bar, y_bar, yb_bar], 1)
        v = torch.linalg.solve(J.transpose(1, 2), rhs)
        v1, v2, v3 = v[:, :n], v[:, n:n + m], v[:, n + m:]
        outer = lambda a, b: a[:, :, None] * b[:, None, :]
        H_bar = -outer(v1, x)
        # H enters the QP only through its symmetric part
        H_bar = 0.5 * (H_bar + H_bar.transpose(1, 2))
        # A_ij enters F1_j with weight y_i and F2_i with act_i x_j
        A_bar = -outer(y, v1) - outer(af * v2, x)
        w_lo, w_up = _bound_weights(act_lo, act_up, dt)
        wb_lo, wb_up = _bound_weights(actb_lo, actb_up, dt)
        return (None, None, None, None, H_bar, -v1, A_bar, v2 * w_lo,
                v2 * w_up, v3 * wb_lo, v3 * wb_up)


def admm_solve(qp: QPData, x0=None, y0=None,
               settings: ADMMSettings = ADMMSettings()) -> QPSolution:
    """The standard OSQP splitting: the box rows stacked into A as [I; A]
    (ref: admm.hpp:32-38 ``construct_A``), so each lane's QP has m + n rows
    and no box, solved by :func:`box_admm_solve` (its epochs through
    :func:`epoch_route`).  For parity and testing; the box-split solver is
    the production path.  y0 (B, m) warm-starts the general rows' duals."""
    B, n = qp.h.shape
    dt, dev = qp.H.dtype, qp.H.device
    eye = torch.eye(n, dtype=dt, device=dev).expand(B, n, n)
    inf = torch.full((B, n), float("inf"), dtype=dt, device=dev)
    qp2 = QPData(H=qp.H, h=qp.h, A=torch.cat([eye, qp.A], 1),
                 al=torch.cat([qp.xl, qp.al], 1),
                 au=torch.cat([qp.xu, qp.au], 1), xl=-inf, xu=inf)
    y0_2 = None if y0 is None else torch.cat(
        [torch.zeros((B, n), dtype=dt, device=dev), y0.to(dt)], 1)
    sol = box_admm_solve(qp2, x0=x0, y0=y0_2, settings=settings)
    return QPSolution(x=sol.x, y=sol.y[:, n:], y_box=sol.y[:, :n],
                      status=sol.status, iters=sol.iters,
                      res_prim=sol.res_prim, res_dual=sol.res_dual,
                      rho=sol.rho[:, n:])
