"""Primal-dual interior-point NLP solver (the native Ipopt analogue),
batch-first — the port of polympc_tpu/nlp/ip.py.

The reference bridges to Ipopt (``ipopt_interface.hpp:387-495``, defaults
tol 1e-6, adaptive mu, max_iter 100 at :403-406); this is the JAX
package's self-contained barrier method with the same coverage and
tolerances, for a batch of problems, one per lane:

    min_x  f(x, p)
    s.t.   c_e(x, p)  = 0
           gl <= c_i(x, p) <= gu
           lbx <= x <= ubx

Algorithm (monotone Fiacco-McCormick, the core of Ipopt [Waechter & Biegler
2006] without the filter restoration phase), as in the JAX package:

  * slack reformulation: w = (x, s), the inequality rows become the
    equalities c_i(x) - s = 0 with the box gl <= s <= gu;
  * every finite bound relaxed outward by ``bound_relax`` (Ipopt's
    bound_relax_factor) and the start pushed strictly inside (kappa_1,
    kappa_2);
  * log barrier on the finite bounds with explicit duals (z_l, z_u); per
    iteration the condensed KKT [[W + Sigma + dw I, J'], [J, -dc I]] of
    order nw + me, solved by ``torch.linalg.solve``, with W the Lagrangian
    Hessian convexified by ``regularize`` (nlp/hessian.py);
  * fraction-to-boundary steps, a fixed ladder of ``ls_max_iter`` Armijo
    trials on the l1 barrier merit (the first passing trial, else the
    smallest step), the kappa_Sigma dual safeguard;
  * mu decreased superlinearly once the barrier KKT error is below
    kappa_eps * mu; termination on the scaled KKT error at mu = 0.  One
    Jacobian per iteration, carried in the state, serves the barrier test,
    the termination test and the next Newton system.

A lane stops once SOLVED or non-finite, or after ``max_iter`` iterations;
the lanes still running are gathered into a smaller batch for the next
iteration, so each lane stops where it would stop alone (the JAX package
freezes finished lanes under ``vmap``).  The line-search trials of all
lanes are one (B * ls_max_iter, n) batch of cost and constraint values; no
derivative is taken there.  ``p`` is shared by all lanes, as in
``sqp_solve``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch.func import grad, jacrev, vmap

from polympc_torch.nlp.hessian import regularize
from polympc_torch.nlp.sqp import _constraints, derivative_fns
from polympc_torch.nlp.types import NLP, NLPBounds, unbounded
from polympc_torch.qp.ip import _amax, _mv
from polympc_torch.utils import status as st
from polympc_torch.utils.precision import full_precision

__all__ = ["IPNLPSettings", "IPNLPSolution", "nlp_ip_solve"]


@dataclasses.dataclass(frozen=True)
class IPNLPSettings:
    """Defaults mirror the reference Ipopt bridge (ipopt_interface.hpp:
    403-406: tol 1e-6, mu_strategy adaptive, max_iter 100); the fields of
    the JAX package's ``IPNLPSettings``."""
    max_iter: int = 100
    ls_max_iter: int = 12       # Armijo trials per iteration (fixed)
    tol: float = 1e-6           # overall scaled KKT tolerance
    mu_init: float = 0.1
    mu_min: float = 1e-11
    kappa_eps: float = 10.0     # barrier subproblem tolerance = kappa_eps*mu
    kappa_mu: float = 0.2       # linear mu decrease factor
    theta_mu: float = 1.5       # superlinear mu decrease exponent
    tau_min: float = 0.99       # fraction-to-boundary: max(tau_min, 1-mu)
    eta: float = 1e-4           # Armijo sufficient decrease
    reg_w: float = 1e-8         # primal (1,1)-block regularisation
    reg_c: float = 1e-8         # dual (2,2)-block regularisation
    bound_push: float = 1e-2    # kappa_1: initial distance to bounds
    bound_frac: float = 1e-2    # kappa_2: relative initial distance
    # Ipopt bound_relax_factor: every finite bound is relaxed outward by
    # relax*max(1,|b|) so fixed variables (lb == ub, e.g. a pinned MPC
    # initial condition) keep a nonempty strict interior
    bound_relax: float = 1e-8
    # Hessian convexification, the role of Ipopt's inertia correction:
    # "none" trusts an already-convex W; "eigen" / "mirror" / "gershgorin"
    # regularise the Lagrangian Hessian (nlp/hessian.py)
    reg: str = "eigen"
    reg_eps: float = 1e-6
    loose_bound: float = 1e10
    hessian: str = "exact"      # "exact" | "gauss_newton"
    nu_safety: float = 1.0      # l1 merit penalty = ||y||_inf + safety

    def validate(self) -> bool:
        return (self.max_iter >= 1 and self.ls_max_iter >= 1
                and 0 < self.kappa_mu < 1 and self.theta_mu > 1
                and 0 < self.tau_min < 1
                and self.hessian in ("exact", "gauss_newton")
                and self.reg in ("none", "gershgorin", "eigen", "mirror"))


class IPNLPSolution(NamedTuple):
    x: torch.Tensor          # (B, n)
    lam: torch.Tensor        # (B, ne+ni) equality/inequality duals
    lam_box: torch.Tensor    # (B, n) net box duals z_u - z_l (x part)
    status: torch.Tensor     # (B,) int32
    iters: torch.Tensor      # (B,) int32
    cost: torch.Tensor       # (B,)
    kkt_error: torch.Tensor  # (B,) final unscaled KKT infinity norm (mu=0)
    mu: torch.Tensor         # (B,) final barrier parameter
    violation: torch.Tensor  # (B,) final max constraint violation


@full_precision()
def nlp_ip_solve(nlp: NLP, x0, p=None, bounds: Optional[NLPBounds] = None,
                 lam0=None, settings: IPNLPSettings = IPNLPSettings()
                 ) -> IPNLPSolution:
    """Solve a batch of NLPs from start points x0 (B, n) by the interior
    point.  Same call surface as ``sqp_solve``: ``bounds`` tensors shared
    ((n,), (ni,)) or per lane ((B, n), (B, ni)); ``lam0`` (B, ne+ni)
    warm-starts the equality-block duals.  x0 is pushed strictly inside
    the box first, so a guess on or outside a bound is fine."""
    if not settings.validate():
        raise ValueError("invalid IP settings")
    B, n = x0.shape
    ne, ni = nlp.ne, nlp.ni
    nw, me = n + ni, ne + ni
    dt, dev = x0.dtype, x0.device
    if bounds is None:
        bounds = unbounded(nlp, dt, dev)
    gl = bounds.gl.to(dt).expand(B, ni)
    gu = bounds.gu.to(dt).expand(B, ni)

    cost_fn = lambda x: nlp.cost(x, p)
    con_fn = lambda x: _constraints(nlp, x, p)
    grad_fn, jac_fn = derivative_fns(nlp, p)
    # the Lagrangian Hessian in the JAX package's order
    if settings.hessian == "gauss_newton" and nlp.gn_hessian is not None:
        lag_hess = lambda x, y: nlp.gn_hessian(x, p)
    elif nlp.lag_hessian is not None:
        lag_hess = lambda x, y: nlp.lag_hessian(x, y, p)
    else:
        def lagr(xi, yi):
            val = nlp.cost(xi[None], p)[0]
            if me:
                val = val + _constraints(nlp, xi[None], p)[0] @ yi
            return val
        # reverse over reverse: in this torch, forward mode
        # (torch.func.hessian's outer jacfwd) promotes float32 tangents
        lag_hess = vmap(jacrev(grad(lagr)))

    # ---- bounds on w = (x, s): the x box and the slacks' ranges ----
    wl = torch.cat([bounds.lbx.to(dt).expand(B, n), gl], 1)
    wu = torch.cat([bounds.ubx.to(dt).expand(B, n), gu], 1)
    has_l = wl > -settings.loose_bound
    has_u = wu < settings.loose_bound
    fl, fu = has_l.to(dt), has_u.to(dt)
    rlx = settings.bound_relax
    zero = torch.zeros_like(wl)
    wl_s = torch.where(has_l, wl - rlx * torch.clamp(wl.abs(), min=1.0),
                       zero)
    wu_s = torch.where(has_u, wu + rlx * torch.clamp(wu.abs(), min=1.0),
                       zero)

    # Ipopt kappa_1/kappa_2 push: strictly inside every finite bound
    width = torch.where(has_l & has_u, wu_s - wl_s, torch.ones_like(wl))
    push = torch.clamp(settings.bound_frac * width.abs(),
                       min=settings.bound_push)
    lo = torch.where(has_l, wl_s + push, torch.full_like(wl, -float("inf")))
    hi = torch.where(has_u, wu_s - push, torch.full_like(wl, float("inf")))
    mid = 0.5 * (wl_s + wu_s)
    crossed = lo > hi   # a narrow interval: the midpoint
    x0 = x0.to(dt)
    w = torch.cat([x0, nlp.ineq(x0, p)], 1) if ni else x0
    w = torch.clamp(w, min=torch.where(crossed, mid, lo),
                    max=torch.where(crossed, mid, hi))

    def slacked(w):
        """Equality residual C(w) = [c_e(x); c_i(x) - s]."""
        c = con_fn(w[:, :n])
        if ni:
            c = torch.cat([c[:, :ne], c[:, ne:] - w[:, n:]], 1)
        return c

    def slacked_jac(w):
        J = jac_fn(w[:, :n])                               # (b, me, n)
        if ni:
            Js = torch.cat([torch.zeros((ne, ni), dtype=dt, device=dev),
                            -torch.eye(ni, dtype=dt, device=dev)], 0)
            J = torch.cat([J, Js.expand(J.shape[0], me, ni)], 2)
        return J

    def grad_w(w):
        g = grad_fn(w[:, :n])
        return torch.cat([g, g.new_zeros((g.shape[0], ni))], 1) if ni \
            else g

    def hess_w(w, y):
        W = regularize(lag_hess(w[:, :n], y), settings.reg, settings.reg_eps)
        if ni:
            W = torch.nn.functional.pad(W, (0, ni, 0, ni))
        return W

    def dist(d, w):
        """Distances to the (relaxed) bounds, 1 where there is none."""
        one = torch.ones_like(w)
        return (torch.where(d["has_l"], w - d["wl_s"], one),
                torch.where(d["has_u"], d["wu_s"] - w, one))

    def kkt_error_from(d, J, g, r_c, w, y, z_l, z_u, mu):
        """Infinity-norm KKT error of the mu-barrier problem (mu = 0: the
        true one) from a precomputed Jacobian, objective gradient and
        equality residual, Ipopt-scaled so large duals do not stall
        termination; mu (b,) or a float."""
        fl, fu = d["fl"], d["fu"]
        d_l, d_u = dist(d, w)
        Jty = _mv(J.transpose(1, 2), y) if me else 0.0
        r_d = g + Jty - fl * z_l + fu * z_u
        mu = mu[:, None] if torch.is_tensor(mu) else mu
        comp = torch.maximum(_amax(torch.abs(fl * (d_l * z_l - mu))),
                             _amax(torch.abs(fu * (d_u * z_u - mu))))
        s_d = torch.clamp((y.abs().sum(1) + (fl * z_l).sum(1)
                           + (fu * z_u).sum(1))
                          / max(1.0, float(me + 2 * nw)) / 100.0, min=1.0)
        return torch.maximum(_amax(torch.abs(r_d)) / s_d,
                             torch.maximum(_amax(torch.abs(r_c)),
                                           comp / s_d))

    def barrier_merit(d, w, mu, nu):
        """The l1 barrier merit at w (b, nw) with mu, nu (b,)."""
        d_l, d_u = dist(d, w)
        safe = lambda v: torch.log(torch.clamp(v, min=1e-300))
        bar = -mu * ((d["fl"] * safe(d_l)).sum(1)
                     + (d["fu"] * safe(d_u)).sum(1))
        return (cost_fn(w[:, :n]) + bar
                + nu * torch.abs(slacked(w)).sum(1))

    L = settings.ls_max_iter
    halves = 0.5 ** torch.arange(L, dtype=dt, device=dev)

    def body(d, s):
        w, y, z_l, z_u, mu = (s[k] for k in ("w", "y", "z_l", "z_u", "mu"))
        J, g, r_c = s["J"], s["g"], s["r_c"]
        b = w.shape[0]
        has_l, has_u, fl, fu = d["has_l"], d["has_u"], d["fl"], d["fu"]
        d_l, d_u = dist(d, w)
        Jt = J.transpose(1, 2)
        Jty = _mv(Jt, y) if me else torch.zeros_like(w)

        # condensed primal-dual Newton system on (dw, dy)
        W = hess_w(w, y)
        sigma = fl * z_l / d_l + fu * z_u / d_u
        mu_ = mu[:, None]
        r_d = g + Jty - fl * (mu_ / d_l) + fu * (mu_ / d_u)
        eye_w = torch.eye(nw, dtype=dt, device=dev)
        K = W + torch.diag_embed(sigma) + settings.reg_w * eye_w
        if me:
            K = torch.cat([
                torch.cat([K, Jt], 2),
                torch.cat([J, -settings.reg_c * torch.eye(
                    me, dtype=dt, device=dev).expand(b, me, me)], 2)], 1)
            rhs = -torch.cat([r_d, r_c], 1)
        else:
            rhs = -r_d
        sol = torch.linalg.solve(K, rhs)
        dw, dy = sol[:, :nw], sol[:, nw:]
        nil = torch.zeros_like(w)
        dz_l = torch.where(has_l, (mu_ - z_l * d_l - z_l * dw) / d_l, nil)
        dz_u = torch.where(has_u, (mu_ - z_u * d_u + z_u * dw) / d_u, nil)

        # fraction-to-boundary
        tau = torch.clamp(1.0 - mu, min=settings.tau_min)[:, None]

        def max_alpha(v, dv, mask):
            neg = dv < 0
            ratio = torch.where(neg & mask, -tau * v / torch.where(
                neg, dv, -torch.ones_like(dv)),
                torch.full_like(v, float("inf")))
            return torch.clamp(torch.amin(ratio, dim=1), max=1.0)

        a_w = torch.minimum(max_alpha(d_l, dw, has_l),
                            max_alpha(d_u, -dw, has_u))
        a_z = torch.minimum(max_alpha(z_l, dz_l, has_l),
                            max_alpha(z_u, dz_u, has_u))[:, None]

        # Armijo backtracking on the l1 barrier merit: every lane's
        # ls_max_iter trials in one batch of merits
        nu = _amax(y.abs()) + _amax((y + dy).abs()) + settings.nu_safety
        phi0 = barrier_merit(d, w, mu, nu)
        # the barrier gradient (r_d without J'y) against dw, less the l1
        # infeasibility drop
        gphi = r_d - Jty
        dphi = torch.clamp((gphi * dw).sum(1)
                           - nu * torch.abs(r_c).sum(1), max=-1e-16)
        alphas = a_w[:, None] * halves                         # (b, L)
        wt = (w[:, None, :] + alphas[:, :, None] * dw[:, None, :]
              ).reshape(b * L, nw)
        rep = lambda t: t.repeat_interleave(L, 0)
        dt_ = {k: rep(d[k]) for k in ("has_l", "has_u", "wl_s", "wu_s",
                                      "fl", "fu")}
        merit = barrier_merit(dt_, wt, rep(mu), rep(nu)).reshape(b, L)
        ok = merit <= phi0[:, None] + settings.eta * alphas * dphi[:, None]
        first = torch.argmax(ok.to(torch.int32), dim=1)
        # no passing trial: the smallest step rather than a stall
        sel = torch.where(ok.any(1), first, torch.full_like(first, L - 1))
        alpha = alphas.gather(1, sel[:, None])

        w2 = w + alpha * dw
        y2 = y + alpha * dy
        z_l2 = torch.where(has_l, z_l + a_z * dz_l, nil)
        z_u2 = torch.where(has_u, z_u + a_z * dz_u, nil)
        # dual safeguard (Ipopt kappa_Sigma): z within 1e10 of mu/d
        d_l2, d_u2 = dist(d, w2)
        kS = 1e10
        z_l2 = torch.clamp(z_l2, min=mu_ / (kS * d_l2), max=kS * mu_ / d_l2)
        z_u2 = torch.clamp(z_u2, min=mu_ / (kS * d_u2), max=kS * mu_ / d_u2)
        z_l2 = torch.where(has_l, z_l2, nil)
        z_u2 = torch.where(has_u, z_u2, nil)

        finite = (torch.isfinite(w2).all(1) & torch.isfinite(y2).all(1))
        keep = finite[:, None]
        w2 = torch.where(keep, w2, w)
        y2 = torch.where(keep, y2, y)
        z_l2 = torch.where(keep, z_l2, z_l)
        z_u2 = torch.where(keep, z_u2, z_u)

        # one derivative evaluation at the new point serves the barrier
        # error, the termination test and the next Newton system
        J2, g2, c2 = slacked_jac(w2), grad_w(w2), slacked(w2)
        e_mu = kkt_error_from(d, J2, g2, c2, w2, y2, z_l2, z_u2, mu)
        shrink = e_mu <= settings.kappa_eps * mu * d["n_scale"]
        mu2 = torch.where(shrink, torch.clamp(torch.minimum(
            settings.kappa_mu * mu, mu ** settings.theta_mu),
            min=settings.mu_min), mu)
        conv = kkt_error_from(d, J2, g2, c2, w2, y2, z_l2, z_u2,
                              0.0) <= settings.tol
        status2 = torch.where(conv, st.SOLVED, torch.where(
            finite, s["status"], st.UNSOLVED)).to(torch.int32)
        return {"w": w2, "y": y2, "z_l": z_l2, "z_u": z_u2, "mu": mu2,
                "it": s["it"] + 1, "status": status2, "J": J2, "g": g2,
                "r_c": c2}

    mu0 = torch.full((B,), settings.mu_init, dtype=dt, device=dev)
    D = {"has_l": has_l, "has_u": has_u, "fl": fl, "fu": fu, "wl_s": wl_s,
         "wu_s": wu_s,
         "n_scale": torch.clamp((fl.sum(1) + fu.sum(1)) / max(nw, 1),
                                min=1.0)}
    d_l0, d_u0 = dist(D, w)
    S = {"w": w,
         "y": torch.zeros((B, me), dtype=dt, device=dev) if lam0 is None
         else lam0.to(dt),
         "z_l": torch.where(has_l, mu0[:, None] / d_l0, zero),
         "z_u": torch.where(has_u, mu0[:, None] / d_u0, zero),
         "mu": mu0, "it": torch.zeros(B, dtype=torch.int32, device=dev),
         "status": torch.full((B,), st.MAX_ITER_EXCEEDED, dtype=torch.int32,
                              device=dev),
         "J": slacked_jac(w), "g": grad_w(w), "r_c": slacked(w)}
    while True:
        active = (S["status"] == st.MAX_ITER_EXCEEDED) & \
            (S["it"] < settings.max_iter)
        idx = torch.nonzero(active).flatten()
        if idx.numel() == 0:
            break
        take = lambda t: t.index_select(0, idx)
        new = body({k: take(v) for k, v in D.items()},
                   {k: take(v) for k, v in S.items()})
        for k, v in new.items():
            S[k] = S[k].index_copy(0, idx, v)

    w, y, z_l, z_u = S["w"], S["y"], S["z_l"], S["z_u"]
    x = w[:, :n]
    err = kkt_error_from(D, S["J"], S["g"], S["r_c"], w, y, z_l, z_u, 0.0)
    ce = S["r_c"]
    # inequality violation against [gl, gu] directly
    ci = nlp.ineq(x, p) if ni else x.new_zeros((B, 0))
    viol = torch.maximum(_amax(ce[:, :ne].abs()),
                         torch.maximum(_amax(gl - ci), _amax(ci - gu)))
    viol = torch.maximum(viol, torch.maximum(_amax(fl * (wl_s - w)),
                                             _amax(fu * (w - wu_s))))
    return IPNLPSolution(
        x=x, lam=y, lam_box=(fu * z_u - fl * z_l)[:, :n],
        status=S["status"], iters=S["it"], cost=cost_fn(x), kkt_error=err,
        mu=S["mu"], violation=viol)
