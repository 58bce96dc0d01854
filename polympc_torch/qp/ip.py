"""Primal-dual interior-point QP solver (Mehrotra predictor-corrector),
batch-first — the port of polympc_tpu/qp/ip.py.

The high-accuracy QP backend, in the role of the reference's external
solver interfaces (osqp_interface.hpp, qpmad_interface.hpp,
ipopt_interface.hpp).  Problem form, one per lane (as box_admm):

    min 1/2 x'Hx + h'x   s.t.  al <= Ax <= au,  xl <= x <= xu.

All 2(m+n) one-sided constraints get slacks s >= 0 and duals z >= 0 on the
rows C = [A; I]; infinite bounds are masked out (duals pinned to 0, slacks
to 1).  Eliminating (s, z) leaves the condensed SPD system
(H + C' diag(d) C) dx = r of order n, factored by Cholesky per lane.

Every lane runs its own iteration count: a lane stops once converged (or
non-finite) or after ``max_iter`` iterations, and the lanes still running
are gathered into a smaller batch for the next iteration, so each lane
stops where it would stop alone (the JAX package freezes finished lanes
under ``vmap``).
"""
from __future__ import annotations

import dataclasses

import torch

from polympc_torch.qp.types import QPData, QPSolution
from polympc_torch.utils import status as st
from polympc_torch.utils.precision import full_precision

__all__ = ["IPSettings", "qp_ip_solve"]


@dataclasses.dataclass(frozen=True)
class IPSettings:
    max_iter: int = 30
    eps: float = 1e-8          # KKT residual tolerance
    tau: float = 0.995         # fraction-to-boundary
    reg: float = 1e-9          # Cholesky regularisation
    loose_bound: float = 1e10
    s_init: float = 1.0        # initial slack/dual magnitude


def _amax(v):
    """Per-lane max over the last axis, 0 for an empty axis (the JAX
    ``max(..., initial=0)``)."""
    if v.shape[-1] == 0:
        return v.new_zeros(v.shape[:-1])
    return torch.clamp(torch.amax(v, dim=-1), min=0.0)


def _mv(A, v):
    return (A @ v[..., None])[..., 0]


@full_precision()
def qp_ip_solve(qp: QPData, settings: IPSettings = IPSettings()
                ) -> QPSolution:
    """Solve a batch of QPs (every tensor of ``qp`` with a leading lane
    axis B) by the interior point; returns a batched QPSolution whose
    ``iters`` are each lane's own count."""
    B, n = qp.h.shape
    m = qp.al.shape[1]
    dt, dev = qp.H.dtype, qp.H.device
    mt = m + n
    eye = torch.eye(n, dtype=dt, device=dev)
    C = torch.cat([qp.A, eye.expand(B, n, n)], dim=1)
    bl = torch.cat([qp.al, qp.xl], dim=1)
    bu = torch.cat([qp.au, qp.xu], dim=1)
    has_l = bl > -settings.loose_bound
    has_u = bu < settings.loose_bound
    fl, fu = has_l.to(dt), has_u.to(dt)
    zero = torch.zeros_like(bl)
    bl_s = torch.where(has_l, bl, zero)
    bu_s = torch.where(has_u, bu, zero)
    n_active = torch.clamp(fl.sum(1) + fu.sum(1), min=1.0)

    x = torch.clamp(torch.zeros((B, n), dtype=dt, device=dev),
                    min=torch.where(has_l[:, m:], bl_s[:, m:]
                                    + settings.s_init, -1.0),
                    max=torch.where(has_u[:, m:], bu_s[:, m:]
                                    - settings.s_init, 1.0))
    full = torch.full((B, mt), settings.s_init, dtype=dt, device=dev)
    S = {"x": x, "s_l": full, "s_u": full.clone(), "z_l": full.clone(),
         "z_u": full.clone(),
         "it": torch.zeros(B, dtype=torch.int32, device=dev),
         "done": torch.zeros(B, dtype=torch.bool, device=dev)}
    # per-lane problem data, gathered with the lanes
    D = {"H": qp.H, "h": qp.h, "C": C, "bl_s": bl_s, "bu_s": bu_s,
         "fl": fl, "fu": fu, "has_l": has_l, "has_u": has_u,
         "n_active": n_active}

    def residuals(d, x, s_l, s_u, z_l, z_u):
        Cx = _mv(d["C"], x)
        r_dual = (_mv(d["H"], x) + d["h"]
                  + _mv(d["C"].transpose(1, 2),
                        d["fu"] * z_u - d["fl"] * z_l))
        r_pl = d["fl"] * (Cx - d["bl_s"] - s_l)
        r_pu = d["fu"] * (d["bu_s"] - Cx - s_u)
        return r_dual, r_pl, r_pu

    def kkt_norm(d, x, s_l, s_u, z_l, z_u):
        r_dual, r_pl, r_pu = residuals(d, x, s_l, s_u, z_l, z_u)
        comp = torch.maximum(_amax(d["fl"] * s_l * z_l),
                             _amax(d["fu"] * s_u * z_u))
        return torch.maximum(
            _amax(torch.abs(r_dual)),
            torch.maximum(_amax(torch.abs(r_pl)),
                          torch.maximum(_amax(torch.abs(r_pu)), comp)))

    def max_alpha(v, dv, mask):
        """Largest alpha in (0, 1] keeping v + alpha dv >= (1-tau) v."""
        neg = dv < 0
        ratio = torch.where(neg & (mask > 0),
                            -settings.tau * v / torch.where(
                                neg, dv, -torch.ones_like(dv)),
                            torch.full_like(v, float("inf")))
        return torch.clamp(torch.amin(ratio, dim=-1), max=1.0)

    def body(d, s):
        x, s_l, s_u, z_l, z_u = (s[k] for k in ("x", "s_l", "s_u", "z_l",
                                                "z_u"))
        fl, fu, Cm = d["fl"], d["fu"], d["C"]
        Ct = Cm.transpose(1, 2)
        mu = ((fl * s_l * z_l).sum(1) + (fu * s_u * z_u).sum(1)) \
            / d["n_active"]
        r_dual, r_pl, r_pu = residuals(d, x, s_l, s_u, z_l, z_u)
        d_l = fl * z_l / torch.clamp(s_l, min=1e-12)
        d_u = fu * z_u / torch.clamp(s_u, min=1e-12)
        K = d["H"] + (Ct * (d_l + d_u)[:, None, :]) @ Cm \
            + settings.reg * eye
        # a factor that fails (not positive definite) poisons the lane's
        # step with NaN, which ends the lane as a failed Cholesky does in
        # the JAX package
        Lc, info = torch.linalg.cholesky_ex(K)
        Lc = torch.where((info == 0)[:, None, None], Lc,
                         torch.full_like(Lc, float("nan")))

        def newton_step(sigma_mu):
            """One condensed Newton solve for the target barrier
            sigma_mu (B,); the factor is the same for both steps."""
            rc_l = (sigma_mu[:, None] - s_l * z_l) / torch.clamp(s_l,
                                                                 min=1e-12)
            rc_u = (sigma_mu[:, None] - s_u * z_u) / torch.clamp(s_u,
                                                                 min=1e-12)
            w = fl * (rc_l - d_l * r_pl) - fu * (rc_u - d_u * r_pu)
            rhs = -r_dual + _mv(Ct, w)
            dx = torch.cholesky_solve(rhs[..., None], Lc)[..., 0]
            Cdx = _mv(Cm, dx)
            ds_l = Cdx + r_pl
            ds_u = -Cdx + r_pu
            return dx, ds_l, ds_u, rc_l - d_l * ds_l, rc_u - d_u * ds_u

        # predictor (affine) step
        dxa, dsla, dsua, dzla, dzua = newton_step(torch.zeros_like(mu))
        a_p = torch.minimum(max_alpha(s_l, dsla, fl),
                            max_alpha(s_u, dsua, fu))
        a_d = torch.minimum(max_alpha(z_l, dzla, fl),
                            max_alpha(z_u, dzua, fu))
        ap, ad = a_p[:, None], a_d[:, None]
        mu_aff = ((fl * (s_l + ap * dsla) * (z_l + ad * dzla)).sum(1)
                  + (fu * (s_u + ap * dsua) * (z_u + ad * dzua)).sum(1)) \
            / d["n_active"]
        sigma = torch.clamp((mu_aff / torch.clamp(mu, min=1e-14)) ** 3,
                            0.0, 1.0)

        # corrector step toward sigma * mu
        dx, ds_l, ds_u, dz_l, dz_u = newton_step(sigma * mu)
        a_p = torch.minimum(max_alpha(s_l, ds_l, fl),
                            max_alpha(s_u, ds_u, fu))[:, None]
        a_d = torch.minimum(max_alpha(z_l, dz_l, fl),
                            max_alpha(z_u, dz_u, fu))[:, None]
        x2 = x + a_p * dx
        one, nil = torch.ones_like(s_l), torch.zeros_like(s_l)
        s_l2 = torch.where(d["has_l"], s_l + a_p * ds_l, one)
        s_u2 = torch.where(d["has_u"], s_u + a_p * ds_u, one)
        z_l2 = torch.where(d["has_l"], z_l + a_d * dz_l, nil)
        z_u2 = torch.where(d["has_u"], z_u + a_d * dz_u, nil)
        conv = kkt_norm(d, x2, s_l2, s_u2, z_l2, z_u2) <= settings.eps
        finite = torch.isfinite(x2).all(1)
        x2 = torch.where(finite[:, None], x2, x)
        return {"x": x2, "s_l": s_l2, "s_u": s_u2, "z_l": z_l2, "z_u": z_u2,
                "it": s["it"] + 1, "done": conv | ~finite}

    while True:
        active = ~S["done"] & (S["it"] < settings.max_iter)
        idx = torch.nonzero(active).flatten()
        if idx.numel() == 0:
            break
        take = lambda t: t.index_select(0, idx)
        new = body({k: take(v) for k, v in D.items()},
                   {k: take(v) for k, v in S.items()})
        for k, v in new.items():
            S[k] = S[k].index_copy(0, idx, v)

    x, s_l, s_u, z_l, z_u = (S[k] for k in ("x", "s_l", "s_u", "z_l",
                                            "z_u"))
    res = kkt_norm(D, x, s_l, s_u, z_l, z_u)
    status = torch.where(res <= 10 * settings.eps, st.SOLVED,
                         torch.where(S["done"], st.UNSOLVED,
                                     st.MAX_ITER_EXCEEDED)).to(torch.int32)
    # net duals y = z_u - z_l per row, split general / box
    y_all = fu * z_u - fl * z_l
    r_dual, r_pl, r_pu = residuals(D, x, s_l, s_u, z_l, z_u)
    return QPSolution(
        x=x, y=y_all[:, :m], y_box=y_all[:, m:], status=status,
        iters=S["it"],
        res_prim=torch.maximum(_amax(torch.abs(r_pl)),
                               _amax(torch.abs(r_pu))),
        res_dual=_amax(torch.abs(r_dual)),
        rho=torch.zeros((B, m), dtype=dt, device=dev))
