"""Distributed constrained SQP for long-horizon OCPs (BASELINE config 5) —
the port of polympc_tpu/parallel/dist_sqp.py, batch-first.

Formulation: the duplicated-variable spectral-element form.  Every segment
s owns a private block w_s = [X_s ((p+1), nx); U_s ((p+1), nu)] including
its own copy of the interface node, glued by interface equality rows

    tail (x, u) of segment s  ==  head (x, u) of segment s+1.

Segment 0 imposes collocation defects at all p+1 of its nodes; segments
s >= 1 at nodes 1..p only (their head-node defect row is masked out), so
the duplicated NLP is exactly the fused boundary-sharing transcription with
interface variables duplicated and pinned by equalities.

Every lane solves its own problem: per-segment quantities are (B, S, ...),
parameters (B, np).  Derivatives are segment-local (``torch.func`` reverse
mode over one segment, vmapped over the B*S segments).  The inner boxADMM's
KKT has per-segment diagonal blocks, thin interface couplings and a global
parameter border; each ADMM epoch factors it once by Schur condensation
(parallel/horizon.py, whose per-segment inverses go through the
``ldlt_inverse`` kernel with ``kkt_solver="kernel"``) and runs
``check_every`` iterations of batched matvecs against it.  Given a
``torch.distributed`` device mesh, that factor (and each refine solve) is
split over the mesh's segment group while the SQP and ADMM state stay
whole, and alike, on every process of the group.

A lane stops when its own test passes: the SQP gathers the lanes still
running before every iteration and the inner ADMM before every epoch, so
each lane takes the iterations it would take alone (the JAX package freezes
finished lanes under ``vmap`` instead).  Every reduction of the JAX code
over one instance (norms, ``all``, sums) is here a reduction over every
axis but the lane axis.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch
from torch.func import grad, jacrev, vmap

from polympc_torch.basis.basis import Basis
from polympc_torch.ocp.ocp import OCP
from polympc_torch.parallel.horizon import (
    KKT_SOLVERS, schur_horizon_apply, schur_horizon_factor,
    schur_horizon_solve)
from polympc_torch.utils import status as st
from polympc_torch.utils.precision import full_precision

__all__ = ["DistTranscription", "DistBounds", "DistSQPSettings",
           "dist_transcribe", "dist_bounds", "dist_sqp_solve",
           "dist_refine", "dist_kkt_residual", "first_epoch_kkt",
           "fused_to_segments", "segments_to_fused"]


@dataclasses.dataclass(frozen=True)
class DistSQPSettings:
    """Settings of the distributed SQP and its inner ADMM (the JAX
    package's fields and defaults).

    admm_iters caps the inner iterations, run as epochs of check_every
    iterations on one Schur factorisation each, with residual checks,
    adaptive rho and infeasibility certificates between epochs.
    kkt_solver "kernel" inverts the per-segment KKT blocks with the
    unpivoted LDL^T kernel (ops.ldlt_inverse), "lu" with
    ``torch.linalg.inv``.  trace_iters > 0 records (cost, violation,
    primal_step, dual_step) for the first trace_iters SQP iterations.
    """
    max_iter: int = 30
    eps_prim: float = 1e-3
    eps_dual: float = 1e-3
    eps_viol: float = 1e-3
    eps_stat: float = 1e-3
    ls_max_iter: int = 9
    tau: float = 0.5
    eta: float = 1e-4
    merit_mu_safety: float = 1e2
    merit_mu_max: float = 1e6
    reg_eps: float = 1e-8
    rho: float = 0.1
    rho_eq_scale: float = 1e3
    rho_min: float = 1e-6
    rho_max: float = 1e6
    sigma: float = 1e-6
    alpha: float = 1.6
    admm_iters: int = 200
    check_every: int = 25
    eps_abs: float = 1e-6
    eps_rel: float = 1e-6
    # off by default inside the SQP, as in the JAX package: rho scaled up
    # on a certified-infeasible early linearisation inflates the duals that
    # warm-start the next QP
    adaptive_rho: bool = False
    eps_inf: float = 1e-5
    kkt_solver: str = "lu"
    loose_bound: float = 1e10
    eq_tol: float = 1e-4
    trace_iters: int = 0

    def validate(self) -> bool:
        return (self.max_iter > 0 and self.ls_max_iter > 0
                and 0 < self.tau < 1 and self.rho > 0 and self.sigma > 0
                and 0 < self.alpha < 2 and self.admm_iters > 0
                and self.check_every > 0 and self.trace_iters >= 0
                and self.kkt_solver in KKT_SOLVERS)


class DistBounds(NamedTuple):
    """Duplicated-segment bounds: lbw/ubw (S, kz) shared or (B, S, kz) per
    lane, lbp/ubp (np,) or (B, np), gl/gu (mg,) per-segment inequality
    row bounds."""
    lbw: torch.Tensor
    ubw: torch.Tensor
    lbp: torch.Tensor
    ubp: torch.Tensor
    gl: torch.Tensor
    gu: torch.Tensor


@dataclasses.dataclass(frozen=True)
class DistTranscription:
    """Static per-segment transcription data (the distributed analogue of
    ocp/transcription.py:Transcription).

    The ``seg_*`` functions act on ONE segment (w (kz,), P (np,), t_nodes
    (N,), d (nd,)); the solvers vmap them over every segment of every lane.
    """
    ocp: OCP
    basis: Basis
    S: int
    t0: float
    tf: float

    def __post_init__(self):
        if not (self.basis.has_left_endpoint
                and self.basis.has_right_endpoint):
            raise ValueError("segment duplication needs a Lobatto basis "
                             "(both endpoints in the node set)")

    @property
    def N(self) -> int:
        return self.basis.order + 1           # nodes per segment

    @property
    def kz(self) -> int:
        return self.N * (self.ocp.nx + self.ocp.nu)

    @property
    def me(self) -> int:
        return self.N * self.ocp.nx           # defect rows (head row masked)

    @property
    def mg(self) -> int:
        return self.N * self.ocp.ng

    @property
    def ml(self) -> int:
        return self.me + self.mg

    @property
    def p_if(self) -> int:
        return self.ocp.nx + self.ocp.nu      # interface rows (x and u glue)

    @property
    def t_scale(self) -> float:
        return (self.tf - self.t0) / (2.0 * self.S)

    @functools.cached_property
    def times(self) -> np.ndarray:
        tau = np.asarray(self.basis.nodes)
        L = (self.tf - self.t0) / self.S
        return np.stack([self.t0 + s * L + (tau + 1.0) * 0.5 * L
                         for s in range(self.S)])          # (S, N)

    @functools.cached_property
    def picks(self):
        """Interface picks E (tail of s), F (-head of s+1) on w = [X; U]."""
        N, nx, nu = self.N, self.ocp.nx, self.ocp.nu
        E = np.zeros((self.p_if, self.kz))
        F = np.zeros((self.p_if, self.kz))
        E[:nx, (N - 1) * nx:N * nx] = np.eye(nx)
        E[nx:, N * nx + (N - 1) * nu:] = np.eye(nu)
        F[:nx, :nx] = -np.eye(nx)
        F[nx:, N * nx:N * nx + nu] = -np.eye(nu)
        return E, F

    @functools.cached_property
    def _cache(self):
        return {}

    def _consts(self, dtype, device):
        """This transcription's constant tensors on a device: D and the
        quadrature weights of the basis, the node times (S, N), the picks E
        and F, the last-segment and head-mask rows.  Made once per (dtype,
        device), outside every ``torch.func`` transform (the solvers call
        this before they differentiate)."""
        key = (dtype, torch.device(device))
        c = self._cache.get(key)
        if c is None:
            t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,
                                          device=device)
            E, F = self.picks
            S = self.S
            c = {"D": t(self.basis.D), "w": t(self.basis.quad_weights),
                 "times": t(self.times), "E": t(E), "F": t(F),
                 "is_last": torch.arange(S, device=device) == S - 1,
                 "mask_head": t(np.arange(S) == 0)}
            self._cache[key] = c
        return c

    def split(self, w):
        N, nx = self.N, self.ocp.nx
        X = w[..., :N * nx].reshape(*w.shape[:-1], N, nx)
        U = w[..., N * nx:].reshape(*w.shape[:-1], N, self.ocp.nu)
        return X, U

    def pack(self, X, U):
        lead = X.shape[:-2]
        return torch.cat([X.reshape(*lead, -1), U.reshape(*lead, -1)],
                         dim=-1)

    # ---- per-segment problem functions (w_s (kz,), P (np,)) ----

    def seg_cost(self, w, Pv, t_nodes, is_last, d):
        ocp = self.ocp
        c = self._consts(w.dtype, w.device)
        X, U = self.split(w)
        val = None
        if ocp.lagrange is not None:
            Ls = vmap(lambda x, u, t: ocp.lagrange(x, u, Pv, d, t))(
                X, U, t_nodes)
            val = self.t_scale * (c["w"] @ Ls)
        if ocp.mayer is not None:
            m = ocp.mayer(X[-1], Pv, d)
            m = torch.where(is_last, m, torch.zeros_like(m))
            val = m if val is None else val + m
        return (X.sum() * 0.0) if val is None else val

    def seg_eq(self, w, Pv, t_nodes, mask_head, d):
        """Collocation defects at all N nodes; the head-node rows are
        multiplied by ``mask_head`` (0 for segments s >= 1, whose head
        defect is replaced by the interface continuity row)."""
        ocp = self.ocp
        X, U = self.split(w)
        f = vmap(lambda x, u, t: ocp.dynamics(x, u, Pv, d, t))(X, U, t_nodes)
        rows = self._consts(w.dtype, w.device)["D"] @ X - self.t_scale * f
        rows = torch.cat([rows[:1] * mask_head, rows[1:]])
        return rows.reshape(-1)

    def seg_ineq(self, w, Pv, t_nodes, d):
        ocp = self.ocp
        X, U = self.split(w)
        G = vmap(lambda x, u, t: ocp.ineq(x, u, Pv, d, t))(X, U, t_nodes)
        return G.reshape(-1)

    def seg_con(self, w, Pv, t_nodes, mask_head, d):
        c = self.seg_eq(w, Pv, t_nodes, mask_head, d)
        if self.ocp.ng:
            c = torch.cat([c, self.seg_ineq(w, Pv, t_nodes, d)])
        return c

    def initial_guess(self, x0):
        """Constant-state guess for each lane: x0 (B, nx) -> (W (B, S, kz),
        P (B, np)) of x0's dtype and device."""
        B = x0.shape[0]
        X = x0[:, None, None, :].expand(B, self.S, self.N, self.ocp.nx)
        U = x0.new_zeros((B, self.S, self.N, self.ocp.nu))
        return self.pack(X, U), x0.new_zeros((B, self.ocp.np_))

    def rollout_guess(self, x0, d=None, Pv=None, substeps: int = 4):
        """RK4 rollout of each lane's x0 (B, nx) through the whole time grid
        (zero controls), split into duplicated segments: (W (B, S, kz),
        P (B, np)).  The JAX package's per-instance ``rollout_guess``, step
        for step (every stage evaluated at the step's start time; a step
        across a segment boundary has length 0)."""
        ocp = self.ocp
        B = x0.shape[0]
        dt, dev = x0.dtype, x0.device
        d = x0.new_zeros((ocp.nd,)) if d is None else torch.as_tensor(
            d, dtype=dt, device=dev)
        Pv = x0.new_zeros((ocp.np_,)) if Pv is None else torch.as_tensor(
            Pv, dtype=dt, device=dev)
        u0 = x0.new_zeros((ocp.nu,))
        f = vmap(lambda x, t: ocp.dynamics(x, u0, Pv, d, t),
                 in_dims=(0, None))
        flat_t = self._consts(dt, dev)["times"].reshape(-1)
        xs = [x0]
        x = x0
        for j in range(flat_t.shape[0] - 1):
            t0_, t1_ = flat_t[j], flat_t[j + 1]
            h = (t1_ - t0_) / substeps
            for _ in range(substeps):
                k1 = f(x, t0_)
                k2 = f(x + 0.5 * h * k1, t0_)
                k3 = f(x + 0.5 * h * k2, t0_)
                k4 = f(x + h * k3, t0_)
                x = x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
            xs.append(x)
        X = torch.stack(xs, dim=1).reshape(B, self.S, self.N, ocp.nx)
        U = x0.new_zeros((B, self.S, self.N, ocp.nu))
        return self.pack(X, U), Pv[None].expand(B, ocp.np_).clone()


def dist_transcribe(ocp: OCP, basis: Basis, S: int, t0: float, tf: float
                    ) -> DistTranscription:
    if S < 2:
        raise ValueError(
            f"dist_transcribe needs S >= 2 segments to partition (got {S}); "
            "use the single-segment ocp.transcribe path for one segment")
    return DistTranscription(ocp=ocp, basis=basis, S=S, t0=float(t0),
                             tf=float(tf))


def dist_bounds(dtr: DistTranscription, xl=None, xu=None, ul=None, uu=None,
                pl=None, pu=None, gl=None, gu=None, x0=None,
                dtype=torch.float64, device="cuda") -> DistBounds:
    """Per-variable OCP bounds -> duplicated-segment box/row bounds, shared
    by all lanes (x0 pins segment 0's head state)."""
    inf = float("inf")
    ocp, N, S = dtr.ocp, dtr.N, dtr.S

    def fill(v, size, default):
        if v is None:
            return torch.full((size,), default, dtype=dtype, device=device)
        return torch.as_tensor(v, dtype=dtype, device=device)

    lbw = torch.cat([fill(xl, ocp.nx, -inf).repeat(N),
                     fill(ul, ocp.nu, -inf).repeat(N)])
    ubw = torch.cat([fill(xu, ocp.nx, inf).repeat(N),
                     fill(uu, ocp.nu, inf).repeat(N)])
    lbw = lbw[None].repeat(S, 1)
    ubw = ubw[None].repeat(S, 1)
    if x0 is not None:
        x0v = torch.as_tensor(x0, dtype=dtype, device=device)
        lbw[0, :ocp.nx] = x0v
        ubw[0, :ocp.nx] = x0v
    return DistBounds(lbw, ubw, fill(pl, ocp.np_, -inf),
                      fill(pu, ocp.np_, inf),
                      fill(gl, ocp.ng, -inf).repeat(N),
                      fill(gu, ocp.ng, inf).repeat(N))


# ---------------------------------------------------------------------------
# fused <-> duplicated layout converters (for parity tests and warm starts)
# ---------------------------------------------------------------------------

def _fused_index(dtr):
    p = dtr.basis.order
    return np.stack([np.arange(s * p, s * p + p + 1) for s in range(dtr.S)])


def fused_to_segments(dtr: DistTranscription, X, U):
    """Fused global grid (..., Ng, nx)/(..., Ng, nu) with Ng = p*S+1 ->
    duplicated (..., S, kz)."""
    idx = torch.as_tensor(_fused_index(dtr), device=X.device)
    return dtr.pack(X[..., idx, :], U[..., idx, :])


def segments_to_fused(dtr: DistTranscription, W):
    """Duplicated (..., S, kz) -> fused global grid (..., p*S+1, nx) and
    (..., p*S+1, nu), averaging the duplicated interface nodes."""
    idx = torch.as_tensor(_fused_index(dtr).reshape(-1), device=W.device)
    Ng = dtr.basis.order * dtr.S + 1

    def fuse(V):                                  # (..., S, N, n)
        lead = V.shape[:-3]
        flat = V.reshape(*lead, -1, V.shape[-1])
        out = V.new_zeros((*lead, Ng, V.shape[-1])).index_add_(
            len(lead), idx, flat)
        cnt = V.new_zeros(Ng).index_add_(0, idx, V.new_ones(idx.shape[0]))
        return out / cnt[:, None]
    X, U = dtr.split(W)
    return fuse(X), fuse(U)


# ---------------------------------------------------------------------------
# per-lane reductions and batched segment functions
# ---------------------------------------------------------------------------

def _amax(v):
    """Per-lane max |v| over every axis but the first (0 where empty)."""
    if v.numel() == 0:
        return v.new_zeros(v.shape[:1])
    return v.abs().reshape(v.shape[0], -1).amax(dim=1)


def _nmax(*vs):
    return functools.reduce(torch.maximum, [_amax(v) for v in vs])


def _lsum(v):
    return v.reshape(v.shape[0], -1).sum(dim=1)


def _lane(mask, like):
    """A per-lane mask (B,) shaped to broadcast against ``like``."""
    return mask.view(-1, *([1] * (like.dim() - 1)))


def _pick(mask, new, old):
    return torch.where(_lane(mask, new), new, old)


def _mv(A, v):
    return (A @ v[..., None])[..., 0]


def _d_of(dtr, d, dt, dev):
    if d is None:
        return torch.zeros((dtr.ocp.nd,), dtype=dt, device=dev)
    return torch.as_tensor(d, dtype=dt, device=dev)


def _flat_args(dtr, W, Pv):
    """Per-segment arguments over every (lane, segment): w (B*S, kz), P
    (B*S, np), times (B*S, N), is_last, mask_head (B*S,)."""
    B, S = W.shape[0], dtr.S
    c = dtr._consts(W.dtype, W.device)
    rep = lambda t: t[None].expand(B, *t.shape).reshape(B * S,
                                                        *t.shape[1:])
    return (W.reshape(B * S, -1),
            Pv[:, None, :].expand(B, S, Pv.shape[-1]).reshape(B * S, -1),
            rep(c["times"]), rep(c["is_last"]), rep(c["mask_head"]))


def _total_cost(dtr, W, Pv, d):
    w, P, t, il, _ = _flat_args(dtr, W, Pv)
    vals = vmap(lambda w_, p_, t_, i_: dtr.seg_cost(w_, p_, t_, i_, d))(
        w, P, t, il)
    return vals.reshape(W.shape[0], dtr.S).sum(dim=1)


def _all_con(dtr, W, Pv, d):
    w, P, t, _, mh = _flat_args(dtr, W, Pv)
    c = vmap(lambda w_, p_, t_, m_: dtr.seg_con(w_, p_, t_, m_, d))(
        w, P, t, mh)
    return c.reshape(W.shape[0], dtr.S, dtr.ml)


def _if_residual(dtr, W):
    c = dtr._consts(W.dtype, W.device)
    return W[:, :-1] @ c["E"].T + W[:, 1:] @ c["F"].T      # (B, S-1, p_if)


def _dist_parts(dtr: DistTranscription, W, Pv, d):
    """Per-segment gradient (B, S, kz+np), constraints (B, S, ml) and
    Jacobian (B, S, ml, kz+np) at (W, P), reverse mode."""
    B, S, kz = W.shape[0], dtr.S, dtr.kz
    w, P, t, il, mh = _flat_args(dtr, W, Pv)

    def one(w_, p_, t_, i_, m_):
        wp = torch.cat([w_, p_])
        cost = lambda v: dtr.seg_cost(v[:kz], v[kz:], t_, i_, d)
        con = lambda v: (lambda c: (c, c))(
            dtr.seg_con(v[:kz], v[kz:], t_, m_, d))
        J, c = jacrev(con, has_aux=True)(wp)
        return grad(cost)(wp), c, J

    g, c, J = vmap(one)(w, P, t, il, mh)
    return (g.reshape(B, S, -1), c.reshape(B, S, -1),
            J.reshape(B, S, dtr.ml, -1))


def _hess_blocks(dtr, W, Pv, lam_loc, d):
    """Per-segment Lagrangian Hessian blocks (B, S, kz+np, kz+np) over the
    joint (w_s, P), reverse over reverse mode."""
    B, S, kz = W.shape[0], dtr.S, dtr.kz
    w, P, t, il, mh = _flat_args(dtr, W, Pv)

    def one(w_, p_, t_, i_, m_, l_):
        def lagr(v):
            return (dtr.seg_cost(v[:kz], v[kz:], t_, i_, d)
                    + dtr.seg_con(v[:kz], v[kz:], t_, m_, d) @ l_)
        return jacrev(grad(lagr))(torch.cat([w_, p_]))

    H = vmap(one)(w, P, t, il, mh, lam_loc.reshape(B * S, -1))
    return H.reshape(B, S, *H.shape[1:])


def _row_bounds(dtr, bounds, B, dt, dev):
    """Local row bounds (B, ml): defects = 0 (masked rows read 0 = 0),
    inequalities [gl, gu]."""
    z = torch.zeros((dtr.me,), dtype=dt, device=dev)
    cl, cu = z, z
    if dtr.ocp.ng:
        cl = torch.cat([z, bounds.gl.to(dt)])
        cu = torch.cat([z, bounds.gu.to(dt)])
    return cl.expand(B, dtr.ml), cu.expand(B, dtr.ml)


def _lane_bounds(dtr, bounds, B, dt):
    """Box bounds per lane: lbw/ubw (B, S, kz), lbp/ubp (B, np)."""
    S, kz, np_ = dtr.S, dtr.kz, dtr.ocp.np_
    return (bounds.lbw.to(dt).expand(B, S, kz),
            bounds.ubw.to(dt).expand(B, S, kz),
            bounds.lbp.to(dt).expand(B, np_),
            bounds.ubp.to(dt).expand(B, np_))


# ---------------------------------------------------------------------------
# the distributed SQP
# ---------------------------------------------------------------------------

def _violation_l1(c_loc, cl, cu, r_if, W, lbw, ubw, Pv, lbp, ubp):
    """Per-lane l1 violation (merit term; ref sqp_base.hpp:423-474)."""
    vc = _lsum(torch.clamp(c_loc - cu[:, None], min=0.0)
               + torch.clamp(cl[:, None] - c_loc, min=0.0))
    vi = _lsum(torch.abs(r_if))
    vw = _lsum(torch.clamp(W - ubw, min=0.0) + torch.clamp(lbw - W, min=0.0))
    vp = _lsum(torch.clamp(Pv - ubp, min=0.0) + torch.clamp(lbp - Pv,
                                                           min=0.0))
    return vc + vi + vw + vp


def _violation_inf(c_loc, cl, cu, r_if, W, lbw, ubw, Pv, lbp, ubp):
    """Per-lane infinity-norm violation."""
    over = lambda v, lo, up: torch.maximum(torch.clamp(v - up, min=0.0),
                                           torch.clamp(lo - v, min=0.0))
    return _nmax(over(c_loc, cl[:, None], cu[:, None]), r_if,
                 over(W, lbw, ubw), over(Pv, lbp, ubp))


def _supp(b, v):
    """Per-lane sum b*v with the convention 0*inf = 0."""
    return _lsum(torch.where(v == 0.0, torch.zeros_like(v), b * v))


class _SegmentQP:
    """The segment-partitioned QP's operators on the lanes of one batch
    (Hs (B, S, kz, kz), HsP (B, S, kz, np), HPP (B, np, np), A (B, S, ml,
    kz), AP (B, S, ml, np), interface picks Ew, Fw (p_if, kz))."""

    def __init__(self, q, Ew, Fw, np_):
        self.q, self.Ew, self.Fw, self.np_ = q, Ew, Fw, np_

    def Hx(self, xW, xP):
        q = self.q
        hW = _mv(q["Hs"], xW)
        if self.np_:
            hW = hW + _mv(q["HsP"], xP[:, None, :])
            hP = torch.einsum("bska,bsk->ba", q["HsP"], xW) + _mv(q["HPP"],
                                                                 xP)
        else:
            hP = xP
        return hW, hP

    def Ax(self, xW, xP):
        ax = _mv(self.q["A"], xW)
        if self.np_:
            ax = ax + _mv(self.q["AP"], xP[:, None, :])
        return ax

    def if_of(self, xW):
        return xW[:, :-1] @ self.Ew.T + xW[:, 1:] @ self.Fw.T

    def ATy(self, y_loc, y_if, ybW, ybP):
        q = self.q
        pad = y_if.new_zeros((y_if.shape[0], 1, y_if.shape[2]))
        aty = (_mv(q["A"].transpose(-1, -2), y_loc)
               + torch.cat([y_if, pad], dim=1) @ self.Ew
               + torch.cat([pad, y_if], dim=1) @ self.Fw + ybW)
        if self.np_:
            atyP = torch.einsum("bsma,bsm->ba", q["AP"], y_loc) + ybP
        else:
            atyP = ybP
        return aty, atyP

    def residuals(self, xW, xP, z_loc, z_if, q_W, q_P, y_loc, y_if, ybW,
                  ybP):
        """OSQP primal/dual residuals and scales per lane (the distributed
        qp/box_admm.py:_residuals)."""
        q = self.q
        Ax = self.Ax(xW, xP)
        ifx = self.if_of(xW)
        r_prim = _nmax(Ax - z_loc, ifx - z_if, xW - q_W, xP - q_P)
        hW, hP = self.Hx(xW, xP)
        atyW, atyP = self.ATy(y_loc, y_if, ybW, ybP)
        r_dual = _nmax(hW + q["gW"] + atyW, hP + q["gP"] + atyP)
        prim_scale = _nmax(Ax, z_loc, ifx, xW, q_W, xP, q_P)
        dual_scale = _nmax(hW, hP, atyW, atyP, q["gW"], q["gP"], ybW, ybP)
        return r_prim, r_dual, prim_scale, dual_scale

    def certificates(self, dxW, dxP, dy_loc, dy_if, dybW, dybP, eps_inf):
        """OSQP section 3.4 infeasibility tests on the epoch increments, per
        lane (interface rows are equalities with value c_if_target)."""
        q = self.q
        nrm_y = _nmax(dy_loc, dy_if, dybW, dybP)
        atyW, atyP = self.ATy(dy_loc, dy_if, dybW, dybP)
        at_nrm = _nmax(atyW, atyP)
        pos = lambda v: torch.clamp(v, min=0.0)
        neg = lambda v: torch.clamp(v, max=0.0)
        supp = (_supp(q["au"], pos(dy_loc)) + _supp(q["al"], neg(dy_loc))
                + _supp(q["c_if"], dy_if)
                + _supp(q["uw"], pos(dybW)) + _supp(q["lw"], neg(dybW))
                + _supp(q["up"], pos(dybP)) + _supp(q["lp"], neg(dybP)))
        prim_inf = ((nrm_y > 0.0) & (at_nrm <= eps_inf * nrm_y)
                    & (supp <= -eps_inf * nrm_y))

        nrm_x = _nmax(dxW, dxP)
        tol = eps_inf * nrm_x
        hW, hP = self.Hx(dxW, dxP)
        gdx = _lsum(q["gW"] * dxW) + _lsum(q["gP"] * dxP)

        def cone_ok(v, lo, up):
            t = _lane(tol, v)
            ok = (torch.where(torch.isfinite(up), v <= t, True)
                  & torch.where(torch.isfinite(lo), v >= -t, True))
            return ok.reshape(ok.shape[0], -1).all(dim=1)

        dual_inf = ((nrm_x > 0.0) & (_nmax(hW, hP) <= tol) & (gdx <= -tol)
                    & cone_ok(self.Ax(dxW, dxP), q["al"], q["au"])
                    & (_amax(self.if_of(dxW)) <= tol)
                    & cone_ok(dxW, q["lw"], q["uw"])
                    & cone_ok(dxP, q["lp"], q["up"]))
        return prim_inf, dual_inf


def _as(settings_value, dt):
    """A setting rounded to the working dtype, as the JAX package's
    ``jnp.asarray(v, dt)`` constants are."""
    return float(torch.tensor(settings_value, dtype=dt))


def _epoch_kkt(q, rho_base, settings: DistSQPSettings):
    """The lanes' ADMM KKT for their base rho (B,): per-constraint
    penalties (box_admm.hpp:357-396: equality rows rho*rho_eq_scale, loose
    rows rho_min, all clipped), the per-segment blocks K (B, S, k, k)
    [[Hs + sigma I + diag(rbW), A'], [A, -diag(1/rho_loc)]], the interface
    diagonal G = -diag(1/rho_if) and, with parameters, the border C, Dg.
    Returns (K, G, C, Dg, rho_loc, rbW, rbP, rho_if)."""
    dt = q["gW"].dtype
    S, kz = q["gW"].shape[1], q["gW"].shape[2]
    p_if, np_ = q["c_if"].shape[2], q["gP"].shape[1]
    sigma = _as(settings.sigma, dt)
    rmin, rmax = settings.rho_min, settings.rho_max
    b = rho_base.shape[0]
    rho_eq = torch.clamp(rho_base * settings.rho_eq_scale, rmin, rmax)

    def rhos(eq, loose, like):
        base = _lane(rho_base, like).expand_as(like)
        out = torch.where(eq, _lane(rho_eq, like).expand_as(like),
                          torch.where(loose, torch.full_like(like, rmin),
                                      base))
        return torch.clamp(out, rmin, rmax)

    rho_loc = rhos(q["eq_row"], q["loose"], q["al"])
    rbW = rhos(q["boxW_eq"], q["boxW_loose"], q["lw"])
    rbP = rhos(q["boxP_eq"], q["boxP_loose"], q["lp"])
    rho_if = rho_eq[:, None, None].expand(b, 1, p_if)
    eye = torch.eye(kz, dtype=dt, device=rho_base.device)
    K = torch.cat([
        torch.cat([q["Hs"] + sigma * eye + torch.diag_embed(rbW),
                   q["A"].transpose(-1, -2)], dim=-1),
        torch.cat([q["A"], torch.diag_embed(-1.0 / rho_loc)], dim=-1),
    ], dim=-2)                                            # (b, S, k, k)
    G = torch.diag_embed(-1.0 / rho_if).expand(b, S - 1, p_if, p_if)
    C = Dg = None
    if np_:
        C = torch.cat([q["HsP"], q["AP"]], dim=-2)        # (b, S, k, np)
        Dg = (q["HPP"] + sigma * torch.eye(np_, dtype=dt, device=K.device)
              + torch.diag_embed(rbP))
    return K, G, C, Dg, rho_loc, rbW, rbP, rho_if


def _admm_epoch(dtr, q, s, settings, E, F, Ew, Fw, mesh, axis):
    """One epoch for the lanes of ``q``/``s``: the KKT for the lanes'
    current rho, one Schur factorisation, ``check_every`` iterations, the
    divergence guard, residuals, certificates and adaptive rho."""
    kz, np_ = dtr.kz, dtr.ocp.np_
    dt = q["gW"].dtype
    sigma, alpha = _as(settings.sigma, dt), _as(settings.alpha, dt)
    om = float(1.0 - torch.tensor(settings.alpha, dtype=dt))
    rmin, rmax = settings.rho_min, settings.rho_max
    rho_base = s["rho"]
    b = rho_base.shape[0]
    K, G, C, Dg, rho_loc, rbW, rbP, rho_if = _epoch_kkt(q, rho_base,
                                                        settings)
    fac = schur_horizon_factor(K, E, F, G=G, C=C, Dg=Dg,
                               kkt_solver=settings.kkt_solver, mesh=mesh,
                               axis=axis)

    xW, xP, zl, zi = s["xW"], s["xP"], s["zl"], s["zi"]
    qW, qP, yl, yi, ybW, ybP = (s[k] for k in ("qW", "qP", "yl", "yi",
                                               "ybW", "ybP"))
    lw, uw, lp, up, al, au, cift = (q[k] for k in ("lw", "uw", "lp", "up",
                                                   "al", "au", "c_if"))
    gW, gP = q["gW"], q["gP"]
    for _ in range(settings.check_every):
        rhs = torch.cat([sigma * xW + rbW * qW - ybW - gW,
                         zl - yl / rho_loc], dim=-1)      # (b, S, k)
        c_if = zi - yi / rho_if
        if np_:
            bg = sigma * xP + rbP * qP - ybP - gP
            w, nu_if, g_sol = schur_horizon_apply(fac, rhs, c_if, bg=bg)
        else:
            w, nu_if = schur_horizon_apply(fac, rhs, c_if)
            g_sol = xP
        xW_t, nu_loc = w[..., :kz], w[..., kz:]
        xW2 = alpha * xW_t + om * xW
        qW_u = alpha * xW_t + om * qW
        qW2 = torch.clamp(qW_u + ybW / rbW, min=lw, max=uw)
        ybW2 = ybW + rbW * (qW_u - qW2)
        if np_:
            xP2 = alpha * g_sol + om * xP
            qP_u = alpha * g_sol + om * qP
            qP2 = torch.clamp(qP_u + ybP / rbP, min=lp, max=up)
            ybP2 = ybP + rbP * (qP_u - qP2)
        else:
            xP2, qP2, ybP2 = xP, qP, ybP
        zl_u = alpha * (zl + (nu_loc - yl) / rho_loc) + om * zl
        zl2 = torch.clamp(zl_u + yl / rho_loc, min=al, max=au)
        yl2 = yl + rho_loc * (zl_u - zl2)
        zi_u = alpha * (zi + (nu_if - yi) / rho_if) + om * zi
        zi2 = torch.clamp(zi_u + yi / rho_if, min=cift, max=cift)
        yi2 = yi + rho_if * (zi_u - zi2)
        xW, xP, zl, zi, qW, qP = xW2, xP2, zl2, zi2, qW2, qP2
        yl, yi, ybW, ybP = yl2, yi2, ybW2, ybP2

    new = {"xW": xW, "xP": xP, "zl": zl, "zi": zi, "qW": qW, "qP": qP,
           "yl": yl, "yi": yi, "ybW": ybW, "ybP": ybP}
    # divergence guard: freeze a lane at its last finite state
    fin = lambda v: torch.isfinite(v).reshape(b, -1).all(dim=1)
    finite = (fin(xW) & fin(yl) & fin(yi) & fin(ybW) & fin(xP) & fin(ybP))
    new = {k: _pick(finite, v, s[k]) for k, v in new.items()}

    ops = _SegmentQP(q, Ew, Fw, np_)
    rp2, rd2, ps, ds = ops.residuals(*(new[k] for k in (
        "xW", "xP", "zl", "zi", "qW", "qP", "yl", "yi", "ybW", "ybP")))
    conv = ((rp2 <= settings.eps_abs + settings.eps_rel * ps)
            & (rd2 <= settings.eps_abs + settings.eps_rel * ds))
    div2 = s["div"] | ~finite
    pinf_new, dinf_new = ops.certificates(
        *(new[k] - s[k] for k in ("xW", "xP", "yl", "yi", "ybW", "ybP")),
        settings.eps_inf)
    pinf2 = s["pinf"] | (pinf_new & finite & ~conv)
    dinf2 = s["dinf"] | (dinf_new & finite & ~conv)
    rho_next = rho_base
    if settings.adaptive_rho:
        # rho <- rho * sqrt(relative primal / dual residual ratio)
        # (box_admm.hpp:433-445; OSQP eq. 28)
        num = rp2 / torch.clamp(ps, min=1e-12)
        den = rd2 / torch.clamp(ds, min=1e-12)
        scale = torch.clamp(torch.sqrt(num / torch.clamp(den, min=1e-12)),
                            1e-3, 1e3)
        rho_next = torch.clamp(rho_base * scale, rmin, rmax)
    new.update(rho=rho_next, epoch=s["epoch"] + 1,
               done=conv | div2 | pinf2 | dinf2, rp=rp2, rd=rd2, div=div2,
               pinf=pinf2, dinf=dinf2)
    return new


def _admm_data(Hs, HsP, HPP, gW, gP, A, AP, al, au, lw, uw, lp, up, r_if,
               settings: DistSQPSettings):
    """The inner QP's data per lane, with its row and box classes."""
    lb = settings.loose_bound
    return {"Hs": Hs, "HsP": HsP, "HPP": HPP, "gW": gW, "gP": gP, "A": A,
            "AP": AP, "al": al, "au": au, "lw": lw, "uw": uw, "lp": lp,
            "up": up, "c_if": -r_if,
            "eq_row": (au - al) < settings.eq_tol,
            "loose": (al < -lb) & (au > lb),
            "boxW_eq": (uw - lw) < settings.eq_tol,
            "boxW_loose": (lw < -lb) & (uw > lb),
            "boxP_eq": (up - lp) < settings.eq_tol,
            "boxP_loose": (lp < -lb) & (up > lb)}


def _dist_admm(dtr, Hs, HsP, HPP, gW, gP, A, AP, al, au, lw, uw, lp, up,
               r_if, y_loc0, y_if0, ybW0, ybP0, settings: DistSQPSettings,
               mesh=None, axis: str = "seg"):
    """Inner boxADMM on every lane's segment-partitioned QP (the
    distributed box_admm.hpp:88-205): epochs of ``check_every`` iterations
    on one Schur factorisation, residual-based termination, adaptive rho
    with per-epoch refactorisation, OSQP section 3.4 certificates.

    QP per lane: min 1/2 [dW;dP]' H [dW;dP] + g'[dW;dP]
        s.t. A_s dw_s + AP_s dP in [al_s, au_s]     (local rows, (S, ml))
             E dw_s + F dw_{s+1} = -r_if_s          (interface rows)
             lw <= dw <= uw,  lp <= dP <= up        (box)
    Shapes: Hs (B, S, kz, kz), HsP (B, S, kz, np), HPP (B, np, np),
    gW (B, S, kz), gP (B, np), A (B, S, ml, kz), AP (B, S, ml, np),
    al/au (B, S, ml), lw/uw (B, S, kz), lp/up (B, np), r_if (B, S-1, p_if).
    With a ``mesh`` each epoch's Schur factor is split over its ``axis``
    group (parallel/horizon.py); everything else runs alike on every
    process.  Returns (dW, dP, y_loc, y_if, ybW, ybP, iters, status, rp,
    rd), per lane.
    """
    S, kz, ml, p_if, np_ = dtr.S, dtr.kz, dtr.ml, dtr.p_if, dtr.ocp.np_
    B = gW.shape[0]
    dt, dev = gW.dtype, gW.device
    Epk, Fpk = dtr.picks
    Ew = torch.as_tensor(Epk, dtype=dt, device=dev)
    Fw = torch.as_tensor(Fpk, dtype=dt, device=dev)
    # interface picks on the KKT block w = [dw; nu_loc]
    E = torch.cat([Ew, Ew.new_zeros((p_if, ml))], dim=1)
    F = torch.cat([Fw, Fw.new_zeros((p_if, ml))], dim=1)
    data = _admm_data(Hs, HsP, HPP, gW, gP, A, AP, al, au, lw, uw, lp, up,
                      r_if, settings)
    zeros = lambda *shape: torch.zeros(shape, dtype=dt, device=dev)
    false = torch.zeros(B, dtype=torch.bool, device=dev)
    inf = torch.full((B,), float("inf"), dtype=dt, device=dev)
    s = {"xW": zeros(B, S, kz), "xP": zeros(B, np_), "zl": zeros(B, S, ml),
         "zi": zeros(B, S - 1, p_if), "qW": zeros(B, S, kz),
         "qP": zeros(B, np_), "yl": y_loc0, "yi": y_if0, "ybW": ybW0,
         "ybP": ybP0,
         "rho": torch.full((B,), settings.rho, dtype=dt, device=dev),
         "epoch": torch.zeros(B, dtype=torch.int32, device=dev),
         "done": false, "rp": inf, "rd": inf.clone(), "div": false.clone(),
         "pinf": false.clone(), "dinf": false.clone()}
    max_epochs = max(1, settings.admm_iters // settings.check_every)
    sub, n_sub = data, B
    while True:
        idx = torch.nonzero(~s["done"] & (s["epoch"] < max_epochs)).flatten()
        if idx.numel() == 0:
            break
        if idx.numel() != n_sub:         # lanes only ever leave the set
            sub = {k: v.index_select(0, idx) for k, v in data.items()}
            n_sub = idx.numel()
        old = {k: v.index_select(0, idx) for k, v in s.items()}
        new = _admm_epoch(dtr, sub, old, settings, E, F, Ew, Fw, mesh,
                          axis)
        for k, v in new.items():
            s[k] = s[k].index_copy(0, idx, v.to(s[k].dtype))

    status = torch.full((B,), st.MAX_ITER_EXCEEDED, dtype=torch.int32,
                        device=dev)
    status = torch.where(s["done"], st.SOLVED, status)
    status = torch.where(s["dinf"], st.INCONSISTENT, status)
    status = torch.where(s["pinf"], st.INFEASIBLE, status)
    status = torch.where(s["div"], st.UNSOLVED, status).to(torch.int32)
    iters = (s["epoch"] * settings.check_every).to(torch.int32)
    return (s["xW"], s["xP"], s["yl"], s["yi"], s["ybW"], s["ybP"], iters,
            status, s["rp"], s["rd"])


def _mirror(Hn, reg_eps):
    """Eigenvalue-mirror regularisation of each segment's joint block: the
    global Lagrangian Hessian is the sum of the lifted blocks, so mirroring
    each yields a PSD global model Hessian (hook of sqp_base.hpp:317)."""
    ev, V = torch.linalg.eigh(0.5 * (Hn + Hn.transpose(-1, -2)))
    ev = torch.clamp(torch.abs(ev), min=reg_eps)
    return (V * ev[..., None, :]) @ V.transpose(-1, -2)


def _dist_stationarity(dtr, g, J, lam_loc, lam_if, lam_bw, lam_bp):
    """Lagrangian gradient per lane: gl_W (B, S, kz), gl_P (B, np)."""
    kz, np_ = dtr.kz, dtr.ocp.np_
    c = dtr._consts(g.dtype, g.device)
    pad = lam_if.new_zeros((lam_if.shape[0], 1, dtr.p_if))
    gl_W = (g[..., :kz] + _mv(J[..., :kz].transpose(-1, -2), lam_loc)
            + torch.cat([lam_if, pad], dim=1) @ c["E"]
            + torch.cat([pad, lam_if], dim=1) @ c["F"] + lam_bw)
    if np_:
        gl_P = (g[..., kz:].sum(dim=1)
                + torch.einsum("bsma,bsm->ba", J[..., kz:], lam_loc)
                + lam_bp)
    else:
        gl_P = g.new_zeros((g.shape[0], 0))
    return gl_W, gl_P


def _start(dtr, bounds, W0, P0, d, lam_loc0=None, lam_if0=None,
           lam_bw0=None, lam_bp0=None):
    """The SQP's start state per lane (W0 clipped into the box, first-order
    parts at W0, zero or given duals), its bounds (cl, cu, lbw, ubw, lbp,
    ubp) and d as a tensor."""
    B, S, kz = W0.shape
    ml, np_, p_if = dtr.ml, dtr.ocp.np_, dtr.p_if
    dt, dev = W0.dtype, W0.device
    dtr._consts(dt, dev)
    d = _d_of(dtr, d, dt, dev)
    cl, cu = _row_bounds(dtr, bounds, B, dt, dev)
    lbw, ubw, lbp, ubp = _lane_bounds(dtr, bounds, B, dt)
    W0 = torch.clamp(W0, min=lbw, max=ubw)
    Pv0 = W0.new_zeros((B, np_)) if P0 is None else P0.to(dt)
    if np_:
        Pv0 = torch.clamp(Pv0, min=lbp, max=ubp)
    z = lambda *shape: torch.zeros(shape, dtype=dt, device=dev)
    inf = torch.full((B,), float("inf"), dtype=dt, device=dev)
    g0, c0, J0 = _dist_parts(dtr, W0, Pv0, d)
    s = {"W": W0, "P": Pv0,
         "lam_loc": z(B, S, ml) if lam_loc0 is None else lam_loc0.to(dt),
         "lam_if": z(B, S - 1, p_if) if lam_if0 is None else lam_if0.to(dt),
         "lam_bw": z(B, S, kz) if lam_bw0 is None else lam_bw0.to(dt),
         "lam_bp": z(B, np_) if lam_bp0 is None else lam_bp0.to(dt),
         "it": torch.zeros(B, dtype=torch.int32, device=dev),
         "done": torch.zeros(B, dtype=torch.bool, device=dev),
         "ps": inf, "ds": inf.clone(), "vi": inf.clone(),
         "qp_iters": torch.zeros(B, dtype=torch.int32, device=dev),
         "qp_status": torch.full((B,), st.UNINITIALIZED, dtype=torch.int32,
                                 device=dev),
         "g": g0, "c": c0, "J": J0}
    return s, (cl, cu, lbw, ubw, lbp, ubp), d


def _qp_args(dtr, s, cl, cu, lbw, ubw, lbp, ubp, d, settings):
    """The data of an SQP step's QP on the lanes of state ``s``: the
    mirrored Hessian blocks, the gradient and Jacobian split into segment
    and parameter parts, the row and box bounds shifted by the iterate
    (sqp_base.hpp:586-593) and the interface residual — the leading
    arguments of :func:`_dist_admm`."""
    kz = dtr.kz
    W, Pv, g, c, J = s["W"], s["P"], s["g"], s["c"], s["J"]
    Hn = _mirror(_hess_blocks(dtr, W, Pv, s["lam_loc"], d), settings.reg_eps)
    return (Hn[..., :kz, :kz], Hn[..., :kz, kz:],
            Hn[..., kz:, kz:].sum(dim=1), g[..., :kz], g[..., kz:].sum(dim=1),
            J[..., :kz], J[..., kz:], cl[:, None] - c, cu[:, None] - c,
            lbw - W, ubw - W, lbp - Pv, ubp - Pv, _if_residual(dtr, W))


@full_precision()
def first_epoch_kkt(dtr: DistTranscription, bounds: DistBounds, W0,
                    P0=None, d=None,
                    settings: DistSQPSettings = DistSQPSettings()):
    """The per-segment KKT blocks (B, S, k, k) that :func:`dist_sqp_solve`
    factors in the first epoch of its first QP from (W0, P0) with zero
    duals: the matrices its per-segment inverse meets first."""
    s, bnds, d = _start(dtr, bounds, W0, P0, d)
    q = _admm_data(*_qp_args(dtr, s, *bnds, d, settings), settings)
    rho = torch.full((W0.shape[0],), settings.rho, dtype=W0.dtype,
                     device=W0.device)
    return _epoch_kkt(q, rho, settings)[0]


@full_precision()
def dist_sqp_solve(dtr: DistTranscription, bounds: DistBounds, W0, P0=None,
                   d=None, settings: DistSQPSettings = DistSQPSettings(),
                   mesh=None, axis: str = "seg", lam_loc0=None,
                   lam_if0=None, lam_bw0=None, lam_bp0=None):
    """Solve a batch of duplicated-segment OCP NLPs with SQP + distributed
    boxADMM.

    W0 (B, S, kz): per-lane, per-segment primal start; P0 (B, np).
    bounds: a DistBounds, shared or per lane; d (nd,) shared.
    Returns a dict of per-lane results: W, P, duals (lam_loc, lam_if,
    lam_bw, lam_bp), status, iters, cost, primal_step, dual_step,
    violation, qp_iters, qp_status, and trace ((B, trace_iters, 4) or None).
    The SQP mirrors nlp/sqp.py: l1-merit fixed-trial line search, QP bounds
    shifted by the iterate (sqp_base.hpp:586-593), relative termination.
    With a ``mesh`` (a ``torch.distributed`` device mesh whose ``axis``
    group the segments split over, S a multiple of its size) the outer SQP
    and the ADMM state run alike on every process of the group and only
    the inner ADMM's Schur factor is split (the JAX package's
    ``shard_map`` path); every process returns the whole result.
    """
    if not settings.validate():
        raise ValueError("invalid settings")
    B = W0.shape[0]
    np_ = dtr.ocp.np_
    dt, dev = W0.dtype, W0.device
    s, (cl, cu, lbw, ubw, lbp, ubp), d = _start(
        dtr, bounds, W0, P0, d, lam_loc0, lam_if0, lam_bw0, lam_bp0)
    L, T = settings.ls_max_iter, settings.trace_iters
    alphas = settings.tau ** torch.arange(L, dtype=dt, device=dev)

    def merit_parts(W, Pv, cl, cu, lbw, ubw, lbp, ubp):
        c = _all_con(dtr, W, Pv, d)
        return (_total_cost(dtr, W, Pv, d),
                _violation_l1(c, cl, cu, _if_residual(dtr, W), W, lbw, ubw,
                              Pv, lbp, ubp))

    def body(s, cl, cu, lbw, ubw, lbp, ubp):
        W, Pv, lam_loc, lam_if, lam_bw, lam_bp = (s[k] for k in (
            "W", "P", "lam_loc", "lam_if", "lam_bw", "lam_bp"))
        b = W.shape[0]
        qp = _qp_args(dtr, s, cl, cu, lbw, ubw, lbp, ubp, d, settings)
        gW, gP = qp[3], qp[4]
        (dW, dP, yl_qp, yi_qp, ybw_qp, ybp_qp, qp_it, qp_st, _,
         _) = _dist_admm(dtr, *qp, lam_loc, lam_if, lam_bw, lam_bp, settings,
                         mesh, axis)
        fin = lambda v: torch.isfinite(v).reshape(b, -1).all(dim=1)
        ok = fin(dW) & fin(dP) & fin(yl_qp) & fin(yi_qp)
        dW = _pick(ok, dW, torch.zeros_like(dW))
        dP = _pick(ok, dP, torch.zeros_like(dP))
        yl_qp = _pick(ok, yl_qp, lam_loc)
        yi_qp = _pick(ok, yi_qp, lam_if)
        ybw_qp = _pick(ok, ybw_qp, lam_bw)
        ybp_qp = _pick(ok, ybp_qp, lam_bp)
        dW = torch.clamp(dW, min=lbw - W, max=ubw - W)
        if np_:
            dP = torch.clamp(dP, min=lbp - Pv, max=ubp - Pv)

        # l1-merit fixed-trial line search, every lane's ladder at once
        f0, v0 = merit_parts(W, Pv, cl, cu, lbw, ubw, lbp, ubp)
        dphi_f = _lsum(gW * dW) + _lsum(gP * dP)
        rep = lambda t: t.repeat_interleave(L, dim=0)
        a4 = alphas.repeat(b)
        trial_f, trial_v = merit_parts(
            rep(W) + _lane(a4, rep(W)) * rep(dW),
            rep(Pv) + a4[:, None] * rep(dP), rep(cl), rep(cu), rep(lbw),
            rep(ubw), rep(lbp), rep(ubp))
        trial_f, trial_v = trial_f.reshape(b, L), trial_v.reshape(b, L)
        inf = torch.full_like(trial_f, float("inf"))
        bad = torch.isnan(trial_f) | torch.isnan(trial_v)
        trial_f = torch.where(bad, inf, trial_f)
        trial_v = torch.where(bad, inf, trial_v)
        mu = torch.clamp(settings.merit_mu_safety
                         + _nmax(yl_qp, yi_qp, ybw_qp, ybp_qp),
                         max=settings.merit_mu_max)
        phi0 = f0 + mu * v0
        dphi = dphi_f - mu * v0
        phis = trial_f + mu[:, None] * trial_v
        okt = phis <= phi0[:, None] + settings.eta * alphas[None] * \
            dphi[:, None]
        first = torch.argmax(okt.to(torch.int32), dim=1)
        finite = torch.isfinite(phis)
        improve = (phis < phi0[:, None]) & finite
        best = torch.argmin(torch.where(improve, phis, inf), dim=1)
        smallest = L - 1 - torch.argmax(
            torch.flip(finite, [1]).to(torch.int32), dim=1)
        any_fin = finite.any(dim=1)
        fallback = torch.where(improve.any(dim=1), best,
                               torch.where(any_fin, smallest,
                                           torch.zeros_like(smallest)))
        alpha = alphas[torch.where(okt.any(dim=1), first, fallback)]
        alpha = torch.where(any_fin, alpha, torch.zeros_like(alpha))

        aW = _lane(alpha, W)
        W2 = W + aW * dW
        Pv2 = Pv + alpha[:, None] * dP
        lam_loc2 = lam_loc + aW * (yl_qp - lam_loc)
        lam_if2 = lam_if + aW * (yi_qp - lam_if)
        lam_bw2 = lam_bw + aW * (ybw_qp - lam_bw)
        lam_bp2 = lam_bp + alpha[:, None] * (ybp_qp - lam_bp)

        ps2 = _nmax(aW * dW, alpha[:, None] * dP)
        ds2 = _nmax(aW * (yl_qp - lam_loc), aW * (yi_qp - lam_if))
        g2, c2, J2 = _dist_parts(dtr, W2, Pv2, d)
        vi2 = _violation_inf(c2, cl, cu, _if_residual(dtr, W2), W2, lbw,
                             ubw, Pv2, lbp, ubp)
        gl_W, gl_P = _dist_stationarity(dtr, g2, J2, lam_loc2, lam_if2,
                                        lam_bw2, lam_bp2)
        stat = _nmax(gl_W, gl_P)
        lam_scale = torch.clamp(_nmax(lam_loc2, lam_if2, lam_bw2), min=1.0)
        conv = ((ps2 <= settings.eps_prim)
                & (ds2 <= settings.eps_dual * lam_scale)
                & (vi2 <= settings.eps_viol)
                & (stat <= settings.eps_stat * lam_scale))
        new = {"W": W2, "P": Pv2, "lam_loc": lam_loc2, "lam_if": lam_if2,
               "lam_bw": lam_bw2, "lam_bp": lam_bp2, "it": s["it"] + 1,
               "done": conv, "ps": ps2, "ds": ds2, "vi": vi2,
               "qp_iters": s["qp_iters"] + qp_it, "qp_status": qp_st,
               "g": g2, "c": c2, "J": J2}
        if T:
            row = torch.stack([_total_cost(dtr, W2, Pv2, d), vi2, ps2, ds2],
                              dim=1)
            rec = s["it"] < T
            slot = torch.clamp(s["it"], max=T - 1).long()
            tr = s["trace"].clone()
            cur = tr[torch.arange(b, device=dev), slot]
            tr[torch.arange(b, device=dev), slot] = torch.where(
                rec[:, None], row, cur)
            new["trace"] = tr
        return new

    if T:
        s["trace"] = torch.full((B, T, 4), float("nan"), dtype=dt,
                                device=dev)
    while True:
        idx = torch.nonzero(~s["done"] & (s["it"] < settings.max_iter)
                            ).flatten()
        if idx.numel() == 0:
            break
        take = lambda t: t.index_select(0, idx)
        new = body({k: take(v) for k, v in s.items()}, take(cl), take(cu),
                   take(lbw), take(ubw), take(lbp), take(ubp))
        for k, v in new.items():
            s[k] = s[k].index_copy(0, idx, v.to(s[k].dtype))

    status = torch.where(s["done"], st.SOLVED, st.MAX_ITER_EXCEEDED).to(
        torch.int32)
    return {"W": s["W"], "P": s["P"], "lam_loc": s["lam_loc"],
            "lam_if": s["lam_if"], "lam_bw": s["lam_bw"],
            "lam_bp": s["lam_bp"], "status": status, "iters": s["it"],
            "cost": _total_cost(dtr, s["W"], s["P"], d),
            "primal_step": s["ps"], "dual_step": s["ds"],
            "violation": s["vi"], "qp_iters": s["qp_iters"],
            "qp_status": s["qp_status"],
            "trace": s["trace"] if T else None}


# ---------------------------------------------------------------------------
# distributed KKT certification + refinement (the 1e-6 parity pass)
# ---------------------------------------------------------------------------

@full_precision()
def dist_kkt_residual(dtr: DistTranscription, bounds: DistBounds,
                      W, Pv, lam_loc, lam_if, lam_bw, lam_bp, d=None):
    """Unscaled KKT infinity norm of each lane's duplicated-segment NLP
    solution (conventions of nlp/refine.py:kkt_residual); (B,)."""
    B = W.shape[0]
    dt, dev = W.dtype, W.device
    dtr._consts(dt, dev)
    d = _d_of(dtr, d, dt, dev)
    cl, cu = _row_bounds(dtr, bounds, B, dt, dev)
    lbw, ubw, lbp, ubp = _lane_bounds(dtr, bounds, B, dt)
    g, c, J = _dist_parts(dtr, W, Pv, d)
    gl_W, gl_P = _dist_stationarity(dtr, g, J, lam_loc, lam_if, lam_bw,
                                    lam_bp)
    stat = _nmax(gl_W, gl_P)
    feas = _violation_inf(c, cl, cu, _if_residual(dtr, W), W, lbw, ubw, Pv,
                          lbp, ubp)

    def comp_term(v, lo, up, y):
        inf = torch.full_like(v, float("inf"))
        d_lo = torch.where(torch.isfinite(lo), v - lo, inf)
        d_up = torch.where(torch.isfinite(up), up - v, inf)
        dst = torch.minimum(torch.abs(d_lo), torch.abs(d_up))
        dst = torch.where(torch.isfinite(dst), dst, torch.zeros_like(dst))
        return _amax(torch.abs(y) * dst)

    comp = torch.maximum(comp_term(c, cl[:, None].expand_as(c),
                                   cu[:, None].expand_as(c), lam_loc),
                         comp_term(W, lbw, ubw, lam_bw))
    comp = torch.maximum(comp, comp_term(Pv, lbp, ubp, lam_bp))
    return torch.maximum(stat, torch.maximum(feas, comp))


@full_precision()
def dist_refine(dtr: DistTranscription, bounds: DistBounds,
                W, Pv, lam_loc, lam_if, lam_bw, lam_bp, d=None,
                iters: int = 2, act_tol: float = 1e-3, mesh=None,
                axis: str = "seg"):
    """Frozen-active-set Newton-KKT refinement of every lane.

    The refinement KKT (nlp/refine.py, symmetrised) has the segment-block +
    interface + parameter-border structure of the ADMM KKT, so every step
    is one :func:`schur_horizon_solve`.  Per-segment block w = [dz (kz);
    dlam_loc (ml); dlam_box (kz)]; interface unknowns are the continuity
    rows' Newton duals; the border is [dP; dlam_box_P].  Inactive-row duals
    are zeroed up front so the masked coupling is exact and the KKT stays
    symmetric.  A lane keeps the refined point only if its KKT residual did
    not grow.  With a ``mesh`` every solve splits its segments over the
    ``axis`` group (:func:`schur_horizon_solve`).  Returns (W, P, lam_loc,
    lam_if, lam_bw, lam_bp).
    """
    ocp = dtr.ocp
    B, S, kz = W.shape
    ml, np_, p_if = dtr.ml, ocp.np_, dtr.p_if
    dt, dev = W.dtype, W.device
    cst = dtr._consts(dt, dev)
    d = _d_of(dtr, d, dt, dev)
    cl, cu = _row_bounds(dtr, bounds, B, dt, dev)
    lbw, ubw, lbp, ubp = _lane_bounds(dtr, bounds, B, dt)
    k = kz + ml + kz
    Ew = torch.cat([cst["E"], cst["E"].new_zeros((p_if, k - kz))], dim=1)
    Fw = torch.cat([cst["F"], cst["F"].new_zeros((p_if, k - kz))], dim=1)
    delta = 1e-10
    fin0 = lambda v: torch.where(torch.isfinite(v), v, torch.zeros_like(v))

    # frozen active sets
    _, c0, _ = _dist_parts(dtr, W, Pv, d)
    clb, cub = cl[:, None], cu[:, None]
    alo_c = c0 - clb <= act_tol
    aup_c = cub - c0 <= act_tol
    ac = (alo_c | aup_c).to(dt)                           # (B, S, ml)
    b_c = fin0(torch.where(alo_c, clb.expand_as(c0), cub.expand_as(c0)))
    alo_x = (W - lbw) <= act_tol
    aup_x = (ubw - W) <= act_tol
    ax = (alo_x | aup_x).to(dt)                           # (B, S, kz)
    b_x = fin0(torch.where(alo_x, lbw, ubw))
    alo_p = (Pv - lbp) <= act_tol
    aup_p = (ubp - Pv) <= act_tol
    ap = (alo_p | aup_p).to(dt)                           # (B, np)
    b_p = fin0(torch.where(alo_p, lbp, ubp))

    # zero inactive duals so the masked coupling is exact
    lam_loc = ac * lam_loc
    lam_bw = ax * lam_bw
    lam_bp = ap * lam_bp
    # row "mass": active rows the tiny -delta, inactive rows -1 (pinning
    # their dual step to the zeroed dual)
    one = lambda m: torch.where(m > 0, torch.full_like(m, delta),
                                torch.ones_like(m))
    dm_c, dm_x, dm_p = one(ac), one(ax), one(ap)
    eye_kz = torch.eye(kz, dtype=dt, device=dev)
    G = (-delta * torch.eye(p_if, dtype=dt, device=dev)).expand(
        B, S - 1, p_if, p_if)

    carry = (W, Pv, lam_loc, lam_if, lam_bw, lam_bp)
    for _ in range(iters):
        Wc, Pc, llc, lic, lbc, lpc = carry
        g, c, J = _dist_parts(dtr, Wc, Pc, d)
        A, AP = J[..., :kz], J[..., kz:]
        Hn = _hess_blocks(dtr, Wc, Pc, llc, d)
        Hs = Hn[..., :kz, :kz] + delta * eye_kz
        gl_W, gl_P = _dist_stationarity(dtr, g, J, llc, lic, lbc, lpc)
        r_if = _if_residual(dtr, Wc)
        r_c = ac * (c - b_c) + (1.0 - ac) * llc
        r_x = ax * (Wc - b_x) + (1.0 - ax) * lbc
        acA = ac[..., None] * A
        Dx = torch.diag_embed(ax)
        Kb = torch.cat([
            torch.cat([Hs, acA.transpose(-1, -2), Dx], dim=-1),
            torch.cat([acA, -torch.diag_embed(dm_c),
                       A.new_zeros((B, S, ml, kz))], dim=-1),
            torch.cat([Dx, A.new_zeros((B, S, kz, ml)),
                       -torch.diag_embed(dm_x)], dim=-1),
        ], dim=-2)                                        # (B, S, k, k)
        rhs = torch.cat([-gl_W, -r_c, -r_x], dim=-1)      # (B, S, k)
        if np_:
            C = torch.cat([
                torch.cat([Hn[..., :kz, kz:], A.new_zeros((B, S, kz, np_))],
                          dim=-1),
                torch.cat([ac[..., None] * AP,
                           A.new_zeros((B, S, ml, np_))], dim=-1),
                A.new_zeros((B, S, kz, 2 * np_)),
            ], dim=-2)                                    # (B, S, k, 2np)
            HPP = Hn[..., kz:, kz:].sum(dim=1)
            Dap = torch.diag_embed(ap)
            Dg = torch.cat([
                torch.cat([HPP + delta * torch.eye(np_, dtype=dt,
                                                   device=dev), Dap], dim=-1),
                torch.cat([Dap, -torch.diag_embed(dm_p)], dim=-1),
            ], dim=-2)
            r_p = ap * (Pc - b_p) + (1.0 - ap) * lpc
            w, nu_if, g_sol = schur_horizon_solve(
                Kb, rhs, Ew, Fw, -r_if, G=G, C=C, Dg=Dg,
                bg=torch.cat([-gl_P, -r_p], dim=-1), mesh=mesh, axis=axis)
            dP, dlbp = g_sol[:, :np_], g_sol[:, np_:]
        else:
            w, nu_if = schur_horizon_solve(Kb, rhs, Ew, Fw, -r_if, G=G,
                                           mesh=mesh, axis=axis)
            dP = dlbp = Pc.new_zeros((B, 0))
        fin = lambda v: torch.isfinite(v).reshape(B, -1).all(dim=1)
        ok = fin(w) & fin(nu_if) & fin(dP)
        upd = lambda old, dlt: _pick(ok, old + dlt, old)
        W2 = torch.clamp(upd(Wc, w[..., :kz]), min=lbw, max=ubw)
        P2 = torch.clamp(upd(Pc, dP), min=lbp, max=ubp) if np_ else Pc
        carry = (W2, P2, upd(llc, w[..., kz:kz + ml]), upd(lic, nu_if),
                 upd(lbc, w[..., kz + ml:]),
                 upd(lpc, dlbp) if np_ else lpc)

    # accept only if the true KKT error did not grow
    start = (W, Pv, lam_loc, lam_if, lam_bw, lam_bp)
    r0 = dist_kkt_residual(dtr, bounds, *start, d=d)
    r1 = dist_kkt_residual(dtr, bounds, *carry, d=d)
    keep = r1 <= r0
    return tuple(_pick(keep, a, b) for a, b in zip(carry, start))
