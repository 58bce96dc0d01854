"""Long-horizon OCP solving: per-segment transcription + distributed Newton
steps through :func:`polympc_torch.parallel.horizon.schur_horizon_solve`
— the port of polympc_tpu/parallel/long_horizon.py, batch-first.

The reference can only grow the horizon through its compile-time segment
count inside one process (splines.hpp:33, continuous_ocp.hpp:313-339).  Here
the horizon is partitioned into S segments with *duplicated* interface
states: each segment builds its local Newton KKT independently (all
derivative work is segment-local), and the segments are glued by
continuity constraints condensed onto the small interface system.  With a
``torch.distributed`` device mesh each process builds only its own
segments' blocks and the Schur solve gathers the condensed blocks over the
mesh's ``axis`` group.

Equality-constrained form (dynamics defects only); bounds/inequalities ride
the outer SQP/ADMM layers, this module provides the Newton engine.

Per segment s over [t_s, t_{s+1}] with basis nodes tau_k:
  variables  w_s = [X_s (N, nx); U_s (N, nu)] flattened, N = order+1
  defects    D X_s - t_scale f(X_s, U_s) = 0
  cost       sum_k t_scale w_k L(x_k, u_k) (+ Mayer on the last segment)
  Newton KKT [[H_s, A_s'], [A_s, -delta I]] [dz; lam+] = [-grad_s; -defect_s]
  continuity x_tail(s) - x_head(s+1) = 0 handled by the Schur interface.

Batch-first: ``Z`` is (S, nz) as in the JAX package or (B, S, nz) with a
leading lane axis (the JAX package's ``jax.vmap``), ``x0`` then (nx,) or
(B, nx); lane b gives what a call on lane b alone gives, and an unbatched
call returns the JAX package's shapes.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import grad, jacfwd, vmap

from polympc_torch.basis.basis import Basis
from polympc_torch.ocp.ocp import OCP
from polympc_torch.parallel.horizon import _segments, schur_horizon_solve
from polympc_torch.utils.precision import full_precision

__all__ = ["LongHorizon", "long_horizon_newton_step", "solve_long_horizon"]

# the weight of the quadratic pin of segment 0's head state to x0
PIN_WEIGHT = 1e6


class LongHorizon:
    """Static description of the partitioned problem (shapes, pick
    matrices), numpy-side.

    basis: single-segment basis (e.g. Chebyshev(5)); S segments over
    [t0, tf] of equal length.
    """

    def __init__(self, ocp: OCP, basis: Basis, S: int, t0: float, tf: float,
                 reg: float = 1e-8, delta: float = 1e-8):
        if ocp.np_:
            raise NotImplementedError(
                "global parameters are not supported in the partitioned "
                "horizon yet (the parameter arrow couples all segments)")
        self.ocp, self.basis, self.S = ocp, basis, S
        self.t0, self.tf = float(t0), float(tf)
        self.reg, self.delta = reg, delta
        self.N = basis.order + 1
        self.nx, self.nu = ocp.nx, ocp.nu
        self.nz = self.N * (self.nx + self.nu)
        self.ne = self.N * self.nx
        self.k = self.nz + self.ne          # per-segment KKT size
        self.D = np.asarray(basis.D)                      # (N, N) on [-1, 1]
        self.w = np.asarray(basis.quad_weights)           # (N,)
        self.t_scale = (self.tf - self.t0) / (2.0 * S)
        tau = np.asarray(basis.nodes)
        seg_len = (self.tf - self.t0) / S
        self.times = np.stack([
            self.t0 + s * seg_len + (tau + 1.0) * 0.5 * seg_len
            for s in range(S)])                           # (S, N)
        # interface picks on w = [dz; lam]: tail state of s vs head of s+1
        E = np.zeros((self.nx, self.k))
        F = np.zeros((self.nx, self.k))
        E[:, (self.N - 1) * self.nx:self.N * self.nx] = np.eye(self.nx)
        F[:, :self.nx] = -np.eye(self.nx)
        self.E, self.F = E, F
        self._cache = {}

    def split(self, z):
        X = z[..., :self.ne].reshape(*z.shape[:-1], self.N, self.nx)
        U = z[..., self.ne:].reshape(*z.shape[:-1], self.N, self.nu)
        return X, U

    def pack(self, X, U):
        lead = X.shape[:-2]
        return torch.cat([X.reshape(*lead, -1), U.reshape(*lead, -1)],
                         dim=-1)

    def initial_guess(self, x0, dtype=torch.float64, device="cuda"):
        """x0 tiled over every node of every segment, zero controls:
        (S, nz) for x0 (nx,), (B, S, nz) for x0 (B, nx)."""
        x0 = torch.as_tensor(x0, dtype=dtype, device=device)
        lead = x0.shape[:-1]
        X = x0[..., None, None, :].expand(*lead, self.S, self.N, self.nx)
        U = x0.new_zeros((*lead, self.S, self.N, self.nu))
        return self.pack(X, U)

    def _const(self, name, like):
        """The numpy constant ``name`` (D, w, times) as a tensor like
        ``like``, made once per (dtype, device) and outside every
        ``torch.func`` transform."""
        key = (name, like.dtype, like.device)
        t = self._cache.get(key)
        if t is None:
            t = torch.as_tensor(getattr(self, name), dtype=like.dtype,
                                device=like.device)
            self._cache[key] = t
        return t


def _segment_cost(lh: LongHorizon, z, t_nodes, is_last, d, w):
    """One segment's cost: t_scale w @ L over its nodes, plus the Mayer term
    where ``is_last`` (a 0-dim bool)."""
    ocp = lh.ocp
    X, U = lh.split(z)
    p = z.new_zeros((0,))
    val = z.new_zeros(())
    if ocp.lagrange is not None:
        Ls = vmap(lambda x, u, t: ocp.lagrange(x, u, p, d, t))(X, U, t_nodes)
        val = val + lh.t_scale * (w @ Ls.to(z.dtype))
    if ocp.mayer is not None:
        val = val + torch.where(is_last, ocp.mayer(X[-1], p, d).to(z.dtype),
                                z.new_zeros(()))
    return val


def _segment_defects(lh: LongHorizon, z, t_nodes, d, D):
    """One segment's collocation defects D X - t_scale f(X, U), (ne,)."""
    ocp = lh.ocp
    X, U = lh.split(z)
    p = z.new_zeros((0,))
    fX = vmap(lambda x, u, t: ocp.dynamics(x, u, p, d, t))(X, U, t_nodes)
    return (D @ X - lh.t_scale * fX.to(z.dtype)).reshape(-1)


def _segment_kkt(lh: LongHorizon, z, lam, t_nodes, is_last, d, D, w):
    """One segment's Newton derivatives: the cost gradient g (nz,), the
    defects c (ne,), their Jacobian A (ne, nz) and the Lagrangian Hessian H
    (nz, nz), by ``torch.func`` on this segment alone."""
    cost = lambda zz: _segment_cost(lh, zz, t_nodes, is_last, d, w)
    con = lambda zz: _segment_defects(lh, zz, t_nodes, d, D)
    g = grad(cost)(z)
    c = con(z)
    A = jacfwd(con)(z)
    H = jacfwd(grad(lambda zz: cost(zz) + con(zz) @ lam))(z)
    return g, c, A, H


def _blocks(lh: LongHorizon, Z, LAM, x0, d, lo, hi):
    """The Newton KKT blocks K (B, hi-lo, k, k) and right-hand sides b
    (B, hi-lo, k) of segments lo .. hi-1 of every lane: the JAX package's
    ``_segment_kkt`` recipe (symmetrise H, add reg I, the Gershgorin shift
    of each segment's own H, the pin of segment 0's head state to x0 on H
    and g, then [[H, A'], [A, -delta I]])."""
    B, dt = Z.shape[0], Z.dtype
    n = hi - lo
    nz, ne, nx = lh.nz, lh.ne, lh.nx
    D, w = lh._const("D", Z), lh._const("w", Z)
    times = lh._const("times", Z)[lo:hi]
    seg = torch.arange(lo, hi, device=Z.device)
    is_last = (seg == lh.S - 1)[None].expand(B, n).reshape(-1)
    nd = d.shape[-1]
    g, c, A, H = vmap(
        lambda z, lam, t, il, dd: _segment_kkt(lh, z, lam, t, il, dd, D, w))(
        Z[:, lo:hi].reshape(B * n, nz), LAM[:, lo:hi].reshape(B * n, ne),
        times[None].expand(B, n, lh.N).reshape(B * n, lh.N), is_last,
        d.expand(B, nd)[:, None].expand(B, n, nd).reshape(B * n, nd))
    g, c = g.to(dt).reshape(B, n, nz), c.to(dt).reshape(B, n, ne)
    A, H = A.to(dt).reshape(B, n, ne, nz), H.to(dt).reshape(B, n, nz, nz)
    eye = torch.eye(nz, dtype=dt, device=Z.device)
    H = 0.5 * (H + H.transpose(-1, -2)) + lh.reg * eye
    # Gershgorin shift keeps the reduced Hessian PD enough for Newton
    dg = torch.diagonal(H, dim1=-2, dim2=-1)
    radii = torch.sum(torch.abs(H), dim=-1) - torch.abs(dg)
    shift = torch.clamp(-(torch.amin(dg - radii, dim=-1)) + 1e-8, min=0.0)
    H = H + shift[..., None, None] * eye
    if lo == 0:
        # segment 0 pins its head state to x0 by a quadratic penalty
        head = torch.arange(nx, device=Z.device)
        H[:, 0, head, head] += PIN_WEIGHT
        g[:, 0, :nx] += PIN_WEIGHT * (Z[:, 0, :nx] - x0)
    K = Z.new_zeros((B, n, lh.k, lh.k))
    K[..., :nz, :nz] = H
    K[..., :nz, nz:] = A.transpose(-1, -2)
    K[..., nz:, :nz] = A
    K[..., nz:, nz:] = -lh.delta * torch.eye(ne, dtype=dt, device=Z.device)
    return K, torch.cat([-g, -c], dim=-1)


def _lanes(Z, LAM, x0, d, lh):
    """Batch-first views: (Z (B, S, nz), LAM (B, S, ne), x0 (B, nx),
    d (nd,) or (B, nd), batched?)."""
    batched = Z.dim() == 3
    if not batched:
        Z, LAM = Z[None], LAM[None]
    x0 = torch.as_tensor(x0, dtype=Z.dtype, device=Z.device)
    x0 = x0.expand(Z.shape[0], lh.nx)
    if d is None:
        d = Z.new_zeros((lh.ocp.nd,))
    d = torch.as_tensor(d, dtype=Z.dtype, device=Z.device)
    return Z, LAM, x0, d, batched


@full_precision()
def long_horizon_newton_step(lh: LongHorizon, Z, LAM, x0, d=None, mesh=None,
                             axis: str = "seg"):
    """One full-space Newton step on the partitioned horizon.

    Z (S, nz) or (B, S, nz), LAM (S, ne) or (B, S, ne) current primal/dual
    iterates; x0 (nx,) or (B, nx) the initial state; d (nd,) or (B, nd)
    the OCP's static data (zeros when None).  With ``mesh`` (a ``torch.distributed``
    device mesh, :func:`~polympc_torch.parallel.horizon.horizon_mesh`) this
    process builds only its own consecutive segments' blocks (S a multiple
    of the ``axis`` group's size) and every process returns the whole
    step.  Returns (Z_new, LAM_new, continuity residual (S-1, nx) of the
    input iterate), each with Z's lane axis.
    """
    Z, LAM, x0, d, batched = _lanes(Z, LAM, x0, d, lh)
    B, S = Z.shape[0], lh.S
    _, lo, hi = _segments(mesh, axis, S)
    K_loc, b_loc = _blocks(lh, Z, LAM, x0, d, lo, hi)
    if (lo, hi) == (0, S):
        K, b = K_loc, b_loc
    else:
        K = Z.new_zeros((B, S, lh.k, lh.k))
        b = Z.new_zeros((B, S, lh.k))
        K[:, lo:hi], b[:, lo:hi] = K_loc, b_loc
    X, _ = lh.split(Z)
    cont = X[:, :-1, -1, :] - X[:, 1:, 0, :]        # (B, S-1, nx) residual
    # interface rows act on dz only: E dz_s + F dz_{s+1} = -cont
    Ew = np.zeros((lh.nx, lh.k))
    Fw = np.zeros((lh.nx, lh.k))
    Ew[:, :lh.nz], Fw[:, :lh.nz] = lh.E[:, :lh.nz], lh.F[:, :lh.nz]
    w, _ = schur_horizon_solve(K, b, Ew, Fw, -cont, mesh=mesh, axis=axis)
    Z_new, LAM_new = Z + w[..., :lh.nz], w[..., lh.nz:]
    if not batched:
        return Z_new[0], LAM_new[0], cont[0]
    return Z_new, LAM_new, cont


def _defect_norm(lh: LongHorizon, Z, d):
    """max |defect| of each lane (B,) over all its segments."""
    B, S, nd = Z.shape[0], lh.S, d.shape[-1]
    D, times = lh._const("D", Z), lh._const("times", Z)
    c = vmap(lambda z, t, dd: _segment_defects(lh, z, t, dd, D))(
        Z.reshape(B * S, lh.nz),
        times[None].expand(B, S, lh.N).reshape(B * S, lh.N),
        d.expand(B, nd)[:, None].expand(B, S, nd).reshape(B * S, nd))
    return torch.amax(torch.abs(c.reshape(B, -1)), dim=-1)


@full_precision()
def solve_long_horizon(lh: LongHorizon, x0, iters: int = 10, d=None,
                       mesh=None, Z0=None, dtype=torch.float64,
                       device="cuda"):
    """Run ``iters`` damped Newton steps from a constant initial guess.

    x0 (nx,) or (B, nx): one problem, or B lanes solved together.  A lane
    whose new defect norm is not finite takes half its step instead, as in
    the JAX package.  Returns (Z, LAM, hist): hist lists per iteration
    {"defect": max |defect|, "continuity": max |continuity residual| of the
    step's input iterate}, floats for an unbatched call and per-lane numpy
    arrays (B,) for a batch.  One host sync per iteration (the damping
    test).
    """
    x0 = torch.as_tensor(x0, dtype=dtype, device=device)
    batched = x0.dim() == 2
    Z = lh.initial_guess(x0, dtype, device) if Z0 is None else \
        torch.as_tensor(Z0, dtype=dtype, device=device)
    Z, LAM, x0, d, _ = _lanes(
        Z if batched else Z.reshape(lh.S, lh.nz),
        Z.new_zeros((*Z.shape[:-1], lh.ne)), x0, d, lh)
    defects, conts = [], []
    for _ in range(iters):
        Z2, LAM2, cont = long_horizon_newton_step(lh, Z, LAM, x0, d,
                                                  mesh=mesh)
        dn = _defect_norm(lh, Z2, d)
        blown = ~torch.isfinite(dn)
        if bool(blown.any()):
            # simple fraction-to-the-boundary damping on blow-ups
            m = blown[:, None, None]
            Z2 = torch.where(m, 0.5 * (Z + Z2), Z2)
            LAM2 = torch.where(m, 0.5 * (LAM + LAM2), LAM2)
            dn = torch.where(blown, _defect_norm(lh, Z2, d), dn)
        Z, LAM = Z2, LAM2
        defects.append(dn)
        conts.append(torch.amax(torch.abs(cont.reshape(cont.shape[0], -1)),
                                dim=-1))
    defects = torch.stack(defects).cpu().numpy() if iters else \
        np.zeros((0, Z.shape[0]))
    conts = torch.stack(conts).cpu().numpy() if iters else defects
    if batched:
        hist = [{"defect": defects[i], "continuity": conts[i]}
                for i in range(iters)]
        return Z, LAM, hist
    hist = [{"defect": float(defects[i, 0]),
             "continuity": float(conts[i, 0])} for i in range(iters)]
    return Z[0], LAM[0], hist
