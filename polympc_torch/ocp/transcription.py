"""Pseudospectral collocation transcription: OCP -> batch-first NLP.

The port of polympc_tpu/ocp/transcription.py.  The decision vector of one
lane is z = [X (N*nx); U (N*nu); P (np_)] in forward time order, in scaled
units (physical = scale * z).  Every NLP callable takes z (B, n): the OCP's
per-node functions run over all B*N nodes at once with
``torch.func.vmap``, and derivatives are per node (``torch.func.jacrev`` /
``grad`` over one node's (x, u, P)), assembled into the block structure of
the collocation NLP — never a whole-vector dense Jacobian by AD:

  eq Jacobian   = kron(Dg, I_nx) - blockdiag(scale * df/d(x,u)) + P column
                  [+ the constant continuity rows of a Radau mesh];
  Lagrangian Hessian = per-node (x_k, u_k, P) blocks, block-diagonal + P
  arrow (the cross-node coupling Dg is linear and adds no curvature).

Trajectory-level hooks and a Mayer term at an interpolated endpoint couple
nodes; their Hessian and Jacobian rows are whole-trajectory AD added on top
of the blocks, as the JAX package does.  The parameter dict is
{"p": (np_,), "d": (nd,), "t0": 0-dim, "tf": 0-dim}, shared by all lanes.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch.func import grad, jacrev, vmap

from polympc_torch.basis.basis import SegmentedBasis
from polympc_torch.nlp.types import NLP, NLPBounds
from polympc_torch.ocp.ocp import OCP
from polympc_torch.utils.solver_utils import block_diag_scatter
from polympc_torch.utils.timing import count, span

__all__ = ["Transcription", "transcribe", "ocp_bounds", "split_z", "pack_z",
           "SpectralOps"]


def _host_constant(a, dtype, device):
    """``torch.as_tensor(a)`` on ``device`` for a host array ``a``.  On a
    card the copy from pageable memory waits for the work queued before
    it: a blocking "sync", counted as one."""
    with span("sync"):
        count("sync")
        return torch.as_tensor(a, dtype=dtype, device=device)


class SpectralOps(NamedTuple):
    """Spectral operators handed to trajectory-level OCP hooks: ``D`` is the
    (N, N) physical-time differentiation matrix (D @ X ~= dX/dt at the
    nodes), ``w`` the (N,) physical quadrature weights — GenericOCP's
    diff/ddiff/norm_diff/norm_ddiff operators (generic_ocp.hpp:88-101)."""
    D: torch.Tensor
    w: torch.Tensor


def split_z(z, nx, nu, N, np_):
    """z (..., n) -> (X (..., N, nx), U (..., N, nu), P (..., np_))."""
    lead = z.shape[:-1]
    X = z[..., :N * nx].reshape(*lead, N, nx)
    U = z[..., N * nx:N * (nx + nu)].reshape(*lead, N, nu)
    P = z[..., N * (nx + nu):]
    return X, U, P


def pack_z(X, U, P=None):
    lead = X.shape[:-2]
    parts = [X.reshape(*lead, -1), U.reshape(*lead, -1)]
    if P is not None and P.shape[-1]:
        parts.append(P.reshape(*lead, -1))
    return torch.cat(parts, dim=-1)


class _Consts:
    """Numpy constants of a transcription as tensors, made once per
    (dtype, device)."""

    def __init__(self, **arrays):
        self._np = arrays
        self._cache = {}

    def __call__(self, name, like):
        key = (name, like.dtype, like.device)
        t = self._cache.get(key)
        if t is None:
            t = torch.as_tensor(self._np[name], dtype=like.dtype,
                                device=like.device)
            self._cache[key] = t
        return t


@dataclasses.dataclass(frozen=True)
class Transcription:
    """Static transcription: OCP + mesh -> NLP with collocation constants.

      Dg_unit: composite differentiation matrix for unit segments (dt=2),
               scaled by 2*NS/(tf-t0);
      w_unit:  composite quadrature weights for unit segments, scaled by
               (tf-t0)/(2*NS);
      tau:     normalised time grid on [0, 1].
    """
    ocp: OCP
    mesh: SegmentedBasis
    nlp: NLP
    Dg_unit: np.ndarray
    w_unit: np.ndarray
    tau: np.ndarray
    x_scale: np.ndarray = None
    u_scale: np.ndarray = None
    p_scale: np.ndarray = None

    @property
    def N(self) -> int:
        return self.mesh.num_nodes

    @property
    def n_vars(self) -> int:
        return self.nlp.n

    def initial_guess(self, x0=None, dtype=torch.float64, device="cuda"):
        """Constant-trajectory guess (x0 tiled, zero controls/params) in
        physical units; returns the scaled (n,) decision vector."""
        N, ocp = self.N, self.ocp
        X = torch.zeros((N, ocp.nx), dtype=dtype, device=device) \
            if x0 is None else torch.as_tensor(
                x0, dtype=dtype, device=device)[None, :].expand(N, ocp.nx)
        U = torch.zeros((N, ocp.nu), dtype=dtype, device=device)
        P = torch.zeros(ocp.np_, dtype=dtype, device=device)
        return self.pack(X, U, P)

    def pack(self, X, U, P=None):
        """Physical (X (..., N, nx), U, P) -> scaled z (..., n)."""
        X = X / _host_constant(self.x_scale, X.dtype, X.device)
        U = U.to(X.dtype) / _host_constant(self.u_scale, X.dtype, X.device)
        if P is not None and self.ocp.np_:
            P = P.to(X.dtype) / _host_constant(self.p_scale, X.dtype,
                                              X.device)
        else:
            P = None
        return pack_z(X, U, P)

    def unpack(self, z):
        """Scaled z (..., n) -> physical (X, U, P)."""
        X, U, P = split_z(z, self.ocp.nx, self.ocp.nu, self.N, self.ocp.np_)
        c = lambda a: torch.as_tensor(a, dtype=z.dtype, device=z.device)
        return X * c(self.x_scale), U * c(self.u_scale), P * c(self.p_scale)

    def rollout_guess(self, x0, prm, U=None, substeps: int = 4):
        """Initial guess by RK4 rollout of the dynamics through the time grid.

        x0 (B, nx) physical; U (B, N, nu) physical or None (zeros); returns
        the packed scaled z (B, n) — the batched form of the JAX package's
        per-instance ``rollout_guess``.
        """
        ocp, N = self.ocp, self.N
        B = x0.shape[0]
        dtype, dev = x0.dtype, x0.device
        tau = _host_constant(self.tau, dtype, dev)
        tgrid = prm["t0"] + (prm["tf"] - prm["t0"]) * tau
        if U is None:
            U = torch.zeros((B, N, ocp.nu), dtype=dtype, device=dev)
        P, d = prm["p"], prm["d"]
        f = vmap(lambda x, u, t: ocp.dynamics(x, u, P, d, t),
                 in_dims=(0, 0, None))

        xs = [x0]
        x = x0
        for j in range(N - 1):
            t0_, t1_, u = tgrid[j], tgrid[j + 1], U[:, j]
            h = (t1_ - t0_) / substeps
            for k in range(substeps):
                t = t0_ + h * k
                k1 = f(x, u, t)
                k2 = f(x + 0.5 * h * k1, u, t + 0.5 * h)
                k3 = f(x + 0.5 * h * k2, u, t + 0.5 * h)
                k4 = f(x + h * k3, u, t + h)
                x = (x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)).to(dtype)
            xs.append(x)
        X = torch.stack(xs, dim=1)
        Pb = P[None].expand(B, ocp.np_) if ocp.np_ else None
        return self.pack(X, U, Pb)

    def bbt_structure(self):
        """BBT permutation metadata of this transcription's boxADMM KKT
        (ops/structure.py); hand it to ``ADMMSettings(structure=...)`` with
        ``kkt_solver="kernel"``.

        Returns None where the KKT is not bordered-block-tridiagonal:
        trajectory-level hooks couple nodes densely, Radau meshes add
        continuity rows, and soft-defect transcriptions have no defect
        duals at all."""
        from polympc_torch.ops.structure import bbt_structure as _bbt
        ocp = self.ocp
        if (not self.mesh.shares_boundary
                or ocp.trajectory_cost is not None
                or ocp.trajectory_ineq is not None
                or self.nlp.eq is None):
            return None
        return _bbt(self.N, ocp.nx, ocp.nu, ocp.ng, ocp.np_, ocp.ntg,
                    self.mesh.order, self.mesh.num_segments)

    def params(self, p=None, d=None, t0=0.0, tf=1.0, dtype=torch.float64,
               device="cuda"):
        mk = lambda v, size: torch.zeros(size, dtype=dtype, device=device) \
            if v is None else torch.as_tensor(v, dtype=dtype, device=device)
        return {"p": mk(p, self.ocp.np_), "d": mk(d, self.ocp.nd),
                "t0": torch.as_tensor(t0, dtype=dtype, device=device),
                "tf": torch.as_tensor(tf, dtype=dtype, device=device)}


def transcribe(ocp: OCP, mesh: SegmentedBasis,
               x_scale=None, u_scale=None, p_scale=None,
               soft_defects: float = 0.0) -> Transcription:
    """Build the batch-first collocation NLP for an OCP on the given mesh.

    x_scale/u_scale/p_scale: optional per-variable scaling (physical value =
    scale * decision variable), as in the JAX package.

    Lobatto meshes share the boundary node between segments; Radau meshes
    glue their segments with linear continuity rows after the defects
    (``ne = N*nx + (S-1)*nx``), and a Radau mesh without tf among its nodes
    takes the Mayer term at the interpolated endpoint.  A Gauss mesh (no
    left endpoint to pin x0) is refused.

    soft_defects > 0 moves the dynamics defects into the cost as the
    penalty  soft_defects * ||defects||^2  (``ne = 0``; no ``eq``,
    ``eq_jac`` or ``lag_hessian``): the reference's SoftChebyshev
    transcription (chebyshev_soft.hpp:15-72).

    Trajectory-level hooks (``ocp.trajectory_cost``, ``trajectory_ineq``)
    see one lane's whole physical trajectory (X (N, nx), U (N, nu), P, d,
    t (N,), SpectralOps); their rows follow the per-node inequalities, and
    their exact Hessian and Jacobian rows are whole-trajectory AD on top of
    the per-node blocks, as in the JAX package.
    """
    if not mesh.basis.has_left_endpoint:
        raise NotImplementedError(
            "collocation transcription needs the left endpoint in the node "
            "set to pin initial conditions — use a Lobatto or Radau basis "
            "(Gauss is for quadrature/projection/integration)")
    N = mesh.num_nodes
    nx, nu, np_, ng = ocp.nx, ocp.nu, ocp.np_, ocp.ng
    q_xu = nx + nu
    has_tf = mesh.basis.has_right_endpoint
    soft = soft_defects > 0.0
    sx = np.ones(nx) if x_scale is None else np.asarray(x_scale, np.float64)
    su = np.ones(nu) if u_scale is None else np.asarray(u_scale, np.float64)
    sp = np.ones(np_) if p_scale is None else np.asarray(p_scale, np.float64)
    n = N * (nx + nu) + np_
    Rcont = mesh.continuity_matrix()
    n_cont = Rcont.shape[0] * nx
    ne = 0 if soft else N * nx + n_cont
    ni = N * ng + ocp.ntg
    mayer_interp = ocp.mayer is not None and not has_tf
    hooks = ocp.trajectory_cost is not None or ocp.trajectory_ineq is not None
    NS = mesh.num_segments
    Dg_unit = mesh.composite_diff_matrix(0.0, 2.0 * NS)
    w_unit = mesh.quadrature_weights(0.0, 2.0 * NS)
    tau = mesh.time_nodes(0.0, 1.0)
    # Mayer at a node only where tf is the last node; otherwise at the
    # interpolated endpoint (a trajectory-level term)
    is_last = (np.arange(N) == N - 1) & has_tf
    r_tf = None if has_tf else mesh.interp_matrix([1.0], 0.0, 1.0)[0]
    KC = np.concatenate([np.kron(Rcont, np.eye(nx)),
                         np.zeros((n_cont, N * nu + np_))], axis=1)
    K = _Consts(Dg=Dg_unit, w=w_unit, tau=tau, sx=sx, su=su, sp=sp,
                KD=np.kron(Dg_unit, np.eye(nx)), last=is_last, R=Rcont,
                KC=KC, r_tf=np.zeros(N) if r_tf is None else r_tf)

    def _scale(prm):
        return (prm["tf"] - prm["t0"]) / (2.0 * NS)

    def _times(prm, z):
        return prm["t0"] + (prm["tf"] - prm["t0"]) * K("tau", z)

    def _nodes(z, prm):
        """Per-node arguments flattened over (lane, node): scaled X, U, P
        (B*N, .), times (B*N,), and the lane count B."""
        B = z.shape[0]
        X, U, P = split_z(z, nx, nu, N, np_)
        t = _times(prm, z)
        return (X.reshape(B * N, nx), U.reshape(B * N, nu),
                P[:, None, :].expand(B, N, np_).reshape(B * N, np_),
                t[None, :].expand(B, N).reshape(B * N), B)

    def _scales(z):
        """(sx, su, sp) as tensors like z.  Made outside every torch.func
        transform and passed in: a constant first made inside a transform
        would be cached at that transform's level."""
        return K("sx", z), K("su", z), K("sp", z)

    def _phys(xs, us, Ps, sc):
        return xs * sc[0], us * sc[1], Ps * sc[2]

    def _spectral_ops(prm, z):
        """Physical-time spectral operators handed to trajectory-level
        hooks (GenericOCP's diff/ddiff operators, generic_ocp.hpp:88-101):
        ops.D @ X ~= dX/dt at the nodes; ops.w integrate over [t0, tf]."""
        scale = _scale(prm)
        return SpectralOps(D=K("Dg", z) / scale, w=scale * K("w", z))

    def eq_fn(z, prm):
        """Collocation defects Dg@X~ - scale*f/sx at every node, row-major
        (N, nx) flattened (ref: continuous_ocp.hpp:739-766), then the
        inter-segment continuity rows of a Radau mesh."""
        xs, us, Ps, t, B = _nodes(z, prm)
        d = prm["d"]
        x, u, p = _phys(xs, us, Ps, _scales(z))
        f = vmap(lambda xk, uk, pk, tk: ocp.dynamics(xk, uk, pk, d, tk))(
            x, u, p, t).to(z.dtype).reshape(B, N, nx)
        Xs = xs.reshape(B, N, nx)
        rows = (torch.matmul(K("Dg", z), Xs)
                - _scale(prm) * f / K("sx", z)).reshape(B, N * nx)
        if n_cont:
            cont = torch.matmul(K("R", z), Xs / K("sx", z))
            rows = torch.cat([rows, cont.reshape(B, n_cont)], dim=1)
        return rows

    def _node_cost(xs, us, Ps, tk, wk, last, scale, d, sc):
        """One node's share of the cost: scale*w_k*L [+ Mayer at tf]."""
        x, u, p = _phys(xs, us, Ps, sc)
        val = torch.zeros((), dtype=xs.dtype, device=xs.device)
        if ocp.lagrange is not None:
            val = val + scale * wk * ocp.lagrange(x, u, p, d, tk)
        if ocp.mayer is not None and has_tf:
            val = val + torch.where(last, ocp.mayer(x, p, d),
                                    torch.zeros_like(val))
        return val.to(xs.dtype)

    def _node_args(z, prm):
        xs, us, Ps, t, B = _nodes(z, prm)
        w = K("w", z)[None, :].expand(B, N).reshape(B * N)
        last = K("last", z.new_zeros((), dtype=torch.bool)).to(
            z.device)[None, :].expand(B, N).reshape(B * N)
        return xs, us, Ps, t, w, last, B

    def _lane_traj(zi, sc):
        """One lane's physical (X (N, nx), U (N, nu), P) from its z."""
        X, U, P = split_z(zi, nx, nu, N, np_)
        return X * sc[0], U * sc[1], P * sc[2]

    def _traj_parts(z, prm):
        """Per-lane evaluators of the trajectory-level terms (all made
        outside any transform): the hook cost + interpolated Mayer, and the
        hook rows, each a function of one lane's z."""
        t, ops, sc, d = _times(prm, z), _spectral_ops(prm, z), _scales(z), \
            prm["d"]
        r = K("r_tf", z)

        def cost(zi):
            X, U, P = _lane_traj(zi, sc)
            val = torch.zeros((), dtype=zi.dtype, device=zi.device)
            if ocp.trajectory_cost is not None:
                val = val + ocp.trajectory_cost(X, U, P, d, t, ops)
            if mayer_interp:
                val = val + ocp.mayer(r @ X, P, d)
            return val.to(zi.dtype)

        def rows(zi):
            X, U, P = _lane_traj(zi, sc)
            return ocp.trajectory_ineq(X, U, P, d, t, ops).to(zi.dtype)
        return cost, rows

    def cost_fn(z, prm):
        """Quadrature Lagrange cost + Mayer at the final node
        (ref: continuous_ocp.hpp:1182-1207), + the soft-defect penalty, the
        interpolated Mayer and the trajectory-level cost where present."""
        xs, us, Ps, t, w, last, B = _node_args(z, prm)
        scale, d, sc = _scale(prm), prm["d"], _scales(z)
        vals = vmap(lambda *a: _node_cost(*a, scale, d, sc))(
            xs, us, Ps, t, w, last)
        total = vals.reshape(B, N).sum(dim=1)
        if soft:
            defects = eq_fn(z, prm)
            total = total + soft_defects * (defects * defects).sum(dim=1)
        if ocp.trajectory_cost is not None or mayer_interp:
            total = total + vmap(_traj_parts(z, prm)[0])(z)
        return total

    def cost_grad_fn(z, prm):
        """Per-node cost gradients assembled into (B, n): X and U rows per
        node, the P row summed over nodes."""
        xs, us, Ps, t, w, last, B = _node_args(z, prm)
        scale, d, sc = _scale(prm), prm["d"], _scales(z)
        if np_:
            gx, gu, gp = vmap(grad(lambda a, b, c, *r: _node_cost(
                a, b, c, *r, scale, d, sc), argnums=(0, 1, 2)))(
                xs, us, Ps, t, w, last)
            tail = [gp.reshape(B, N, np_).sum(dim=1)]
        else:
            gx, gu = vmap(grad(lambda a, b, c, *r: _node_cost(
                a, b, c, *r, scale, d, sc), argnums=(0, 1)))(
                xs, us, Ps, t, w, last)
            tail = []
        return torch.cat([gx.reshape(B, N * nx), gu.reshape(B, N * nu)]
                         + tail, dim=1)

    def _ineq_scaled(xs, us, Ps, tk, d, sc):
        x, u, p = _phys(xs, us, Ps, sc)
        return ocp.ineq(x, u, p, d, tk).to(xs.dtype)

    ineq_fn = None
    ineq_jac_fn = None
    if ocp.ineq is not None or ocp.trajectory_ineq is not None:
        def ineq_fn(z, prm):
            """Per-node inequality rows, then the trajectory-level rows."""
            B = z.shape[0]
            rows = []
            if ocp.ineq is not None:
                xs, us, Ps, t, _ = _nodes(z, prm)
                d, sc = prm["d"], _scales(z)
                G = vmap(lambda *a: _ineq_scaled(*a, d, sc))(xs, us, Ps, t)
                rows.append(G.reshape(B, N * ng))
            if ocp.trajectory_ineq is not None:
                rows.append(vmap(_traj_parts(z, prm)[1])(z))
            return torch.cat(rows, dim=1) if len(rows) > 1 else rows[0]

        def ineq_jac_fn(z, prm):
            """Per-node blocks of the node rows; the trajectory rows'
            Jacobian by AD over the lane's whole z."""
            B = z.shape[0]
            parts = []
            if ocp.ineq is not None:
                xs, us, Ps, t, _ = _nodes(z, prm)
                d, sc = prm["d"], _scales(z)
                argn = (0, 1, 2) if np_ else (0, 1)
                jac = vmap(jacrev(lambda *a: _ineq_scaled(*a, d, sc),
                                  argnums=argn))(xs, us, Ps, t)
                gx = jac[0].reshape(B, N, ng, nx)
                gu = jac[1].reshape(B, N, ng, nu)
                cols = [block_diag_scatter(gx), block_diag_scatter(gu)]
                if np_:
                    cols.append(jac[2].reshape(B, N * ng, np_))
                parts.append(torch.cat(cols, dim=2))
            if ocp.trajectory_ineq is not None:
                parts.append(vmap(jacrev(_traj_parts(z, prm)[1]))(z))
            return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]

    def _dyn_scaled(xs, us, Ps, tk, d, sc):
        """Scaled-variable dynamics: the scale-free f~ = f(..)/sx."""
        x, u, p = _phys(xs, us, Ps, sc)
        return (ocp.dynamics(x, u, p, d, tk) / sc[0]).to(xs.dtype)

    def eq_jac_fn(z, prm):
        xs, us, Ps, t, B = _nodes(z, prm)
        d, scale, sc = prm["d"], _scale(prm), _scales(z)
        argn = (0, 1, 2) if np_ else (0, 1)
        jac = vmap(jacrev(lambda *a: _dyn_scaled(*a, d, sc), argnums=argn))(
            xs, us, Ps, t)
        fx = jac[0].reshape(B, N, nx, nx)
        fu = jac[1].reshape(B, N, nx, nu)
        Jx = K("KD", z) - scale * block_diag_scatter(fx)
        Ju = -scale * block_diag_scatter(fu)
        cols = [Jx, Ju]
        if np_:
            cols.append(-scale * jac[2].reshape(B, N * nx, np_))
        J = torch.cat(cols, dim=2)
        if n_cont:
            # continuity rows are linear, with a constant Jacobian
            J = torch.cat([J, K("KC", z).expand(B, n_cont, n)], dim=1)
        return J

    def _node_scalar(xs, us, Ps, tk, wk, lam_k, mu_k, last, scale, d, sc):
        """Per-node scalar whose Hessian is this node's Lagrangian block:
        scale*w_k*L + lam_k'(-scale*f~) [+ Mayer at the last node]
        [+ mu_k' g at the node]."""
        val = _node_cost(xs, us, Ps, tk, wk, last, scale, d, sc)
        val = val - scale * (lam_k @ _dyn_scaled(xs, us, Ps, tk, d, sc))
        if ocp.ineq is not None:
            val = val + mu_k @ _ineq_scaled(xs, us, Ps, tk, d, sc)
        return val

    def node_lag_hessian(z, lam, prm):
        """Dense (B, n, n) Lagrangian Hessian from per-node blocks.  Only
        the N*nx defect duals carry curvature: a Radau mesh's continuity
        rows are linear."""
        xs, us, Ps, t, w, last, B = _node_args(z, prm)
        scale, d, sc = _scale(prm), prm["d"], _scales(z)
        lam_eq = lam[:, :N * nx].reshape(B * N, nx) if ne else \
            z.new_zeros((B * N, nx))
        mu = lam[:, ne:ne + N * ng].reshape(B * N, ng)

        def node_h(x1, u1, P1, tk, wk, lk, mk, lst):
            def fun(v):
                return _node_scalar(v[:nx], v[nx:q_xu], v[q_xu:], tk, wk,
                                    lk, mk, lst, scale, d, sc)
            return jacrev(grad(fun))(torch.cat([x1, u1, P1]))

        Hn = vmap(node_h)(xs, us, Ps, t, w, lam_eq, mu, last)
        Hn = Hn.reshape(B, N, q_xu + np_, q_xu + np_)
        XX = block_diag_scatter(Hn[:, :, :nx, :nx])
        XU = block_diag_scatter(Hn[:, :, :nx, nx:q_xu])
        UU = block_diag_scatter(Hn[:, :, nx:q_xu, nx:q_xu])
        XUt = XU.transpose(1, 2)
        if np_:
            Hxp = Hn[:, :, :nx, q_xu:].reshape(B, N * nx, np_)
            Hup = Hn[:, :, nx:q_xu, q_xu:].reshape(B, N * nu, np_)
            Hpp = Hn[:, :, q_xu:, q_xu:].sum(dim=1)
            top = torch.cat([XX, XU, Hxp], dim=2)
            mid = torch.cat([XUt, UU, Hup], dim=2)
            bot = torch.cat([Hxp.transpose(1, 2), Hup.transpose(1, 2), Hpp],
                            dim=2)
            return torch.cat([top, mid, bot], dim=1)
        top = torch.cat([XX, XU], dim=2)
        mid = torch.cat([XUt, UU], dim=2)
        return torch.cat([top, mid], dim=1)

    lag_hessian_fn = node_lag_hessian
    if hooks or mayer_interp:
        def lag_hessian_fn(z, lam, prm):
            """The per-node blocks plus the exact dense Hessian of the
            trajectory-level terms (they couple nodes)."""
            H = node_lag_hessian(z, lam, prm)
            cost, rows = _traj_parts(z, prm)

            def traj_scalar(zi, mi):
                val = cost(zi)
                if ocp.trajectory_ineq is not None:
                    val = val + mi @ rows(zi)
                return val
            return H + vmap(jacrev(grad(traj_scalar)))(z, lam[:, ne + N * ng:])

    def gn_hessian_fn(z, prm):
        """Gauss-Newton Hessian: cost curvature only."""
        return lag_hessian_fn(z, z.new_zeros((z.shape[0], ne + ni)), prm)

    # the per-node gradient covers the node costs only; the penalty and the
    # trajectory-level cost take the whole-vector gradient, as in the JAX
    # package
    extra_cost = soft or ocp.trajectory_cost is not None or mayer_interp
    nlp = NLP(cost=cost_fn, n=n, eq=None if soft else eq_fn, ne=ne,
              ineq=ineq_fn, ni=ni,
              cost_grad=None if extra_cost else cost_grad_fn,
              eq_jac=None if soft else eq_jac_fn, ineq_jac=ineq_jac_fn,
              lag_hessian=None if soft else lag_hessian_fn,
              gn_hessian=gn_hessian_fn, block_structure=(N, nx, nu, np_))
    return Transcription(ocp=ocp, mesh=mesh, nlp=nlp, Dg_unit=Dg_unit,
                         w_unit=w_unit, tau=tau, x_scale=sx, u_scale=su,
                         p_scale=sp)


def ocp_bounds(tr: Transcription, xl=None, xu=None, ul=None, uu=None,
               pl=None, pu=None, gl=None, gu=None, x0=None, xf=None,
               tgl=None, tgu=None, dtype=torch.float64,
               device="cuda") -> NLPBounds:
    """Assemble NLP box/row bounds from per-variable OCP bounds (shared by
    all lanes).  x0/xf pin the first/last state node by equality
    (mpc_wrapper.hpp:89-181); state/control bounds broadcast over nodes;
    tgl/tgu bound the trajectory-level rows (after the node rows)."""
    ocp, N = tr.ocp, tr.N
    inf = float("inf")

    def fill(v, size, default):
        if v is None:
            return torch.full((size,), default, dtype=dtype, device=device)
        return torch.as_tensor(v, dtype=dtype, device=device)

    c = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    sx, su, sp = c(tr.x_scale), c(tr.u_scale), c(tr.p_scale)
    xl_, xu_ = fill(xl, ocp.nx, -inf) / sx, fill(xu, ocp.nx, inf) / sx
    ul_, uu_ = fill(ul, ocp.nu, -inf) / su, fill(uu, ocp.nu, inf) / su
    pl_, pu_ = fill(pl, ocp.np_, -inf) / sp, fill(pu, ocp.np_, inf) / sp
    Xl = xl_[None, :].repeat(N, 1)
    Xu = xu_[None, :].repeat(N, 1)
    if x0 is not None:
        Xl[0] = Xu[0] = c(x0) / sx
    if xf is not None:
        if not tr.mesh.basis.has_right_endpoint:
            raise ValueError(
                "terminal-state pinning needs tf in the node set (Lobatto "
                "or flipped Radau); this mesh's last node is interior")
        Xl[-1] = Xu[-1] = c(xf) / sx
    lbx = torch.cat([Xl.reshape(-1), ul_.repeat(N), pl_])
    ubx = torch.cat([Xu.reshape(-1), uu_.repeat(N), pu_])
    GL = fill(gl, ocp.ng, -inf).repeat(N)
    GU = fill(gu, ocp.ng, inf).repeat(N)
    if ocp.ntg:
        GL = torch.cat([GL, fill(tgl, ocp.ntg, -inf)])
        GU = torch.cat([GU, fill(tgu, ocp.ntg, inf)])
    return NLPBounds(lbx=lbx, ubx=ubx, gl=GL, gu=GU)
