"""Pseudospectral collocation transcription: OCP -> batch-first NLP.

The port of polympc_tpu/ocp/transcription.py for boundary-sharing (Lobatto)
meshes.  The decision vector of one lane is z = [X (N*nx); U (N*nu);
P (np_)] in forward time order, in scaled units (physical = scale * z).
Every NLP callable takes z (B, n): the OCP's per-node functions run over all
B*N nodes at once with ``torch.func.vmap``, and derivatives are per node
(``torch.func.jacrev`` / ``grad`` over one node's (x, u, P)), assembled
into the block structure of the collocation NLP — never a whole-vector
dense Jacobian by AD:

  eq Jacobian   = kron(Dg, I_nx) - blockdiag(scale * df/d(x,u)) + P column;
  Lagrangian Hessian = per-node (x_k, u_k, P) blocks, block-diagonal + P
  arrow (the cross-node coupling Dg is linear and adds no curvature).

The parameter dict is {"p": (np_,), "d": (nd,), "t0": 0-dim, "tf": 0-dim},
shared by all lanes.  Radau meshes, soft defects and trajectory-level hooks
are ported in slice 4; ``transcribe`` raises for them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.func import grad, jacrev, vmap

from polympc_torch.basis.basis import SegmentedBasis
from polympc_torch.nlp.types import NLP, NLPBounds
from polympc_torch.ocp.ocp import OCP
from polympc_torch.utils.solver_utils import block_diag_scatter

__all__ = ["Transcription", "transcribe", "ocp_bounds", "split_z", "pack_z"]


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

    def initial_guess(self, x0=None, dtype=torch.float64, device=None):
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
        X = X / torch.as_tensor(self.x_scale, dtype=X.dtype, device=X.device)
        U = U.to(X.dtype) / torch.as_tensor(self.u_scale, dtype=X.dtype,
                                            device=X.device)
        if P is not None and self.ocp.np_:
            P = P.to(X.dtype) / torch.as_tensor(self.p_scale, dtype=X.dtype,
                                                device=X.device)
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
        tau = torch.as_tensor(self.tau, dtype=dtype, device=dev)
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
        ``kkt_solver="kernel"``."""
        from polympc_torch.ops.structure import bbt_structure as _bbt
        ocp = self.ocp
        return _bbt(self.N, ocp.nx, ocp.nu, ocp.ng, ocp.np_, ocp.ntg,
                    self.mesh.order, self.mesh.num_segments)

    def params(self, p=None, d=None, t0=0.0, tf=1.0, dtype=torch.float64,
               device=None):
        mk = lambda v, size: torch.zeros(size, dtype=dtype, device=device) \
            if v is None else torch.as_tensor(v, dtype=dtype, device=device)
        return {"p": mk(p, self.ocp.np_), "d": mk(d, self.ocp.nd),
                "t0": torch.as_tensor(t0, dtype=dtype, device=device),
                "tf": torch.as_tensor(tf, dtype=dtype, device=device)}


def transcribe(ocp: OCP, mesh: SegmentedBasis,
               x_scale=None, u_scale=None, p_scale=None) -> Transcription:
    """Build the batch-first collocation NLP for an OCP on a Lobatto mesh.

    x_scale/u_scale/p_scale: optional per-variable scaling (physical value =
    scale * decision variable), as in the JAX package.
    """
    if not mesh.shares_boundary:
        raise NotImplementedError(
            "this slice transcribes boundary-sharing (Lobatto) meshes; "
            "Radau/Gauss meshes with continuity rows are ported in slice 4")
    if ocp.trajectory_cost is not None or ocp.trajectory_ineq is not None:
        raise NotImplementedError(
            "trajectory-level hooks are ported in slice 4")
    N = mesh.num_nodes
    nx, nu, np_, ng = ocp.nx, ocp.nu, ocp.np_, ocp.ng
    q_xu = nx + nu
    sx = np.ones(nx) if x_scale is None else np.asarray(x_scale, np.float64)
    su = np.ones(nu) if u_scale is None else np.asarray(u_scale, np.float64)
    sp = np.ones(np_) if p_scale is None else np.asarray(p_scale, np.float64)
    n = N * (nx + nu) + np_
    ne = N * nx
    ni = N * ng
    NS = mesh.num_segments
    Dg_unit = mesh.composite_diff_matrix(0.0, 2.0 * NS)
    w_unit = mesh.quadrature_weights(0.0, 2.0 * NS)
    tau = mesh.time_nodes(0.0, 1.0)
    is_last = np.arange(N) == N - 1
    K = _Consts(Dg=Dg_unit, w=w_unit, tau=tau, sx=sx, su=su, sp=sp,
                KD=np.kron(Dg_unit, np.eye(nx)), last=is_last)

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

    def eq_fn(z, prm):
        """Collocation defects Dg@X~ - scale*f/sx at every node, row-major
        (N, nx) flattened (ref: continuous_ocp.hpp:739-766)."""
        xs, us, Ps, t, B = _nodes(z, prm)
        d = prm["d"]
        x, u, p = _phys(xs, us, Ps, _scales(z))
        f = vmap(lambda xk, uk, pk, tk: ocp.dynamics(xk, uk, pk, d, tk))(
            x, u, p, t).to(z.dtype).reshape(B, N, nx)
        Xs = xs.reshape(B, N, nx)
        rows = torch.matmul(K("Dg", z), Xs) - _scale(prm) * f / K("sx", z)
        return rows.reshape(B, N * nx)

    def _node_cost(xs, us, Ps, tk, wk, last, scale, d, sc):
        """One node's share of the cost: scale*w_k*L [+ Mayer at tf]."""
        x, u, p = _phys(xs, us, Ps, sc)
        val = torch.zeros((), dtype=xs.dtype, device=xs.device)
        if ocp.lagrange is not None:
            val = val + scale * wk * ocp.lagrange(x, u, p, d, tk)
        if ocp.mayer is not None:
            val = val + torch.where(last, ocp.mayer(x, p, d),
                                    torch.zeros_like(val))
        return val.to(xs.dtype)

    def _node_args(z, prm):
        xs, us, Ps, t, B = _nodes(z, prm)
        w = K("w", z)[None, :].expand(B, N).reshape(B * N)
        last = K("last", z.new_zeros((), dtype=torch.bool)).to(
            z.device)[None, :].expand(B, N).reshape(B * N)
        return xs, us, Ps, t, w, last, B

    def cost_fn(z, prm):
        """Quadrature Lagrange cost + Mayer at the final node
        (ref: continuous_ocp.hpp:1182-1207)."""
        xs, us, Ps, t, w, last, B = _node_args(z, prm)
        scale, d, sc = _scale(prm), prm["d"], _scales(z)
        vals = vmap(lambda *a: _node_cost(*a, scale, d, sc))(
            xs, us, Ps, t, w, last)
        return vals.reshape(B, N).sum(dim=1)

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

    ineq_fn = None
    ineq_jac_fn = None
    if ocp.ineq is not None:
        def _ineq_scaled(xs, us, Ps, tk, d, sc):
            x, u, p = _phys(xs, us, Ps, sc)
            return ocp.ineq(x, u, p, d, tk).to(xs.dtype)

        def ineq_fn(z, prm):
            xs, us, Ps, t, B = _nodes(z, prm)
            d, sc = prm["d"], _scales(z)
            G = vmap(lambda *a: _ineq_scaled(*a, d, sc))(xs, us, Ps, t)
            return G.reshape(B, N * ng)

        def ineq_jac_fn(z, prm):
            xs, us, Ps, t, B = _nodes(z, prm)
            d, sc = prm["d"], _scales(z)
            argn = (0, 1, 2) if np_ else (0, 1)
            jac = vmap(jacrev(lambda *a: _ineq_scaled(*a, d, sc),
                              argnums=argn))(xs, us, Ps, t)
            gx = jac[0].reshape(B, N, ng, nx)
            gu = jac[1].reshape(B, N, ng, nu)
            cols = [block_diag_scatter(gx), block_diag_scatter(gu)]
            if np_:
                cols.append(jac[2].reshape(B, N * ng, np_))
            return torch.cat(cols, dim=2)

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
        return torch.cat(cols, dim=2)

    def _node_scalar(xs, us, Ps, tk, wk, lam_k, mu_k, last, scale, d, sc):
        """Per-node scalar whose Hessian is this node's Lagrangian block:
        scale*w_k*L + lam_k'(-scale*f~) [+ Mayer at the last node]
        [+ mu_k' g at the node]."""
        val = _node_cost(xs, us, Ps, tk, wk, last, scale, d, sc)
        val = val - scale * (lam_k @ _dyn_scaled(xs, us, Ps, tk, d, sc))
        if ocp.ineq is not None:
            val = val + mu_k @ _ineq_scaled(xs, us, Ps, tk, d, sc)
        return val

    def lag_hessian_fn(z, lam, prm):
        """Dense (B, n, n) Lagrangian Hessian from per-node blocks."""
        xs, us, Ps, t, w, last, B = _node_args(z, prm)
        scale, d, sc = _scale(prm), prm["d"], _scales(z)
        lam_eq = lam[:, :N * nx].reshape(B * N, nx)
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

    def gn_hessian_fn(z, prm):
        """Gauss-Newton Hessian: cost curvature only."""
        return lag_hessian_fn(z, z.new_zeros((z.shape[0], ne + ni)), prm)

    nlp = NLP(cost=cost_fn, n=n, eq=eq_fn, ne=ne, ineq=ineq_fn, ni=ni,
              cost_grad=cost_grad_fn, eq_jac=eq_jac_fn,
              ineq_jac=ineq_jac_fn, lag_hessian=lag_hessian_fn,
              gn_hessian=gn_hessian_fn, block_structure=(N, nx, nu, np_))
    return Transcription(ocp=ocp, mesh=mesh, nlp=nlp, Dg_unit=Dg_unit,
                         w_unit=w_unit, tau=tau, x_scale=sx, u_scale=su,
                         p_scale=sp)


def ocp_bounds(tr: Transcription, xl=None, xu=None, ul=None, uu=None,
               pl=None, pu=None, gl=None, gu=None, x0=None, xf=None,
               dtype=torch.float64, device=None) -> NLPBounds:
    """Assemble NLP box/row bounds from per-variable OCP bounds (shared by
    all lanes).  x0/xf pin the first/last state node by equality
    (mpc_wrapper.hpp:89-181); state/control bounds broadcast over nodes."""
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
        Xl[-1] = Xu[-1] = c(xf) / sx
    lbx = torch.cat([Xl.reshape(-1), ul_.repeat(N), pl_])
    ubx = torch.cat([Xu.reshape(-1), uu_.repeat(N), pu_])
    GL = fill(gl, ocp.ng, -inf).repeat(N)
    GU = fill(gu, ocp.ng, inf).repeat(N)
    return NLPBounds(lbx=lbx, ubx=ubx, gl=GL, gu=GU)
