"""Model parameter identification from trajectory data — the port of
polympc_tpu/ocp/identification.py.

The capability behind the reference's ``CollocateIdCost``
(chebyshev.hpp:426+) and the kite-identification example
(examples/kite_identification_test.cpp): estimate dynamics parameters p
from sampled state/control trajectories.  Two stages, both
collocation-based:

  * ``equation_error_fit`` — hold the trajectory at the data and solve
      min_p  sum_k || (D @ X_data)_k - f(x_k, u_k, p) ||^2
    by Gauss-Newton on the small p-only problem (exact in one step for
    dynamics affine in p);
  * ``identify`` — output-error refinement: the soft-defect collocation NLP
      min_{X,p} sum_k w_k ||x_k - x_data(t_k)||^2 + w_dyn ||defects(X, p)||^2
    solved by the SQP (one lane), warm-started from the equation-error
    estimate and the data trajectory.  The penalty form is deliberate: with
    hard defects the problem is ill-posed (the defect Jacobian of a
    free-initial-state collocation is nearly rank deficient), as the JAX
    package's module docstring explains.

Callables act on one node (x (nx,), u, p, d, t 0-dim) and on one time
(``x_data(t)``, ``u_data(t)``); they run over the nodes with
``torch.func.vmap``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import jacrev, vmap

from polympc_torch.basis.basis import SegmentedBasis
from polympc_torch.nlp.sqp import sqp_solve
from polympc_torch.nlp.types import SQPSettings
from polympc_torch.ocp.ocp import OCP
from polympc_torch.ocp.transcription import ocp_bounds, transcribe
from polympc_torch.qp.types import ADMMSettings

__all__ = ["IdentificationResult", "equation_error_fit", "identify"]


class IdentificationResult(NamedTuple):
    p: torch.Tensor          # estimated parameters
    p_init: torch.Tensor     # equation-error initial estimate
    X: torch.Tensor          # fitted state trajectory at the nodes (N, nx)
    cost: torch.Tensor       # final output-error cost
    status: torch.Tensor     # SQP status of the refinement
    iters: torch.Tensor


def equation_error_fit(dynamics: Callable, mesh: SegmentedBasis,
                       X_nodes, U_nodes, t0: float, tf: float,
                       p0, d=None, gn_iters: int = 8):
    """Least-squares parameter fit on collocation defect residuals.

    X_nodes (N, nx) / U_nodes (N, nu) are the measured trajectory sampled at
    the mesh's collocation nodes.  Returns (p, rms of the residual at the
    last Gauss-Newton iterate), in the dtype and on the device of X_nodes.
    """
    X = torch.as_tensor(X_nodes)
    dt, dev = X.dtype, X.device
    U = torch.as_tensor(U_nodes, dtype=dt, device=dev)
    p = torch.as_tensor(p0, dtype=dt, device=dev)
    d = torch.zeros(0, dtype=dt, device=dev) if d is None else \
        torch.as_tensor(d, dtype=dt, device=dev)
    NS = mesh.num_segments
    scale = (tf - t0) / (2.0 * NS)
    Dg = torch.as_tensor(mesh.composite_diff_matrix(0.0, 2.0 * NS),
                         dtype=dt, device=dev)
    t = torch.as_tensor(mesh.time_nodes(t0, tf), dtype=dt, device=dev)
    dX = (Dg @ X) / scale
    eye = torch.eye(p.shape[0], dtype=dt, device=dev)

    def residuals(pp):
        f = vmap(lambda xk, uk, tk: dynamics(xk, uk, pp, d, tk))(X, U, t)
        return (dX - f).reshape(-1)

    rms = None
    for _ in range(gn_iters):
        r = residuals(p)
        J = jacrev(residuals)(p)
        JtJ = J.T @ J + 1e-12 * eye
        p = p + torch.linalg.solve(JtJ, -J.T @ r)
        rms = torch.sqrt(torch.mean(r * r))
    return p, rms


def identify(dynamics: Callable, mesh: SegmentedBasis,
             x_data: Callable, u_data: Callable | None,
             t0: float, tf: float, n_params: int,
             nx: int, nu: int = 0, d=None,
             p0=None, pl=None, pu=None, Q=None,
             defect_weight: float = 10.0,
             settings: SQPSettings | None = None,
             dtype=torch.float64, device="cuda") -> IdentificationResult:
    """Full output-error identification on ``device``.

    dynamics: (x, u, p, d, t) -> (nx,);  x_data: t -> (nx,) measured state
    (interpolated); u_data: t -> (nu,) applied input, or None if
    autonomous.  The equation-error estimate (clipped to [pl, pu]) seeds the
    SQP refinement; defect_weight is the soft-dynamics penalty weight.
    """
    Qm = torch.eye(nx, dtype=dtype, device=device) if Q is None else \
        torch.as_tensor(Q, dtype=dtype, device=device)

    def dyn(x, u, p, dd, t):
        uu = u if u_data is None else u_data(t)
        return dynamics(x, uu, p, dd, t)

    def lagrange(x, u, p, dd, t):
        r = x - x_data(t)
        return r @ Qm @ r

    ocp = OCP(dynamics=dyn, nx=nx, nu=nu, np_=n_params,
              nd=0 if d is None else len(np.atleast_1d(d)),
              lagrange=lagrange)
    tr = transcribe(ocp, mesh, soft_defects=defect_weight)
    prm = tr.params(d=d, t0=t0, tf=tf, dtype=dtype, device=device)
    t_nodes = torch.as_tensor(mesh.time_nodes(t0, tf), dtype=dtype,
                              device=device)
    X_nodes = vmap(x_data)(t_nodes)
    U_nodes = torch.zeros((tr.N, nu), dtype=dtype, device=device) \
        if u_data is None else vmap(u_data)(t_nodes)

    p0 = torch.zeros(n_params, dtype=dtype, device=device) if p0 is None \
        else torch.as_tensor(p0, dtype=dtype, device=device)
    p_init, _ = equation_error_fit(dyn, mesh, X_nodes, U_nodes, t0, tf, p0,
                                   d=prm["d"])
    if pl is not None or pu is not None:
        inf = float("inf")
        lo = torch.full((n_params,), -inf, dtype=dtype, device=device) \
            if pl is None else torch.as_tensor(pl, dtype=dtype, device=device)
        hi = torch.full((n_params,), inf, dtype=dtype, device=device) \
            if pu is None else torch.as_tensor(pu, dtype=dtype, device=device)
        p_init = torch.clamp(p_init, min=lo, max=hi)

    bounds = ocp_bounds(tr, pl=pl, pu=pu, dtype=dtype, device=device)
    z0 = tr.pack(X_nodes, U_nodes, p_init)
    settings = settings or SQPSettings(
        hessian="exact", reg="eigen", reg_eps=1e-8,
        line_search="merit", max_iter=80,
        qp=ADMMSettings(rho=0.1, eps_abs=1e-8, eps_rel=1e-8,
                        max_epochs=60, equil_iters=2))
    sol = sqp_solve(tr.nlp, z0[None], p=prm, bounds=bounds,
                    settings=settings)
    X, _, P = tr.unpack(sol.x[0])
    return IdentificationResult(p=P, p_init=p_init, X=X, cost=sol.cost[0],
                                status=sol.status[0], iters=sol.iters[0])
