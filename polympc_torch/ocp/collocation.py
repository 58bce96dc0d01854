"""Standalone functional collocation operators — the port of
polympc_tpu/ocp/collocation.py.

The reference's legacy per-piece collocation classes —
``ode_collocation``/``sparse_ode_collocation``
(src/control/ode_collocation.hpp:21-208,
sparse_ode_collocation.hpp:24-306), ``cost_collocation`` and
``constraints_collocation`` — for users who want the operators without
building a full NLP through :func:`polympc_torch.ocp.transcribe`:

  * ``collocate_dynamics``  -> g(X, U) = D X - t_scale f(X, U) and its
    Jacobian,
  * ``collocate_cost``      -> quadrature Lagrange + Mayer cost and its
    gradient,
  * ``collocate_constraints`` -> node-stacked inequality values and
    Jacobian.

One trajectory per call (X (N, nx), U (N, nu)), in the dtype and on the
device of X.  Jacobians are per node (``torch.func.jacrev`` under one
``vmap`` over the nodes) assembled into blocks, never whole-vector AD.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import grad, jacrev, vmap

from polympc_torch.basis.basis import SegmentedBasis
from polympc_torch.utils.solver_utils import block_diag_scatter

__all__ = ["collocate_dynamics", "collocate_cost", "collocate_constraints"]


class CollocatedDynamics(NamedTuple):
    defects: Callable    # (X (N,nx), U (N,nu), p, d, t0, tf) -> (N, nx)
    jacobian: Callable   # same args -> (N*nx, N*(nx+nu)) dense Jacobian
    N: int


class CollocatedCost(NamedTuple):
    value: Callable      # (X, U, p, d, t0, tf) -> scalar
    gradient: Callable   # same args -> ((N,nx), (N,nu)) gradients


class CollocatedConstraints(NamedTuple):
    value: Callable      # (X, U, p, d, t0, tf) -> (N, ng)
    jacobian: Callable   # same args -> (N*ng, N*(nx+nu))


def _t(a, like):
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def _times(mesh, t0, tf, like):
    return t0 + (tf - t0) * _t(mesh.time_nodes(0.0, 1.0), like)


def _node_jacobians(fn, X, U, t):
    """Per-node (d fn/dx, d fn/du) of fn(x, u, t) at every node, assembled
    block-diagonally: ((N*r, N*nx), (N*r, N*nu))."""
    fx, fu = vmap(jacrev(fn, argnums=(0, 1)))(X, U, t)
    return block_diag_scatter(fx), block_diag_scatter(fu)


def collocate_dynamics(dynamics: Callable, mesh: SegmentedBasis,
                       nx: int, nu: int) -> CollocatedDynamics:
    """g(z) = D X - t_scale f(X, U, p, d, t) per node
    (ode_collocation.hpp:21-208)."""
    N = mesh.num_nodes
    NS = mesh.num_segments
    Dg_unit = mesh.composite_diff_matrix(0.0, 2.0 * NS)
    KD = np.kron(Dg_unit, np.eye(nx))

    def defects(X, U, p=None, d=None, t0=0.0, tf=1.0):
        X = torch.as_tensor(X)
        U = _t(U, X)
        t = _times(mesh, t0, tf, X)
        f = vmap(lambda xk, uk, tk: dynamics(xk, uk, p, d, tk))(X, U, t)
        scale = (tf - t0) / (2.0 * NS)
        return _t(Dg_unit, X) @ X - scale * f

    def jacobian(X, U, p=None, d=None, t0=0.0, tf=1.0):
        X = torch.as_tensor(X)
        U = _t(U, X)
        t = _times(mesh, t0, tf, X)
        scale = (tf - t0) / (2.0 * NS)
        Fx, Fu = _node_jacobians(
            lambda xk, uk, tk: dynamics(xk, uk, p, d, tk), X, U, t)
        return torch.cat([_t(KD, X) - scale * Fx, -scale * Fu], dim=1)

    return CollocatedDynamics(defects=defects, jacobian=jacobian, N=N)


def collocate_cost(lagrange: Callable | None, mayer: Callable | None,
                   mesh: SegmentedBasis) -> CollocatedCost:
    """Quadrature cost over the mesh + Mayer at the final node
    (cost_collocation.hpp).  The gradient is per node: each node's
    weighted Lagrange gradient, with Mayer's on the last state node."""
    N = mesh.num_nodes
    NS = mesh.num_segments
    w_unit = mesh.quadrature_weights(0.0, 2.0 * NS)

    def value(X, U, p=None, d=None, t0=0.0, tf=1.0):
        X = torch.as_tensor(X)
        U = _t(U, X)
        t = _times(mesh, t0, tf, X)
        total = torch.zeros((), dtype=X.dtype, device=X.device)
        if lagrange is not None:
            L = vmap(lambda xk, uk, tk: lagrange(xk, uk, p, d, tk))(X, U, t)
            scale = (tf - t0) / (2.0 * NS)
            total = total + scale * (_t(w_unit, X) @ L)
        if mayer is not None:
            total = total + mayer(X[-1], p, d)
        return total

    def gradient(X, U, p=None, d=None, t0=0.0, tf=1.0):
        X = torch.as_tensor(X)
        U = _t(U, X)
        gX, gU = torch.zeros_like(X), torch.zeros_like(U)
        if lagrange is not None:
            t = _times(mesh, t0, tf, X)
            scale = (tf - t0) / (2.0 * NS)
            gx, gu = vmap(grad(lambda xk, uk, tk: lagrange(
                xk, uk, p, d, tk), argnums=(0, 1)))(X, U, t)
            wk = scale * _t(w_unit, X)[:, None]
            gX, gU = wk * gx, wk * gu
        if mayer is not None:
            gm = grad(lambda x: mayer(x, p, d))(X[-1])
            last = (torch.arange(N, device=X.device) == N - 1)[:, None]
            gX = gX + torch.where(last, gm[None, :], torch.zeros_like(gX))
        return gX, gU

    return CollocatedCost(value=value, gradient=gradient)


def collocate_constraints(ineq: Callable, ng: int,
                          mesh: SegmentedBasis,
                          nx: int, nu: int) -> CollocatedConstraints:
    """Node-stacked inequality constraints + block Jacobian
    (constraints_collocation.hpp)."""

    def value(X, U, p=None, d=None, t0=0.0, tf=1.0):
        X = torch.as_tensor(X)
        t = _times(mesh, t0, tf, X)
        return vmap(lambda xk, uk, tk: ineq(xk, uk, p, d, tk))(
            X, _t(U, X), t)

    def jacobian(X, U, p=None, d=None, t0=0.0, tf=1.0):
        X = torch.as_tensor(X)
        t = _times(mesh, t0, tf, X)
        Gx, Gu = _node_jacobians(lambda xk, uk, tk: ineq(xk, uk, p, d, tk),
                                 X, _t(U, X), t)
        return torch.cat([Gx, Gu], dim=1)

    return CollocatedConstraints(value=value, jacobian=jacobian)
