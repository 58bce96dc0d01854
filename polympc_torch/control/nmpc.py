"""Tracking NMPC controller — the port of polympc_tpu/control/nmpc.py.

The analogue of the reference's legacy ``nmpc`` class (src/nmpc.hpp:39+): a
setpoint/trajectory-tracking controller on the MPC facade.  It builds the
quadratic tracking OCP once; ``compute_control(x0)`` pins the measured
state and solves with warm starting.  The reference setpoint is runtime
static data (packed into ``d``), so changing it rebuilds nothing.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from polympc_torch.basis.basis import Chebyshev, SegmentedBasis
from polympc_torch.control.mpc import MPC
from polympc_torch.nlp.types import SQPSettings
from polympc_torch.ocp.ocp import OCP
from polympc_torch.qp.types import ADMMSettings

__all__ = ["tracking_ocp", "NMPC"]


def _quad(v, M):
    """v' M v for a numpy matrix M, made like v at each call."""
    return v @ torch.as_tensor(M, dtype=v.dtype, device=v.device) @ v


def tracking_ocp(dynamics: Callable, nx: int, nu: int,
                 Q=None, R=None, P=None, nd_extra: int = 0) -> OCP:
    """Quadratic tracking OCP: L = ||x - xs||_Q^2 + ||u - us||_R^2,
    Mayer = ||x - xs||_P^2.

    dynamics: (x, u, d_extra, t) -> (nx,) with d_extra the tail of the
    static data vector.  The setpoint (xs, us) occupies d[:nx+nu]; any
    model parameters follow (nd_extra of them).
    """
    Qm = np.eye(nx) if Q is None else np.asarray(Q, np.float64)
    Rm = np.eye(nu) if R is None else np.asarray(R, np.float64)
    Pm = Qm if P is None else np.asarray(P, np.float64)

    def dyn(x, u, p, d, t):
        return dynamics(x, u, d[nx + nu:], t)

    def lagrange(x, u, p, d, t):
        return _quad(x - d[:nx], Qm) + _quad(u - d[nx:nx + nu], Rm)

    def mayer(x, p, d):
        return _quad(x - d[:nx], Pm)

    return OCP(dynamics=dyn, nx=nx, nu=nu, nd=nx + nu + nd_extra,
               lagrange=lagrange, mayer=mayer)


class NMPC:
    """Setpoint-tracking NMPC (the nmpc.hpp user API)."""

    def __init__(self, dynamics: Callable, nx: int, nu: int,
                 tf: float = 1.0, Q=None, R=None, P=None,
                 mesh: SegmentedBasis | None = None,
                 d_extra=None,
                 x_scale=None, u_scale=None,
                 settings: SQPSettings | None = None,
                 device="cuda"):
        self.nx, self.nu = nx, nu
        d_extra = np.zeros(0) if d_extra is None else np.atleast_1d(d_extra)
        ocp = tracking_ocp(dynamics, nx, nu, Q=Q, R=R, P=P,
                           nd_extra=len(d_extra))
        if settings is None:
            settings = SQPSettings(
                hessian="exact", max_iter=60,
                qp=ADMMSettings(rho=1.0, eps_abs=1e-6, eps_rel=1e-6,
                                max_epochs=40, equil_iters=2))
        self.mpc = MPC(ocp, mesh or SegmentedBasis(Chebyshev(5), 2),
                       t0=0.0, tf=tf, settings=settings,
                       x_scale=x_scale, u_scale=u_scale, device=device)
        self._d_extra = d_extra
        self._xs = np.zeros(nx)
        self._us = np.zeros(nu)
        self._push_references()
        self._initialised = False

    def _push_references(self):
        self.mpc.set_static_parameters(
            np.concatenate([self._xs, self._us, self._d_extra]))

    # ---- nmpc.hpp-style API ----
    def set_reference(self, xs, us=None):
        """Track the setpoint xs (and optionally a feedforward us)."""
        self._xs = np.asarray(xs, np.float64)
        if us is not None:
            self._us = np.asarray(us, np.float64)
        self._push_references()

    def set_parameters(self, d_extra):
        self._d_extra = np.atleast_1d(np.asarray(d_extra, np.float64))
        self._push_references()

    def control_bounds(self, lbu, ubu):
        self.mpc.control_bounds(lbu, ubu)

    def state_bounds(self, lbx, ubx):
        self.mpc.state_bounds(lbx, ubx)

    def compute_control(self, x):
        """Pin the measured state, solve (warm-started), return u*(t0) as
        numpy and the solution."""
        x = np.asarray(x, np.float64)
        self.mpc.initial_conditions(x)
        if not self._initialised:
            self.mpc.x_guess(x)
            self.mpc.u_guess(self._us)
            self._initialised = True
        sol = self.mpc.solve()
        u0 = self.mpc.solution_u()[0].cpu().numpy()
        self._last = sol
        return u0, sol

    def optimal_trajectory(self):
        return self.mpc.solution_x()

    def solution_info(self):
        return self._last
