"""Path-following NMPC (NMPF) — the port of polympc_tpu/control/nmpf.py
(the reference's ``nmpf`` class, src/nmpf.hpp:19-606).

  1. ``augment_ocp``: the state is augmented with a virtual path state
     v = (s, s_dot), v_dot = Av v + Bv u_v with Av = [[0,1],[0,0]],
     Bv = [0;1] (nmpf.hpp:268-282): aug state dim nx+2, aug control dim
     nu+1.  Lagrange cost ||path(s) - output(x)||^2_Q + W (v_ref - s_dot)^2
     + ||u_aug||^2_R; Mayer = path residual (nmpf.hpp:336-358);
  2. ``NMPF``: the stateful controller on the MPC facade.  Each
     ``compute_control`` (nmpf.hpp:433-501) pins the measured state, wraps
     the virtual path state when it passes the path period (shifting the
     warm start's s column with it) and boxes the virtual states by
     +-flexibility; ``find_closest_point_on_path`` projects a point onto
     the path by a 256-point grid and 5 clipped Newton steps.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from torch.func import grad, vmap

from polympc_torch.basis.basis import Chebyshev, SegmentedBasis
from polympc_torch.control.mpc import MPC
from polympc_torch.nlp.types import SQPSettings
from polympc_torch.ocp.ocp import OCP
from polympc_torch.ocp.transcription import pack_z
from polympc_torch.qp.types import ADMMSettings

__all__ = ["NMPF", "augment_ocp"]


def _quad(v, Mnp):
    """v' M v; M None is the identity."""
    if Mnp is None:
        return torch.sum(v * v)
    M = torch.as_tensor(Mnp, dtype=v.dtype, device=v.device)
    return v @ M @ v


def augment_ocp(dynamics: Callable, output: Callable, path: Callable,
                nx: int, nu: int, ny: int,
                Q=None, R=None, W: float = 1.0) -> OCP:
    """Build the augmented path-following OCP.

    dynamics: (x, u) -> xdot ;  output: x -> y (ny,) ;  path: s -> (ny,).
    Static data d = [v_ref]; aug state (x, s, s_dot), aug control (u, u_v).
    """
    Qm = None if Q is None else np.asarray(Q, np.float64)
    Rm = None if R is None else np.asarray(R, np.float64)

    def aug_dynamics(xa, ua, p, d, t):
        x, v = xa[:nx], xa[nx:]
        xdot = dynamics(x, ua[:nu])
        return torch.cat([xdot, torch.stack([v[1], ua[nu]])])

    def lagrange(xa, ua, p, d, t):
        x, v = xa[:nx], xa[nx:]
        res = path(v[0]) - output(x)
        return _quad(res, Qm) + W * (d[0] - v[1]) ** 2 + _quad(ua, Rm)

    def mayer(xa, p, d):
        x, v = xa[:nx], xa[nx:]
        return _quad(path(v[0]) - output(x), Qm)

    return OCP(dynamics=aug_dynamics, nx=nx + 2, nu=nu + 1, nd=1,
               lagrange=lagrange, mayer=mayer)


class NMPF:
    """Stateful path-following controller (the nmpf.hpp user API)."""

    def __init__(self, dynamics, output, path, nx, nu, ny,
                 tf: float = 2.0,
                 mesh: SegmentedBasis | None = None,
                 Q=None, R=None, W: float = 1.0,
                 path_period: float = 2.0 * np.pi,
                 flexibility: float = 0.1,
                 settings: SQPSettings | None = None,
                 device="cuda"):
        self.nx, self.nu, self.ny = nx, nu, ny
        self.path = path
        self.output = output
        self.period = path_period
        self.flex = flexibility
        ocp = augment_ocp(dynamics, output, path, nx, nu, ny, Q=Q, R=R, W=W)
        if settings is None:
            settings = SQPSettings(
                hessian="exact", max_iter=60,
                qp=ADMMSettings(rho=1.0, eps_abs=1e-6, eps_rel=1e-6,
                                max_epochs=40, equil_iters=4))
        self.mpc = MPC(ocp, mesh or SegmentedBasis(Chebyshev(5), 2),
                       t0=0.0, tf=tf, settings=settings, device=device)
        self.mpc.set_static_parameters([0.05])
        self._initialised = False
        self._grid = torch.linspace(0.0, path_period, 256,
                                    dtype=torch.float64,
                                    device=self.mpc.device)

    def set_reference_velocity(self, v_ref: float):
        self.mpc.set_static_parameters([v_ref])

    def control_bounds(self, lbu, ubu):
        """Bounds on the augmented control (u, u_v) (setLBU/setUBU)."""
        self.mpc.control_bounds(lbu, ubu)

    def state_bounds(self, lbx, ubx):
        """Bounds on the augmented state (x, s, s_dot) (setLBX/setUBX)."""
        self.mpc.state_bounds(lbx, ubx)

    def find_closest_point_on_path(self, point):
        """The path parameter s minimising ||path(s) - point||^2 (nmpf.hpp
        findClosestPointOnPath): the best of 256 grid points on
        [0, period], then 5 Newton steps clipped to 0.1 period."""
        point = torch.as_tensor(point, dtype=torch.float64,
                                device=self.mpc.device)

        def f(s, pt):
            return torch.sum((self.path(s) - pt) ** 2)
        d2 = vmap(f, in_dims=(0, None))(self._grid, point)
        s = self._grid[torch.argmin(d2)]
        df = grad(f)
        ddf = grad(df)
        lim = 0.1 * self.period
        for _ in range(5):
            h = ddf(s, point)
            step = df(s, point) / torch.where(torch.abs(h) > 1e-9, h,
                                              torch.ones_like(h))
            s = s - torch.clamp(step, -lim, lim)
        return float(s)

    def compute_control(self, x):
        """One NMPF step (nmpf.hpp:433-501): returns the optimal augmented
        control at the current state (numpy) and the solution."""
        x = np.asarray(x, np.float64)
        if x.shape[0] == self.nx:
            # initialise the virtual state by projecting the system output
            # onto the path (nmpf.hpp findClosestPointOnPath)
            y = self.output(torch.as_tensor(x, device=self.mpc.device))
            s0 = self.find_closest_point_on_path(y)
            xa = np.concatenate([x, [s0, 0.0]])
        else:
            xa = x.copy()

        # wrap the path parameter into [0, period); the warm start's s
        # column shifts with it so the previous solution stays consistent
        # (nmpf.hpp:444-454 shifts NLP_X's s entries)
        shift = 0.0
        if xa[self.nx] >= self.period:
            shift = -self.period
        elif xa[self.nx] < 0.0:
            shift = self.period
        if shift:
            xa[self.nx] += shift
            if self._initialised:
                X, U, P = self.mpc._split(self.mpc._z)
                sxs = float(self.mpc.tr.x_scale[self.nx])
                X = X.clone()
                X[:, self.nx] += shift / sxs
                self.mpc._z = pack_z(X, U, P)

        # pin the physical states exactly, box the virtual states (s, s_dot)
        # by +-flexibility (nmpf.hpp:456-466)
        relax = np.zeros(self.nx + 2)
        relax[self.nx:] = self.flex
        self.mpc.initial_conditions(xa, relax=relax)
        if not self._initialised:
            self.mpc.x_guess(xa)
            self._initialised = True
        sol = self.mpc.solve()
        u = self.mpc.solution_u()[0].cpu().numpy()
        self._last = sol
        return u, sol

    def optimal_trajectory(self):
        return self.mpc.solution_x()

    def solution_info(self):
        return self._last
