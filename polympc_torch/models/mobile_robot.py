"""Mobile-robot (kinematic car) benchmark models — the port of
polympc_tpu/models/mobile_robot.py.

Reference models from tests/control/mpc_wrapper_test.cpp:47-79 and
tests/control/minimal_time_test.cpp:40-64:

    dx = v cos(theta) cos(phi);  dy = v sin(theta) cos(phi)
    dtheta = v sin(phi) / d                     (d = wheelbase)

RobotOCP: tracking — L = x'Qx + u'Ru, Mayer = x'Qx (regulation to origin).
ParkingOCP: minimum time — dynamics scaled by free parameter p0, Mayer = p0.
The callables act on one node (x (3,), u (2,)).
"""
from __future__ import annotations

import torch

from polympc_torch.ocp.ocp import OCP

__all__ = ["robot_ocp", "parking_ocp"]


def _robot_rhs(x, u, d):
    wheel_base = d[0]
    v, phi = u[0], u[1]
    theta = x[2]
    return torch.stack([
        v * torch.cos(theta) * torch.cos(phi),
        v * torch.sin(theta) * torch.cos(phi),
        v * torch.sin(phi) / wheel_base,
    ])


def robot_ocp(q: float = 1.0, r: float = 1.0, qm: float = 1.0) -> OCP:
    """Tracking OCP (RobotOCP, mpc_wrapper_test.cpp:56-79): nd=1 wheelbase."""
    def dynamics(x, u, p, d, t):
        return _robot_rhs(x, u, d)

    def lagrange(x, u, p, d, t):
        return q * (x @ x) + r * (u @ u)

    def mayer(x, p, d):
        return qm * (x @ x)

    return OCP(dynamics=dynamics, nx=3, nu=2, nd=1,
               lagrange=lagrange, mayer=mayer)


def parking_ocp(nonlinear_constraint: bool = False) -> OCP:
    """Minimum-time parking OCP (minimal_time_test.cpp:40-64): time-scaled
    dynamics on a fixed [0,1] horizon, Mayer = p0 (the time scaling).

    nonlinear_constraint adds g0 = u0^2 * cos(u1), NG=1
    (nonlinear_constraints_test.cpp:63-70).
    """
    def dynamics(x, u, p, d, t):
        return p[0] * _robot_rhs(x, u, d)

    def mayer(x, p, d):
        return p[0]

    ineq = None
    ng = 0
    if nonlinear_constraint:
        def ineq(x, u, p, d, t):
            return (u[0] ** 2 * torch.cos(u[1]))[None]
        ng = 1

    return OCP(dynamics=dynamics, nx=3, nu=2, np_=1, nd=1,
               mayer=mayer, ineq=ineq, ng=ng)
