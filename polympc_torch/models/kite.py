"""Simple kinematic kite ("tricycle on a sphere") benchmark model — the port
of polympc_tpu/models/kite.py.

Reference model: examples/kite.cpp:14-75 (SimpleKinematicKite), state
(theta elevation, phi azimuth, gamma heading), control u_gamma; parameters
tether length L=5, gliding ratio E=5, wind speed ws=3, reel speed z=0.
Output map H x = (theta, phi) (kite.cpp:62-65).  The rotation-matrix entries
reproduce the reference *as coded*, like the JAX model.

Figure-eight path (kite_control_test.cpp:15-29):
    theta_p(s) = pi/6 + 0.2 sin(2 s),  phi_p(s) = 0.8 cos(s).

``kite_ocp`` is the plain tracking OCP on this model (the reference
output passed as static data d); ``headline.kite_ocp`` is bench.py's
augmented path-following NMPF kite.

The functions act on one node (x (3,), u (1,)); transcription maps them over
nodes and lanes with ``torch.func.vmap``.
"""
from __future__ import annotations

import math

import torch

from polympc_torch.ocp.ocp import OCP

__all__ = ["kite_dynamics", "kite_output", "kite_path", "kite_ocp"]


def kite_dynamics(x, u, L: float = 5.0, E: float = 5.0, ws: float = 3.0):
    """xdot for the simple kinematic kite (kite.cpp:30-54)."""
    theta, phi, gamma = x[0], x[1], x[2]
    st, ct = torch.sin(theta), torch.cos(theta)
    sp, cp = torch.sin(phi), torch.cos(phi)
    sg, cg = torch.sin(gamma), torch.cos(gamma)
    del sp  # the reference's R_GN row uses cos(phi) only

    # R_GN' vw = ws * (-st*cp, -st, -ct*cp), vw = (ws, 0, 0)
    w0, w1, w2 = ws * (-st * cp), ws * (-st), ws * (-ct * cp)
    # R_NK' w: R_NK = eye with top-left 2x2 = R(gamma)
    r0 = cg * w0 + sg * w1
    r2 = w2
    # EM @ (.) = (v0 - E*v2, 0)
    e0 = r0 - E * r2
    e1 = torch.zeros_like(e0)
    # Rb_NK @ e
    q0 = cg * e0 - sg * e1
    q1 = sg * e0 + cg * e1
    # M @ r, M = diag(1/L, cos(theta)/L)
    return torch.stack([q0 / L, q1 * ct / L, u[0]])


def kite_output(x):
    """Output map H x = (theta, phi) (kite.cpp:62-65)."""
    return x[:2]


def kite_path(s):
    """Lemniscate-like figure on the sphere (kite_control_test.cpp:15-29)."""
    h = math.pi / 6.0
    a = 0.2
    return torch.stack([h + a * torch.sin(2.0 * s), 4.0 * a * torch.cos(s)])


def kite_ocp(q: float = 1.0, r: float = 0.1) -> OCP:
    """Plain tracking OCP on the kite (for batched-solve benchmarks):
    L = q*||output(x) - ref||^2 + r*u^2, Mayer q*||output(x) - ref||^2,
    ref passed as static data d (nd = 2)."""
    def dynamics(x, u, p, d, t):
        return kite_dynamics(x, u)

    def lagrange(x, u, p, d, t):
        e = kite_output(x) - d[:2]
        return q * (e @ e) + r * (u @ u)

    def mayer(x, p, d):
        e = kite_output(x) - d[:2]
        return q * (e @ e)

    return OCP(dynamics=dynamics, nx=3, nu=1, nd=2,
               lagrange=lagrange, mayer=mayer)
