"""Path-following NMPC (NMPF) problem augmentation — the port of
``augment_ocp`` in polympc_tpu/control/nmpf.py (the stateful ``NMPF``
controller is ported in slice 3).

The state is augmented with a virtual path state v = (s, s_dot),
v_dot = Av v + Bv u_v with Av = [[0,1],[0,0]], Bv = [0;1]
(nmpf.hpp:268-282): aug state dim nx+2, aug control dim nu+1.  Lagrange cost
||path(s) - output(x)||^2_Q + W (v_ref - s_dot)^2 + ||u_aug||^2_R; Mayer =
path residual (nmpf.hpp:336-358).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from polympc_torch.ocp.ocp import OCP

__all__ = ["augment_ocp"]


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
