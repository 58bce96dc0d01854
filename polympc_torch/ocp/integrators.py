"""Explicit RK4 integration — the port of ``rk4_step`` and ``rk4_integrate``
in polympc_tpu/ocp/integrators.py (the reference's ``ODESolver`` RK4,
src/integration/integrator.cpp:68-111).  They are the plant of the closed
loops; the implicit, Radau, adaptive and pseudospectral integrators are
still to be ported.
"""
from __future__ import annotations

import torch

__all__ = ["rk4_step", "rk4_integrate"]


def rk4_step(f, x, u, t, h):
    """One classical Runge-Kutta-4 step (ref: integrator.cpp:68-91)."""
    k1 = f(x, u, t)
    k2 = f(x + 0.5 * h * k1, u, t + 0.5 * h)
    k3 = f(x + 0.5 * h * k2, u, t + 0.5 * h)
    k4 = f(x + h * k3, u, t + h)
    return x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


def rk4_integrate(f, x0, t0, tf, num_steps: int, u=None):
    """Integrate x' = f(x, u, t) over [t0, tf] with num_steps RK4 steps.

    u: None, a constant control vector, or a (num_steps, nu) sequence
    (zero-order hold per step).  Returns the (num_steps+1, nx) trajectory
    in the dtype and on the device of x0.
    """
    x = torch.as_tensor(x0)
    h = (tf - t0) / num_steps
    if u is None:
        U = x.new_zeros((num_steps, 0))
        f_ = lambda xx, u_, t: f(xx, None, t)
    else:
        u = torch.as_tensor(u, dtype=x.dtype, device=x.device)
        U = u.expand(num_steps, *u.shape) if u.ndim == 1 else u
        f_ = f
    traj = [x]
    for k in range(num_steps):
        x = rk4_step(f_, x, U[k], t0 + k * h, h)
        traj.append(x)
    return torch.stack(traj)
