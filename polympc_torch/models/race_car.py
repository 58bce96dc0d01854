"""Race-car path-following models — the port of
polympc_tpu/models/race_car.py.

Dynamic bicycle model with Pacejka magic-formula tyres, in the Cartesian and
curvilinear (track) frames, plus the rate-constrained augmented variant
(docs/source/img/car_model.cpp:44-90, applications.rst:283-340 and
520-575).  This is the model of the reference's headline NMPC benchmark.

States (curvilinear, NX=6):  x = [v_x, v_y, omega, s, w, theta_e]
Controls (NU=3):             u = [delta, F_xf, F_xr]
Rate-augmented (NX=10):      xi = [x..., delta, delta_d, F_xf, F_xr],
                             v  = [delta_dot, F_xf_dot, F_xr_dot].

Every function takes tensors; states and controls index their last axis,
so a function acts on one node (as the transcription's ``vmap`` calls it)
or on a batch.  The track curvature kappa(s) enters through a cubic spline
(basis/splines.py), the reference's ``EquidistantCubicSpline`` lookup
(car_model.cpp:33-39).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from polympc_torch.basis.splines import CubicSpline, fit_cubic_spline
from polympc_torch.ocp.ocp import OCP

__all__ = [
    "CarParams", "pacejka_lateral_force", "lateral_forces",
    "car_body_accels", "car_dynamics_cartesian", "car_dynamics_curvilinear",
    "car_dynamics_rate_augmented", "race_car_ocp", "make_wave_track",
]


@dataclasses.dataclass(frozen=True)
class CarParams:
    """Bicycle-model parameters: a generic full-size race car, every field a
    constant assumed in car_model.cpp ("L_r, L_f, Cxx, tire parameters")."""
    m: float = 1500.0        # mass [kg]
    Iz: float = 2250.0       # yaw inertia [kg m^2]
    Lf: float = 1.2          # CoG -> front axle [m]
    Lr: float = 1.4          # CoG -> rear axle [m]
    # Pacejka magic-formula coefficients, front / rear axle
    Bf: float = 10.0
    Cf: float = 1.9
    Df: float = 1.0          # peak friction coefficient (Fy = Fz*D*sin(...))
    Ef: float = 0.97
    Br: float = 10.0
    Cr: float = 1.9
    Dr: float = 1.0
    Er: float = 0.97
    Cxx: float = 0.35        # aero drag: F = Cxx * v_x^2 [N s^2/m^2]
    roll_resist: float = 50.0  # rolling resistance [N]
    g: float = 9.81


def pacejka_lateral_force(Fz, alpha, B, C, D, E):
    """Magic formula: Fy = Fz D sin(C atan(B a - E (B a - atan(B a))))
    (applications.rst:316-323)."""
    Ba = B * alpha
    return Fz * D * torch.sin(C * torch.atan(Ba - E * (Ba - torch.atan(Ba))))


def lateral_forces(p: CarParams, vx, vy, omega, delta):
    """Front/rear slip angles and Pacejka lateral forces
    (car_model.cpp:11-28; slip-angle model applications.rst:329-336).

    Static axle loads: Fzf = m g Lr/(Lf+Lr), Fzr = m g Lf/(Lf+Lr).
    """
    L = p.Lf + p.Lr
    Fzf = p.m * p.g * p.Lr / L
    Fzr = p.m * p.g * p.Lf / L
    # small vx regularisation keeps the slip angle defined at standstill
    # (the reference adds 0.01 to vx, car_model.cpp:20-21)
    alpha_f = delta - torch.atan2(vy + omega * p.Lf, vx + 1e-2)
    alpha_r = -torch.atan2(vy - omega * p.Lr, vx + 1e-2)
    Fyf = pacejka_lateral_force(Fzf, alpha_f, p.Bf, p.Cf, p.Df, p.Ef)
    Fyr = pacejka_lateral_force(Fzr, alpha_r, p.Br, p.Cr, p.Dr, p.Er)
    return Fyf, Fyr, alpha_f, alpha_r


def car_body_accels(p: CarParams, vx, vy, omega, delta, Fxf, Fxr):
    """Body-frame accelerations (vx_dot, vy_dot, omega_dot)
    (applications.rst:287-292; car_model.cpp:76-78).  Drag acts against
    the direction of motion, its sign smoothed with tanh so the model stays
    C^1 for second-order derivatives."""
    Fyf, Fyr, _, _ = lateral_forces(p, vx, vy, omega, delta)
    Fdrag = (p.roll_resist + p.Cxx * vx * vx) * torch.tanh(vx)
    vx_dot = omega * vy + (Fxf * torch.cos(delta) - Fyf * torch.sin(delta)
                           + Fxr - Fdrag) / p.m
    vy_dot = -omega * vx + (Fyf * torch.cos(delta) + Fxf * torch.sin(delta)
                            + Fyr) / p.m
    omega_dot = (p.Lf * (Fyf * torch.cos(delta) + Fxf * torch.sin(delta))
                 - p.Lr * Fyr) / p.Iz
    return vx_dot, vy_dot, omega_dot


def car_dynamics_cartesian(x, u, p: CarParams):
    """Cartesian-frame bicycle: x = [vx, vy, omega, X, Y, psi]
    (applications.rst:287-292)."""
    vx, vy, omega, _, _, psi = x.unbind(-1)
    delta, Fxf, Fxr = u.unbind(-1)
    vx_dot, vy_dot, omega_dot = car_body_accels(p, vx, vy, omega,
                                                delta, Fxf, Fxr)
    return torch.stack([
        vx_dot, vy_dot, omega_dot,
        vx * torch.cos(psi) - vy * torch.sin(psi),
        vx * torch.sin(psi) + vy * torch.cos(psi),
        omega,
    ], dim=-1)


def car_dynamics_curvilinear(x, u, kappa: Callable, p: CarParams):
    """Curvilinear (track) frame bicycle: x = [vx, vy, omega, s, w, theta_e]
    (car_model.cpp:80-83; applications.rst:360-370):

        s_dot     = (vx cos(th) - vy sin(th)) / (1 - kappa(s) w)
        w_dot     =  vx sin(th) + vy cos(th)
        theta_dot =  omega - kappa(s) s_dot
    """
    vx, vy, omega, s, w, th = x.unbind(-1)
    delta, Fxf, Fxr = u.unbind(-1)
    vx_dot, vy_dot, omega_dot = car_body_accels(p, vx, vy, omega,
                                                delta, Fxf, Fxr)
    kap = kappa(s)
    s_dot = (vx * torch.cos(th) - vy * torch.sin(th)) / (1.0 - kap * w)
    w_dot = vx * torch.sin(th) + vy * torch.cos(th)
    th_dot = omega - kap * s_dot
    return torch.stack([vx_dot, vy_dot, omega_dot, s_dot, w_dot, th_dot],
                       dim=-1)


def car_dynamics_rate_augmented(xi, v, kappa: Callable, p: CarParams,
                                Td: float = 0.05):
    """Rate-constrained augmentation (applications.rst:520-545):

        xi = [vx, vy, omega, s, w, theta, delta, delta_d, Fxf, Fxr]
        v  = [delta_dot, Fxf_dot, Fxr_dot]

    The body dynamics are driven by the delayed steering delta_d with the
    first-order lag delta_d_dot = (delta - delta_d)/Td; forces become
    states, controls become their rates.
    """
    x6 = xi[..., :6]
    delta, delta_d, Fxf, Fxr = xi[..., 6:].unbind(-1)
    u_eff = torch.stack([delta_d, Fxf, Fxr], dim=-1)
    xdot6 = car_dynamics_curvilinear(x6, u_eff, kappa, p)
    v0, v1, v2 = v.unbind(-1)
    return torch.cat([
        xdot6,
        torch.stack([v0, (delta - delta_d) / Td, v1, v2], dim=-1),
    ], dim=-1)


def race_car_ocp(kappa: Callable, params: CarParams | None = None,
                 q_vx: float = 0.5, q_w: float = 20.0, q_theta: float = 5.0,
                 q_vy: float = 0.05, q_omega: float = 0.1,
                 r_delta: float = 1.0, r_fx: float = 1e-6,
                 sigma_alloc: float = 1e-6,
                 rate_augmented: bool = False, Td: float = 0.05,
                 r_rate=(0.5, 1e-7, 1e-7)) -> OCP:
    """Path-following race-car OCP (applications.rst:555-575).

    Stage cost: velocity-profile tracking (vx - vx_ref)^2 + centerline
    deviation w^2 + heading error theta^2 + control effort + a force-
    allocation penalty sigma (Fxr - Fxf)^2.  vx_ref is the static data
    parameter d[0] (the coarse planner's reference velocity).
    """
    p = params or CarParams()

    def track(x, vx_ref):
        return (q_vx * (x[0] - vx_ref) ** 2 + q_vy * x[1] ** 2
                + q_omega * x[2] ** 2 + q_w * x[4] ** 2
                + q_theta * x[5] ** 2)

    def mayer(x, pp, d):
        return q_w * x[4] ** 2 + q_theta * x[5] ** 2

    if not rate_augmented:
        def dynamics(x, u, pp, d, t):
            return car_dynamics_curvilinear(x, u, kappa, p)

        def lagrange(x, u, pp, d, t):
            effort = (r_delta * u[0] ** 2
                      + r_fx * (u[1] ** 2 + u[2] ** 2)
                      + sigma_alloc * (u[2] - u[1]) ** 2)
            return track(x, d[0]) + effort

        return OCP(dynamics=dynamics, nx=6, nu=3, nd=1,
                   lagrange=lagrange, mayer=mayer)

    def dynamics(x, u, pp, d, t):
        return car_dynamics_rate_augmented(x, u, kappa, p, Td=Td)

    def lagrange(x, u, pp, d, t):
        effort = (r_delta * x[6] ** 2
                  + r_fx * (x[8] ** 2 + x[9] ** 2)
                  + sigma_alloc * (x[9] - x[8]) ** 2)
        rates = r_rate[0] * u[0] ** 2 + r_rate[1] * u[1] ** 2 \
            + r_rate[2] * u[2] ** 2
        return track(x, d[0]) + effort + rates

    return OCP(dynamics=dynamics, nx=10, nu=3, nd=1,
               lagrange=lagrange, mayer=mayer)


def make_wave_track(length: float = 200.0, amplitude: float = 0.02,
                    waves: int = 3, n_samples: int = 201,
                    device="cuda") -> CubicSpline:
    """A periodic test track: curvature kappa(s) = amplitude*sin(2*pi*waves*
    s/length), fitted as an equidistant cubic spline (car_model.cpp:33-39)
    whose table lives on ``device``."""
    s = np.linspace(0.0, length, n_samples)
    kap = amplitude * np.sin(2.0 * np.pi * waves * s / length)
    return fit_cubic_spline(0.0, s[1] - s[0], kap, periodic=True,
                            device=device)
