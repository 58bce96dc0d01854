"""Plain reference of the ``race_car`` configuration.

The dynamic bicycle with Pacejka tyres in the curvilinear frame of PolyMPC's
``docs/source/img/car_model.cpp:44-90`` and ``applications.rst:283-340``:

    alpha_f = delta - atan2(vy + omega Lf, vx + 0.01)
    alpha_r = -atan2(vy - omega Lr, vx + 0.01)
    F_y = F_z D sin(C atan(B a - E (B a - atan(B a))))   (static axle loads)
    vx' = omega vy + (Fxf cos(delta) - Fyf sin(delta) + Fxr - Fdrag) / m
    vy' = -omega vx + (Fyf cos(delta) + Fxf sin(delta) + Fyr) / m
    omega' = (Lf (Fyf cos(delta) + Fxf sin(delta)) - Lr Fyr) / Iz
    s' = (vx cos(th) - vy sin(th)) / (1 - kappa(s) w)
    w' = vx sin(th) + vy cos(th),   th' = omega - kappa(s) s'

with Fdrag = (roll + Cxx vx^2) tanh(vx), and the track's curvature
kappa(s) = a sin(2 pi n s / length) sampled at equidistant points and
interpolated by the periodic cubic spline through them (car_model.cpp:33-39).
Stage cost: q_vx (vx - v_ref)^2 + q_vy vy^2 + q_omega omega^2 + q_w w^2
+ q_theta th^2 + r_delta delta^2 + r_fx (Fxf^2 + Fxr^2)
+ sigma (Fxr - Fxf)^2; Mayer q_w w^2 + q_theta th^2.
"""
from __future__ import annotations

import numpy as np
import torch

from ._collocation import CollocationNLP


def periodic_spline(x0, h, y):
    """(n, 4) Horner coefficients of the periodic cubic spline through the
    equidistant samples y[0..n] (the second derivatives from the cyclic
    tridiagonal system; y[n] closes the last segment)."""
    y = np.asarray(y, np.float64)
    n = len(y) - 1
    A = 4.0 * np.eye(n) + np.roll(np.eye(n), 1, axis=1) \
        + np.roll(np.eye(n), -1, axis=1)
    rhs = 6.0 / h ** 2 * (np.roll(y[:n], -1) - 2.0 * y[:n]
                          + np.roll(y[:n], 1))
    M = np.empty(n + 1)
    M[:n] = np.linalg.solve(A, rhs)
    M[n] = M[0]
    c = np.empty((n, 4))
    c[:, 0] = y[:n]
    c[:, 1] = (y[1:] - y[:n]) / h - h * (2.0 * M[:n] + M[1:]) / 6.0
    c[:, 2] = M[:n] / 2.0
    c[:, 3] = (M[1:] - M[:n]) / (6.0 * h)
    return c


class RaceCar:
    def __init__(self, cfg):
        m = cfg["model"]
        self.p = m["car"]
        self.q = m["weights"]
        tr = m["track"]
        s = np.linspace(0.0, tr["length"], tr["samples"])
        kap = tr["amplitude"] * np.sin(2.0 * np.pi * tr["waves"] * s
                                       / tr["length"])
        self.h_track = float(s[1] - s[0])
        self.coeffs = periodic_spline(0.0, self.h_track, kap)
        self._tables = {}
        self.v_ref = cfg["problem"]["d"][0]
        self.nx, self.nu = 6, 3

    def kappa(self, s):
        key = (s.dtype, s.device)
        tab = self._tables.get(key)
        if tab is None:
            tab = torch.as_tensor(self.coeffs, dtype=s.dtype, device=s.device)
            self._tables[key] = tab
        n = tab.shape[0]
        rel = torch.remainder(s / self.h_track, n)
        idx = torch.clamp(torch.floor(rel).long(), 0, n - 1)
        loc = (rel - idx) * self.h_track
        c = tab[idx]
        return c[..., 0] + loc * (c[..., 1] + loc * (c[..., 2] + loc * c[..., 3]))

    @staticmethod
    def _pacejka(Fz, a, B, C, D, E):
        Ba = B * a
        return Fz * D * torch.sin(C * torch.atan(Ba - E * (Ba - torch.atan(Ba))))

    def dynamics(self, x, u):
        p = self.p
        vx, vy, om, s, w, th = x[0], x[1], x[2], x[3], x[4], x[5]
        delta, fxf, fxr = u[0], u[1], u[2]
        L = p["Lf"] + p["Lr"]
        fzf = p["m"] * p["g"] * p["Lr"] / L
        fzr = p["m"] * p["g"] * p["Lf"] / L
        af = delta - torch.atan2(vy + om * p["Lf"], vx + 1e-2)
        ar = -torch.atan2(vy - om * p["Lr"], vx + 1e-2)
        fyf = self._pacejka(fzf, af, p["Bf"], p["Cf"], p["Df"], p["Ef"])
        fyr = self._pacejka(fzr, ar, p["Br"], p["Cr"], p["Dr"], p["Er"])
        drag = (p["roll_resist"] + p["Cxx"] * vx * vx) * torch.tanh(vx)
        cd, sd = torch.cos(delta), torch.sin(delta)
        vx_d = om * vy + (fxf * cd - fyf * sd + fxr - drag) / p["m"]
        vy_d = -om * vx + (fyf * cd + fxf * sd + fyr) / p["m"]
        om_d = (p["Lf"] * (fyf * cd + fxf * sd) - p["Lr"] * fyr) / p["Iz"]
        k = self.kappa(s)
        s_d = (vx * torch.cos(th) - vy * torch.sin(th)) / (1.0 - k * w)
        w_d = vx * torch.sin(th) + vy * torch.cos(th)
        return torch.stack([vx_d, vy_d, om_d, s_d, w_d, om - k * s_d])

    def _track(self, x):
        q = self.q
        return (q["q_vx"] * (x[0] - self.v_ref) ** 2 + q["q_vy"] * x[1] ** 2
                + q["q_omega"] * x[2] ** 2 + q["q_w"] * x[4] ** 2
                + q["q_theta"] * x[5] ** 2)

    def lagrange(self, x, u):
        q = self.q
        effort = (q["r_delta"] * u[0] ** 2
                  + q["r_fx"] * (u[1] ** 2 + u[2] ** 2)
                  + q["sigma_alloc"] * (u[2] - u[1]) ** 2)
        return self._track(x) + effort

    def mayer(self, x):
        return self.q["q_w"] * x[4] ** 2 + self.q["q_theta"] * x[5] ** 2


def nlp(cfg) -> CollocationNLP:
    p = cfg["problem"]
    return CollocationNLP(RaceCar(cfg), p["order"], p["segments"], p["t0"],
                          p["tf"], p.get("x_scale"), p.get("u_scale"))
