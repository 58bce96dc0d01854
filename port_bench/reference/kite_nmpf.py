"""Plain reference of the ``kite_nmpf`` configuration.

The simple kinematic kite of PolyMPC's ``examples/kite.cpp:14-75`` (state
theta, phi, gamma; control u_gamma; tether L, gliding ratio E, wind ws),
its figure-eight path of ``kite_control_test.cpp:15-29`` and the NMPF
path-state augmentation of ``nmpf.hpp`` (virtual state s, s_dot with
s'' = u_v; cost |path(s) - (theta, phi)|^2 + W (v_ref - s_dot)^2 + |u|^2,
Mayer |path(s) - (theta, phi)|^2).  The rotation products of kite.cpp are
multiplied out: with the wind (ws, 0, 0) seen through R_GN (whose row uses
cos(phi) only, as coded there) and R_NK = rotation by gamma,

    theta' = (cos(g) w0 + sin(g) w1 - E w2) cos(g) / L
    phi'   = (cos(g) w0 + sin(g) w1 - E w2) sin(g) cos(theta) / L
    gamma' = u_gamma,
    (w0, w1, w2) = ws (-sin(th) cos(ph), -sin(th), -cos(th) cos(ph)).
"""
from __future__ import annotations

import torch

from ._collocation import CollocationNLP


class KiteNMPF:
    def __init__(self, cfg):
        m = cfg["model"]
        self.L, self.E, self.ws = m["L"], m["E"], m["ws"]
        self.h_path, self.a_path = m["path_theta0"], m["path_amplitude"]
        self.W = m["W"]
        self.v_ref = cfg["problem"]["d"][0]
        self.nx, self.nu = 5, 2

    def path(self, s):
        return torch.stack([self.h_path + self.a_path * torch.sin(2.0 * s),
                            4.0 * self.a_path * torch.cos(s)])

    def dynamics(self, x, u):
        th, ph, g, sd = x[0], x[1], x[2], x[4]
        w0 = self.ws * (-torch.sin(th) * torch.cos(ph))
        w1 = self.ws * (-torch.sin(th))
        w2 = self.ws * (-torch.cos(th) * torch.cos(ph))
        e0 = torch.cos(g) * w0 + torch.sin(g) * w1 - self.E * w2
        return torch.stack([torch.cos(g) * e0 / self.L,
                            torch.sin(g) * e0 * torch.cos(th) / self.L,
                            u[0], sd, u[1]])

    def _path_error(self, x):
        e = self.path(x[3]) - x[:2]
        return torch.sum(e * e)

    def lagrange(self, x, u):
        return (self._path_error(x) + self.W * (self.v_ref - x[4]) ** 2
                + torch.sum(u * u))

    def mayer(self, x):
        return self._path_error(x)


def nlp(cfg) -> CollocationNLP:
    p = cfg["problem"]
    return CollocationNLP(KiteNMPF(cfg), p["order"], p["segments"], p["t0"],
                          p["tf"], p.get("x_scale"), p.get("u_scale"))

