"""CSTR (continuous stirred-tank reactor) setpoint-stabilisation benchmark —
the port of polympc_tpu/models/cstr.py.

Klatt-Engell reactor exactly as the reference benchmark poses it
(tests/control/cstr_control_test.cpp:40-110): NX=4 (c_A, c_B, T, T_K),
NU=2 (feed ratio u0, cooling power u1), Arrhenius kinetics, 100 s horizon.
Cost L = (x-xs)'Q(x-xs) + (u-us)'R(u-us), Mayer (x-xs)'P(x-xs).  The
numpy constants are the JAX package's, bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from polympc_torch.ocp.ocp import OCP

__all__ = ["cstr_ocp", "CSTR_XS", "CSTR_US", "CSTR_X0",
           "CSTR_ULB", "CSTR_UUB"]

CSTR_XS = np.array([2.1402105301746182, 1.0903043613077321,
                    114.19108442079495, 112.90659291045561])
CSTR_US = np.array([14.19, -1113.50])
CSTR_X0 = np.array([1.0, 0.5, 100.0, 100.0])
CSTR_ULB = np.array([3.0, -9000.0])
CSTR_UUB = np.array([35.0, 0.0])

_Q = np.diag([0.2, 1.0, 0.5, 0.2])
_R = np.diag([0.5, 5.0e-7])
_P = np.array([
    [1.4646778374584373, 0.6676889516721198, 0.35446715117028615, 0.10324422005086348],
    [0.6676889516721198, 1.407812935783267, 0.17788030743777067, 0.050059833257226405],
    [0.3544671511702861, 0.1778803074377706, 0.6336052592712396, 0.01110329497282364],
    [0.1032442200508634, 0.05005983325722643, 0.011103294972823655, 0.229412393739723],
])


def _cstr_rhs(x, u):
    """xdot of the reactor at one state x (4,) under u (2,)."""
    c_AO, v_0 = 5.1, 104.9
    k_w, A_R = 4032.0, 0.215
    rho, C_P, V_R = 0.9342, 3.01, 10.0
    H_1, H_2, H_3 = 4.2, -11.0, -41.85
    m_K, C_PK = 5.0, 2.0
    k10, k20, k30 = 1.287e12, 1.287e12, 9.043e9
    E1, E2, E3 = -9758.3, -9758.3, -8560.0
    per_h = 1.0 / 3600.0

    k_1 = k10 * torch.exp(E1 / (273.15 + x[2]))
    k_2 = k20 * torch.exp(E2 / (273.15 + x[2]))
    k_3 = k30 * torch.exp(E3 / (273.15 + x[2]))
    return per_h * torch.stack([
        u[0] * (c_AO - x[0]) - k_1 * x[0] - k_3 * x[0] * x[0],
        -u[0] * x[1] + k_1 * x[0] - k_2 * x[1],
        u[0] * (v_0 - x[2]) + (k_w * A_R / (rho * C_P * V_R)) * (x[3] - x[2])
        - (1.0 / (rho * C_P)) * (k_1 * x[0] * H_1 + k_2 * x[1] * H_2
                                 + k_3 * x[0] * x[1] * H_3),
        (1.0 / (m_K * C_PK)) * (u[1] + k_w * A_R * (x[2] - x[3])),
    ])


def _const(a, like):
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def cstr_ocp() -> OCP:
    def dynamics(x, u, p, d, t):
        return _cstr_rhs(x, u)

    def lagrange(x, u, p, d, t):
        dx, du = x - _const(CSTR_XS, x), u - _const(CSTR_US, u)
        return dx @ _const(_Q, x) @ dx + du @ _const(_R, u) @ du

    def mayer(x, p, d):
        dx = x - _const(CSTR_XS, x)
        return dx @ _const(_P, x) @ dx

    return OCP(dynamics=dynamics, nx=4, nu=2,
               lagrange=lagrange, mayer=mayer)
