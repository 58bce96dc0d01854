"""General math utilities: quaternions, smooth switches, linear-system
analysis — the port of polympc_tpu/utils/polymath.py.

The reference's ``polymath`` namespace (src/polymath.h:25-341 /
polymath.cpp) in plain tensor ops (differentiable with ``torch.func``,
``vmap``-able); quaternions are (w, x, y, z) scalar-first, matching the
reference's layout.  ``LinearSystem`` carries controllability /
observability / stabilisability / detectability checks
(polymath.h:290-305): rank tests by SVD with a relative tolerance, and the
PBH eigenvector test for stabilisability and detectability, in numpy
float64 on the host.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

__all__ = [
    "t1_quat", "t2_quat", "t3_quat", "quat_multiply", "quat_inverse",
    "quat_transform", "heaviside", "deg2rad", "rk4_step_fn",
    "LinearSystem", "controllability_matrix", "observability_matrix",
]


# ---- quaternion algebra (polymath.cpp:20-48) ----

def _axis_quat(ang, axis):
    ang = torch.as_tensor(ang)
    half = -0.5 * ang
    z = torch.zeros_like(half)
    v = [z, z, z]
    v[axis] = torch.sin(half)
    return torch.stack([torch.cos(half), *v])


def t1_quat(ang):
    """Unit quaternion for a rotation of -ang about the body x-axis
    (polymath.cpp:20: frame-transform convention, hence the minus)."""
    return _axis_quat(ang, 0)


def t2_quat(ang):
    return _axis_quat(ang, 1)


def t3_quat(ang):
    return _axis_quat(ang, 2)


def quat_multiply(q1, q2):
    """Hamilton product, scalar-first (polymath.cpp:24-36)."""
    s1, v1 = q1[0], q1[1:4]
    s2, v2 = q2[0], q2[1:4]
    s = s1 * s2 - v1 @ v2
    v = torch.linalg.cross(v1, v2) + s1 * v2 + s2 * v1
    return torch.cat([s[None], v])


def quat_inverse(q):
    """Conjugate (= inverse for unit quaternions, polymath.cpp:38-42)."""
    return torch.cat([q[:1], -q[1:4]])


def quat_transform(q_ba, a_vect):
    """Rotate vector a (frame a) into frame b: Im(q * (0,a) * q^-1)
    (polymath.cpp:44-48)."""
    av = torch.cat([torch.zeros_like(q_ba[:1]), a_vect.to(q_ba.dtype)])
    return quat_multiply(q_ba, quat_multiply(av, quat_inverse(q_ba)))[1:4]


# ---- scalar helpers ----

def heaviside(x, k: float = 1.0):
    """Smooth heaviside: k / (1 + exp(-4x)) (polymath.cpp:52-55)."""
    return k / (1.0 + torch.exp(-4.0 * torch.as_tensor(x)))


def deg2rad(deg):
    return (math.pi / 180.0) * deg


def rk4_step_fn(f, h):
    """Return a one-step RK4 map (x, u) -> x_next for dynamics f(x, u)
    (the analogue of rk4_symbolic, polymath.cpp:57-72)."""
    def step(x, u):
        k1 = f(x, u)
        k2 = f(x + 0.5 * h * k1, u)
        k3 = f(x + 0.5 * h * k2, u)
        k4 = f(x + h * k3, u)
        return x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    return step


# ---- linear-system analysis (polymath.h:290-305) ----

def controllability_matrix(F, G):
    """[G, FG, ..., F^{n-1}G], shape (n, n*m)."""
    F = torch.as_tensor(F)
    G = torch.as_tensor(G, dtype=F.dtype, device=F.device)
    blocks = [G]
    for _ in range(F.shape[0] - 1):
        blocks.append(F @ blocks[-1])
    return torch.cat(blocks, dim=1)


def observability_matrix(F, H):
    """[H; HF; ...; HF^{n-1}], shape (n*p, n)."""
    F = torch.as_tensor(F)
    H = torch.as_tensor(H, dtype=F.dtype, device=F.device)
    blocks = [H]
    for _ in range(F.shape[0] - 1):
        blocks.append(blocks[-1] @ F)
    return torch.cat(blocks, dim=0)


def _host(M):
    if isinstance(M, torch.Tensor):
        M = M.detach().cpu().numpy()
    return np.asarray(M, np.float64)


def _rank(M, rtol=1e-9):
    s = np.linalg.svd(_host(M), compute_uv=False)
    if s.size == 0:
        return 0
    return int(np.sum(s > rtol * s[0]))


@dataclasses.dataclass(frozen=True)
class LinearSystem:
    """xdot = F x + G u, y = H x (polymath.h:290-305)."""
    F: np.ndarray
    G: np.ndarray
    H: np.ndarray | None = None

    def is_controllable(self) -> bool:
        n = _host(self.F).shape[0]
        return _rank(controllability_matrix(_host(self.F),
                                            _host(self.G))) == n

    def is_observable(self) -> bool:
        if self.H is None:
            raise ValueError("output map H required for observability")
        n = _host(self.F).shape[0]
        return _rank(observability_matrix(_host(self.F),
                                          _host(self.H))) == n

    def is_stabilizable(self) -> bool:
        """PBH: rank [F - lambda I, G] = n for every unstable eigenvalue
        (Re lambda >= 0)."""
        F, G = _host(self.F), _host(self.G)
        n = F.shape[0]
        for lam in np.linalg.eigvals(F):
            if lam.real >= -1e-12:
                M = np.concatenate([F - lam * np.eye(n), G], axis=1)
                if _rank(M) < n:
                    return False
        return True

    def is_detectable(self) -> bool:
        """PBH dual: rank [F - lambda I; H] = n for every unstable mode."""
        if self.H is None:
            raise ValueError("output map H required for detectability")
        F, H = _host(self.F), _host(self.H)
        n = F.shape[0]
        for lam in np.linalg.eigvals(F):
            if lam.real >= -1e-12:
                M = np.concatenate([F - lam * np.eye(n), H], axis=0)
                if _rank(M) < n:
                    return False
        return True
