"""Optimal-control problem definition (the port of polympc_tpu/ocp/ocp.py).

The problem is a frozen dataclass of pure callables + static dims:

    min   integral_{t0}^{tf} L(x,u,p,d,t) dt  +  M(x(tf),p,d)
    s.t.  dx/dt = f(x,u,p,d,t)
          gl <= g(x,u,p,d,t) <= gu       (ng per-node inequality constraints)
          box bounds on x, u, p

The callables act on ONE node: x (nx,), u (nu,), p (np_,), d (nd,), t a
0-dim tensor.  Transcription applies them to every node of every lane at
once with ``torch.func.vmap``, and differentiates them with
``torch.func.jacrev``/``grad``, so they must be written in plain tensor ops
(no in-place writes, no Python branching on values).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional


@dataclasses.dataclass(frozen=True)
class OCP:
    dynamics: Callable               # (x, u, p, d, t) -> (nx,)
    nx: int
    nu: int
    np_: int = 0
    nd: int = 0
    ng: int = 0
    lagrange: Optional[Callable] = None   # (x, u, p, d, t) -> scalar
    mayer: Optional[Callable] = None      # (x, p, d) -> scalar (at t = tf)
    ineq: Optional[Callable] = None       # (x, u, p, d, t) -> (ng,)
    # trajectory-level hooks on one lane's whole horizon
    # (X (N, nx), U (N, nu), P, d, t (N,), ops: SpectralOps)
    trajectory_cost: Optional[Callable] = None
    trajectory_ineq: Optional[Callable] = None
    ntg: int = 0

    def __post_init__(self):
        if (self.ineq is None) != (self.ng == 0):
            raise ValueError("ineq callable and ng must be consistent")
        if (self.trajectory_ineq is None) != (self.ntg == 0):
            raise ValueError("trajectory_ineq and ntg must be consistent")
