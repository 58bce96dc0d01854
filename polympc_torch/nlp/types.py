"""NLP problem definition and SQP settings/solution containers (the port of
polympc_tpu/nlp/types.py), batch-first.

Problem form, one per lane:

    min_x  f(x, p)
    s.t.   c_e(x, p)  = 0                    (ne equality constraints)
           gl <= c_i(x, p) <= gu             (ni general inequality)
           lbx <= x <= ubx                   (box)

Every callable takes x (B, n) and returns per-lane results: cost (B,),
eq (B, ne), ineq (B, ni), cost_grad (B, n), eq_jac (B, ne, n),
ineq_jac (B, ni, n), lag_hessian(x, lam (B, m), p) (B, n, n).  ``p`` is a
dict of tensors shared by all lanes.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from polympc_torch.qp.types import ADMMSettings

__all__ = ["NLP", "NLPBounds", "SQPSettings", "SQPSolution", "unbounded"]


@dataclasses.dataclass(frozen=True)
class NLP:
    cost: Callable
    n: int
    eq: Optional[Callable] = None
    ineq: Optional[Callable] = None
    ne: int = 0
    ni: int = 0
    gn_hessian: Optional[Callable] = None
    cost_grad: Optional[Callable] = None
    eq_jac: Optional[Callable] = None
    ineq_jac: Optional[Callable] = None
    lag_hessian: Optional[Callable] = None
    block_structure: Optional[tuple] = None   # (N, nx, nu, np_)

    def __post_init__(self):
        if (self.eq is None) != (self.ne == 0):
            raise ValueError("eq callable and ne must be consistent")
        if (self.ineq is None) != (self.ni == 0):
            raise ValueError("ineq callable and ni must be consistent")

    @property
    def m(self) -> int:
        return self.ne + self.ni


class NLPBounds(NamedTuple):
    """Bounds; each tensor is (n,)/(ni,) shared by all lanes or (B, n)/(B, ni)
    per lane."""
    lbx: torch.Tensor
    ubx: torch.Tensor
    gl: torch.Tensor
    gu: torch.Tensor


def unbounded(nlp: NLP, dtype=torch.float64, device="cuda") -> NLPBounds:
    """Infinite bounds on every variable and inequality row, shared by all
    lanes: lbx, ubx (n,), gl, gu (ni,)."""
    inf = float("inf")
    full = lambda size, v: torch.full((size,), v, dtype=dtype, device=device)
    return NLPBounds(lbx=full(nlp.n, -inf), ubx=full(nlp.n, inf),
                     gl=full(nlp.ni, -inf), gu=full(nlp.ni, inf))


@dataclasses.dataclass(frozen=True)
class SQPSettings:
    """SQP settings (defaults mirror sqp_base.hpp:24-47), the fields of the
    JAX package's ``SQPSettings``.  ``trace_iters`` > 0 records (cost,
    violation, primal step, dual step) for the first ``trace_iters``
    iterations of each lane in ``SQPSolution.trace``."""
    max_iter: int = 100
    ls_max_iter: int = 10
    tau: float = 0.5
    eta: float = 0.25
    eps_prim: float = 1e-3
    eps_dual: float = 1e-3
    eps_viol: float = 1e-4
    eps_stat: float = 1e-3
    hessian: str = "bfgs"
    reg: str = "eigen"
    reg_eps: float = 1e-6
    line_search: str = "merit"
    merit_mu_safety: float = 1e-2
    merit_mu_max: float = 1e6
    filter_depth: int = 10
    filter_gamma: float = 1e-5
    filter_beta: float = 0.999
    trace_iters: int = 0
    qp: ADMMSettings = ADMMSettings(eps_abs=1e-4, eps_rel=1e-5)

    def validate(self) -> bool:
        return (self.max_iter >= 1 and self.ls_max_iter >= 1
                and 0 < self.tau < 1 and 0 < self.eta < 1
                and self.hessian in ("bfgs", "sr1", "block_bfgs", "exact",
                                     "gauss_newton")
                and self.reg in ("none", "gershgorin", "eigen", "eigmin",
                                 "mirror", "clip", "ridge")
                and self.line_search in ("merit", "filter")
                and self.filter_depth >= 1 and self.trace_iters >= 0)


class SQPSolution(NamedTuple):
    x: torch.Tensor            # (B, n)
    lam: torch.Tensor          # (B, ne+ni)
    lam_box: torch.Tensor      # (B, n)
    status: torch.Tensor       # (B,) int32
    iters: torch.Tensor        # (B,) int32 SQP iterations
    qp_iters: torch.Tensor     # (B,) int32 accumulated inner QP iterations
    cost: torch.Tensor         # (B,)
    primal_step: torch.Tensor  # (B,)
    dual_step: torch.Tensor    # (B,)
    violation: torch.Tensor    # (B,)
    # (B, trace_iters, 4) per-iteration [cost, violation, primal_step,
    # dual_step]; rows past a lane's final iteration hold NaN; None when
    # trace_iters == 0
    trace: Optional[torch.Tensor] = None
