"""QP problem/solution containers and ADMM settings (the port of
polympc_tpu/qp/types.py), batch-first.

Problem form (ref: qp_base.hpp:97-254), one per lane:

    min  1/2 x'Hx + h'x
    s.t. al <= A x <= au          (m general constraints, duals y)
         xl <=  x  <= xu          (n box constraints, duals y_box)

Every tensor carries a leading batch axis B.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

__all__ = ["QPData", "QPSolution", "ADMMSettings"]


class QPData(NamedTuple):
    H: torch.Tensor   # (B, n, n)
    h: torch.Tensor   # (B, n)
    A: torch.Tensor   # (B, m, n)
    al: torch.Tensor  # (B, m)
    au: torch.Tensor  # (B, m)
    xl: torch.Tensor  # (B, n)
    xu: torch.Tensor  # (B, n)


class QPSolution(NamedTuple):
    x: torch.Tensor         # (B, n) primal
    y: torch.Tensor         # (B, m) duals of general constraints
    y_box: torch.Tensor     # (B, n) duals of box constraints
    status: torch.Tensor    # (B,) int32, see utils.status
    iters: torch.Tensor     # (B,) int32, ADMM iterations executed
    res_prim: torch.Tensor  # (B,) final primal residual (inf-norm)
    res_dual: torch.Tensor  # (B,) final dual residual (inf-norm)
    rho: torch.Tensor       # (B, m) final per-constraint penalty


@dataclasses.dataclass(frozen=True)
class ADMMSettings:
    """ADMM solver settings (ref: qp_base.hpp:17-53 defaults), the fields of
    the JAX package's ``ADMMSettings``.

    The KKT system is refactorised once per epoch and ``check_every``
    iterations run between residual checks / adaptive-rho updates, so
    max_iter = max_epochs * check_every.

    ``kkt_solver``: "lu" (factor + triangular solves), "inverse" (explicit
    inverse once per epoch) or "kernel": each epoch runs as one fused
    hand-written kernel — on the bordered-block-tridiagonal KKT given by
    ``structure`` (ops/bbt_kernel.py), or on the dense KKT without one
    (ops/admm_epoch.py) — the JAX package's "pallas" setting.
    """
    rho: float = 0.1
    rho_min: float = 1e-6
    rho_max: float = 1e6
    rho_eq_scale: float = 1e3
    sigma: float = 1e-6
    alpha: float = 1.6
    eps_abs: float = 1e-4
    eps_rel: float = 1e-5
    max_epochs: int = 16
    check_every: int = 25
    adaptive_rho: bool = True
    adaptive_rho_threshold: float = 5.0
    eps_inf: float = 1e-5
    equil_iters: int = 0         # Ruiz equilibration iterations (0 = off)
    polish: bool = True          # active-set polish after ADMM (OSQP 5.5)
    polish_delta: float = 1e-8
    kkt_solver: str = "lu"       # "lu" | "inverse" | "kernel"
    structure: object = None     # Optional[ops.structure.CollocStructure]
    loose_bound: float = 1e10
    eq_tol: float = 1e-4

    @property
    def max_iter(self) -> int:
        return self.max_epochs * self.check_every

    def validate(self) -> bool:
        return (self.rho > 0 and self.sigma > 0 and 0 < self.alpha < 2
                and self.eps_abs >= 0 and self.eps_rel >= 0
                and self.max_epochs >= 1 and self.check_every >= 1
                and self.kkt_solver in ("lu", "inverse", "kernel"))
