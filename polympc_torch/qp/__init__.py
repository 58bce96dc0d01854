from polympc_torch.qp.types import QPData, QPSolution, ADMMSettings
from polympc_torch.qp.box_admm import (
    box_admm_solve, classify_constraints, rho_vector,
)

__all__ = ["QPData", "QPSolution", "ADMMSettings", "box_admm_solve",
           "classify_constraints", "rho_vector"]
