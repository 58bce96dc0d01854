from polympc_torch.qp.types import (
    QPData, QPSolution, ADMMSettings, infer_dims,
)
from polympc_torch.qp.box_admm import (
    box_admm_solve, admm_solve, classify_constraints, rho_vector,
)
from polympc_torch.qp.ip import IPSettings, qp_ip_solve
from polympc_torch.qp.active_set import qp_active_set_solve
from polympc_torch.qp.ruiz import (
    RuizScaling, ruiz_equilibrate, unscale_solution,
)

__all__ = ["QPData", "QPSolution", "ADMMSettings", "infer_dims",
           "box_admm_solve",
           "admm_solve",
           "classify_constraints", "rho_vector", "RuizScaling",
           "ruiz_equilibrate", "unscale_solution", "IPSettings",
           "qp_ip_solve", "qp_active_set_solve"]
