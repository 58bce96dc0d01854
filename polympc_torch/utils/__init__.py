from polympc_torch.utils import status
from polympc_torch.utils.status import status_name
from polympc_torch.utils.precision import full_precision
from polympc_torch.utils.solver_utils import (
    block_diag_scatter, is_psd, print_qp, rbf_kernel, rbf_grad, rbf_hessian,
)
from polympc_torch.utils.timing import (
    get_time, Timer, time_fn, SolveStats, trace,
)
from polympc_torch.utils.checkpoint import save_pytree, load_pytree
from polympc_torch.utils.polymath import (
    t1_quat, t2_quat, t3_quat, quat_multiply, quat_inverse, quat_transform,
    heaviside, deg2rad, rk4_step_fn, LinearSystem,
    controllability_matrix, observability_matrix,
)

__all__ = ["status", "status_name", "full_precision", "block_diag_scatter",
           "get_time", "Timer", "time_fn", "SolveStats", "trace",
           "save_pytree", "load_pytree",
           "is_psd", "print_qp", "rbf_kernel", "rbf_grad", "rbf_hessian",
           "t1_quat", "t2_quat", "t3_quat", "quat_multiply", "quat_inverse",
           "quat_transform", "heaviside", "deg2rad", "rk4_step_fn",
           "LinearSystem", "controllability_matrix", "observability_matrix"]
