from polympc_torch.utils import status
from polympc_torch.utils.status import status_name
from polympc_torch.utils.precision import full_precision
from polympc_torch.utils.solver_utils import block_diag_scatter
from polympc_torch.utils.checkpoint import save_pytree, load_pytree

__all__ = ["status", "status_name", "full_precision", "block_diag_scatter",
           "save_pytree", "load_pytree"]
