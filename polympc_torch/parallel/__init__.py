from polympc_torch.parallel.batch import make_batch_solver, pin_initial_state

__all__ = ["make_batch_solver", "pin_initial_state"]
