from polympc_torch.models.kite import kite_dynamics, kite_output, kite_path

__all__ = ["kite_dynamics", "kite_output", "kite_path"]
