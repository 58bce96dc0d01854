from polympc_torch.ocp.ocp import OCP
from polympc_torch.ocp.integrators import rk4_step, rk4_integrate
from polympc_torch.ocp.transcription import (
    Transcription, transcribe, ocp_bounds, split_z, pack_z,
)

__all__ = ["OCP", "Transcription", "transcribe", "ocp_bounds",
           "split_z", "pack_z", "rk4_step", "rk4_integrate"]
