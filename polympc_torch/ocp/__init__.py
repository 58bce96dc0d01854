from polympc_torch.ocp.ocp import OCP
from polympc_torch.ocp.transcription import (
    Transcription, transcribe, ocp_bounds, split_z, pack_z,
)

__all__ = ["OCP", "Transcription", "transcribe", "ocp_bounds",
           "split_z", "pack_z"]
