from polympc_torch.ocp.ocp import OCP
from polympc_torch.ocp.transcription import (
    Transcription, transcribe, ocp_bounds, split_z, pack_z, SpectralOps,
)
from polympc_torch.ocp.integrators import (
    rk4_step, rk4_integrate, implicit_integrate, radau_integrate,
    adaptive_integrate, ps_integrate,
)
from polympc_torch.ocp.multiple_shooting import (
    MSTranscription, transcribe_ms, ms_bounds,
)
from polympc_torch.ocp.identification import (
    IdentificationResult, equation_error_fit, identify,
)
from polympc_torch.ocp.collocation import (
    collocate_dynamics, collocate_cost, collocate_constraints,
)

__all__ = ["OCP", "Transcription", "transcribe", "ocp_bounds",
           "split_z", "pack_z", "SpectralOps",
           "rk4_step", "rk4_integrate", "implicit_integrate",
           "radau_integrate", "adaptive_integrate", "ps_integrate",
           "MSTranscription", "transcribe_ms", "ms_bounds",
           "IdentificationResult", "equation_error_fit", "identify",
           "collocate_dynamics", "collocate_cost", "collocate_constraints"]
