from polympc_torch.parallel.batch import make_batch_solver, pin_initial_state
from polympc_torch.parallel.dist_sqp import (
    DistBounds, DistSQPSettings, DistTranscription, dist_bounds,
    dist_kkt_residual, dist_refine, dist_sqp_solve, dist_transcribe,
    fused_to_segments, segments_to_fused,
)
from polympc_torch.parallel.horizon import (
    assemble_dense_horizon, schur_horizon_apply, schur_horizon_factor,
    schur_horizon_solve,
)
from polympc_torch.parallel.multihost import (
    make_batch_dist_solver, pin_segment_head,
)

__all__ = ["make_batch_solver", "pin_initial_state", "DistBounds",
           "DistSQPSettings", "DistTranscription", "dist_bounds",
           "dist_kkt_residual", "dist_refine", "dist_sqp_solve",
           "dist_transcribe", "fused_to_segments", "segments_to_fused",
           "assemble_dense_horizon", "schur_horizon_apply",
           "schur_horizon_factor", "schur_horizon_solve",
           "make_batch_dist_solver", "pin_segment_head"]
