from polympc_torch.parallel.batch import (
    batch_mesh, make_batch_solver, pin_initial_state, shard_batch,
)
from polympc_torch.parallel.dist_sqp import (
    DistBounds, DistSQPSettings, DistTranscription, dist_bounds,
    dist_kkt_residual, dist_refine, dist_sqp_solve, dist_transcribe,
    fused_to_segments, segments_to_fused,
)
from polympc_torch.parallel.horizon import (
    assemble_dense_horizon, horizon_mesh, schur_horizon_apply,
    schur_horizon_factor, schur_horizon_solve,
)
from polympc_torch.parallel.multihost import (
    initialize_multihost, make_batch_dist_solver, mesh_2d, pin_segment_head,
    process_local_batch,
)

__all__ = ["make_batch_solver", "pin_initial_state", "batch_mesh",
           "shard_batch", "DistBounds", "DistSQPSettings",
           "DistTranscription", "dist_bounds", "dist_kkt_residual",
           "dist_refine", "dist_sqp_solve", "dist_transcribe",
           "fused_to_segments", "segments_to_fused",
           "assemble_dense_horizon", "horizon_mesh", "schur_horizon_apply",
           "schur_horizon_factor", "schur_horizon_solve",
           "initialize_multihost", "mesh_2d", "make_batch_dist_solver",
           "pin_segment_head", "process_local_batch"]
