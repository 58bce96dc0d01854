from polympc_torch.control.nmpf import augment_ocp
from polympc_torch.control.path import (
    fit_spline_qp, spline_fit_qp_data, PathFrame, track_from_curvature,
    frame_transform, project_on_path, project_on_path_newton,
)

__all__ = ["augment_ocp", "fit_spline_qp", "spline_fit_qp_data",
           "PathFrame", "track_from_curvature", "frame_transform",
           "project_on_path", "project_on_path_newton"]
