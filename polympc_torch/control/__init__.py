from polympc_torch.control.lqr import lyapunov, care, lqr, pinv
from polympc_torch.control.mpc import MPC
from polympc_torch.control.nmpc import NMPC, tracking_ocp
from polympc_torch.control.nmpf import NMPF, augment_ocp
from polympc_torch.control.path import (
    fit_spline_qp, spline_fit_qp_data, PathFrame, track_from_curvature,
    frame_transform, project_on_path, project_on_path_newton,
)

__all__ = ["lyapunov", "care", "lqr", "pinv", "MPC", "NMPC", "tracking_ocp",
           "NMPF", "augment_ocp",
           "fit_spline_qp", "spline_fit_qp_data",
           "PathFrame", "track_from_curvature", "frame_transform",
           "project_on_path", "project_on_path_newton"]
