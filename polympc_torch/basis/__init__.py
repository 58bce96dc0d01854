from polympc_torch.basis.basis import (
    Basis, Chebyshev, Legendre, LegendreGauss, LegendreRadau,
    SegmentedBasis,
)
from polympc_torch.basis.splines import (
    CubicSpline, fit_cubic_spline, cubic_spline_eval, lagrange_interp,
)
from polympc_torch.basis.projection import Projection, project
from polympc_torch.basis import nodes

__all__ = ["Basis", "Chebyshev", "Legendre", "LegendreGauss",
           "LegendreRadau", "SegmentedBasis", "CubicSpline",
           "fit_cubic_spline", "cubic_spline_eval", "lagrange_interp",
           "Projection", "project", "nodes"]
