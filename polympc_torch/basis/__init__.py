from polympc_torch.basis.basis import (
    Basis, Chebyshev, Legendre, LegendreGauss, LegendreRadau,
    SegmentedBasis,
)
from polympc_torch.basis import nodes

__all__ = ["Basis", "Chebyshev", "Legendre", "LegendreGauss",
           "LegendreRadau", "SegmentedBasis", "nodes"]
