"""polympc_torch — the PyTorch + CUDA port of polympc_tpu.

A second package beside the JAX reference (``polympc_tpu``), with the same
subpackage layout.  Solvers are batch-first: every solver takes a leading
``(B, ...)`` axis and carries explicit per-lane masks, so B independent
instances solve in one call and B=1 is the single-instance case.  The
hand-written Hopper kernels (``csrc/``) are built on first use and run for
CUDA float32 tensors; CPU tensors take each kernel's plain PyTorch version.

The top-level names (``polympc_torch.MPC``, ``polympc_torch.sqp_solve``,
...) and the subpackages are imported on first attribute access, so
``import polympc_torch`` stays light and builds nothing.

This package imports ``torch`` and never ``jax``.
"""
import importlib

__version__ = "0.1.0"

_EXPORTS = {
    "basis": ["Basis", "Chebyshev", "Legendre", "SegmentedBasis",
              "CubicSpline", "fit_cubic_spline", "lagrange_interp",
              "Projection", "project"],
    "qp": ["QPData", "ADMMSettings", "QPSolution", "box_admm_solve",
           "admm_solve", "ruiz_equilibrate", "qp_ip_solve"],
    "nlp": ["NLP", "SQPSettings", "SQPSolution", "sqp_solve"],
    "ocp": ["OCP", "Transcription", "transcribe"],
    "control": ["MPC", "lqr", "care", "lyapunov"],
}
_ATTR_TO_MOD = {a: m for m, attrs in _EXPORTS.items() for a in attrs}
__all__ = ["__version__"] + sorted(_ATTR_TO_MOD) + sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return importlib.import_module(f"polympc_torch.{name}")
    mod = _ATTR_TO_MOD.get(name)
    if mod is None:
        raise AttributeError(
            f"module 'polympc_torch' has no attribute {name!r}")
    return getattr(importlib.import_module(f"polympc_torch.{mod}"), name)
