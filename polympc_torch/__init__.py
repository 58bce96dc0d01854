"""polympc_torch — the PyTorch + CUDA port of polympc_tpu.

A second package beside the JAX reference (``polympc_tpu``), with the same
subpackage layout.  Solvers are batch-first: every solver takes a leading
``(B, ...)`` axis and carries explicit per-lane masks, so B independent
instances solve in one call and B=1 is the single-instance case.  The
hand-written Hopper kernels (``csrc/``) are built on first use and run for
CUDA float32 tensors; CPU tensors take each kernel's plain PyTorch version.

This package imports ``torch`` and never ``jax``.
"""
__version__ = "0.1.0"
