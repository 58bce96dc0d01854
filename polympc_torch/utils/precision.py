"""Matmul-precision control for solver-critical linear algebra.

On an NVIDIA card a float32 matmul may run in TF32, which keeps about three
decimal digits: enough to wreck the Newton-Schulz "mirror" regulariser
(nlp/hessian.py) and the iterative-refinement residual of the certify pass
(nlp/refine.py).  Every solver entry point runs under :func:`full_precision`,
so a caller's global TF32 setting cannot silently break the solvers.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["full_precision"]


@contextlib.contextmanager
def full_precision():
    """Context manager and decorator (``@full_precision()``): full-float32
    matmuls inside.

    Sets ``torch.backends.cuda.matmul.allow_tf32 = False``,
    ``torch.backends.cudnn.allow_tf32 = False`` and
    ``torch.set_float32_matmul_precision("highest")``, and restores the
    caller's settings on exit.
    """
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        matmul_tf32, cudnn_tf32, prec = saved
        torch.set_float32_matmul_precision(prec)
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
