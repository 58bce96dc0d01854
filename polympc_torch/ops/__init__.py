"""Structured KKT operations and the hand-written Hopper kernels.

``bbt_kernel`` (boxADMM epoch and solve on bordered-block-tridiagonal
KKTs), ``admm_epoch`` (the dense boxADMM epoch) and ``ldlt`` (dense
unpivoted LDL^T factor, factor+solve, solve and explicit inverse) each
hold a plain PyTorch version beside a wrapper that launches the CUDA
kernel for CUDA float32 tensors; ``_build`` compiles the kernels at first
use.
"""
from polympc_torch.ops.structure import (
    CollocStructure, bbt_structure, structure_is_consistent,
)
from polympc_torch.ops.bbt_kernel import (
    bbt_admm_epoch_batched, bbt_solve_batched,
)
from polympc_torch.ops.admm_epoch import admm_epoch_batched
from polympc_torch.ops.ldlt import (
    ldlt_factor, ldlt_factor_solve, ldlt_inverse, ldlt_solve,
)

__all__ = ["CollocStructure", "bbt_structure", "structure_is_consistent",
           "bbt_admm_epoch_batched", "bbt_solve_batched",
           "admm_epoch_batched", "ldlt_factor", "ldlt_factor_solve",
           "ldlt_inverse", "ldlt_solve"]
