from polympc_torch.nlp.types import NLP, NLPBounds, SQPSettings, SQPSolution
from polympc_torch.nlp.hessian import (
    regularize, bfgs_update, sr1_update, BlockHessian,
    block_hessian_identity, block_hessian_matvec, block_bfgs_update,
    assemble_block_hessian,
)
from polympc_torch.nlp.sqp import sqp_solve
from polympc_torch.nlp.refine import kkt_residual, refine_solution

__all__ = ["NLP", "NLPBounds", "SQPSettings", "SQPSolution", "regularize",
           "bfgs_update", "sr1_update", "BlockHessian",
           "block_hessian_identity", "block_hessian_matvec",
           "block_bfgs_update", "assemble_block_hessian",
           "sqp_solve", "kkt_residual", "refine_solution"]
