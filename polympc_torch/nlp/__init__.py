from polympc_torch.nlp.types import (
    NLP, NLPBounds, SQPSettings, SQPSolution, unbounded,
)
from polympc_torch.nlp.hessian import (
    regularize, bfgs_update, sr1_update, BlockHessian,
    block_hessian_identity, block_hessian_matvec, block_bfgs_update,
    assemble_block_hessian,
)
from polympc_torch.nlp.sqp import sqp_solve
from polympc_torch.nlp.refine import kkt_residual, refine_solution
from polympc_torch.nlp.ip import IPNLPSettings, IPNLPSolution, nlp_ip_solve
from polympc_torch.nlp.psarc import PsarcSettings, PsarcResult, psarc_solve
from polympc_torch.nlp.tr import (
    trust_region_solve, projected_gradient_solve, TRSolution,
)

__all__ = ["NLP", "NLPBounds", "SQPSettings", "SQPSolution", "unbounded",
           "regularize",
           "bfgs_update", "sr1_update", "BlockHessian",
           "block_hessian_identity", "block_hessian_matvec",
           "block_bfgs_update", "assemble_block_hessian",
           "sqp_solve", "kkt_residual", "refine_solution",
           "IPNLPSettings", "IPNLPSolution", "nlp_ip_solve",
           "PsarcSettings", "PsarcResult", "psarc_solve",
           "trust_region_solve", "projected_gradient_solve", "TRSolution"]
