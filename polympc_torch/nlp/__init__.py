from polympc_torch.nlp.types import NLP, NLPBounds, SQPSettings, SQPSolution
from polympc_torch.nlp.hessian import regularize
from polympc_torch.nlp.sqp import sqp_solve
from polympc_torch.nlp.refine import kkt_residual, refine_solution

__all__ = ["NLP", "NLPBounds", "SQPSettings", "SQPSolution", "regularize",
           "sqp_solve", "kkt_residual", "refine_solution"]
