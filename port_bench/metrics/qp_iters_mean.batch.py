"""qp_iters_mean.batch (program counter): SQPSolution.qp_iters, the inner
boxADMM iterations a lane accumulated over its SQP iterations, averaged
over every lane of the window (layer: QP)."""
import numpy as np

SOURCE = "program_counter"


def read(ctx):
    return float(np.mean(np.concatenate([u["qp_iters"]
                                         for u in ctx.units])))
