"""sqp_iters_mean.batch (program counter): SQPSolution.iters averaged over
every lane of every batch in the window (layer: SQP loop)."""
import numpy as np

SOURCE = "program_counter"


def read(ctx):
    return float(np.mean(np.concatenate([u["iters"] for u in ctx.units])))
