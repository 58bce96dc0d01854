"""sqp_iters_mean.loop (program counter): SQPSolution.iters averaged over
every step of the window that returned (layer: SQP loop)."""
import numpy as np

SOURCE = "program_counter"


def read(ctx):
    its = [u["iters"] for u in ctx.units if u["iters"] is not None]
    return float(np.mean(np.concatenate(its))) if its else None
