"""step_ms_p90 (host clock): the 90th percentile (linear interpolation) of
every loop step's solve time in the window."""
import numpy as np

SOURCE = "host_clock"


def read(ctx):
    if ctx.kind != "loop":
        return None
    return float(np.percentile([u["wall_s"] for u in ctx.units], 90)) * 1e3
