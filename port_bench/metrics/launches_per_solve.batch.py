"""launches_per_solve (device trace): device activities (kernels, copies,
sets) in the profiled units, per unit: per batch or per loop step (layer:
host dispatch)."""
SOURCE = "device_trace"


def read(ctx):
    p = ctx.profile
    if not p or not p["units"] or not p["launches"]:
        return None
    return p["launches"] / p["units"]
