"""busy_share (device trace): the union of the device activities'
intervals (kernels, copies, sets) over the wall of the profiled units, in
% (the profiled wall: the profiler slows the host, so this share reads
higher than the unprofiled window's would) (layer: device)."""
SOURCE = "device_trace"


def read(ctx):
    p = ctx.profile
    if not p or p["window_s"] <= 0 or p["busy_s"] <= 0:
        return None
    return 100.0 * p["busy_s"] / p["window_s"]
