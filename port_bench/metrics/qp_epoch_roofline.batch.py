"""qp_epoch_roofline.batch (device trace): the boxADMM epochs' share of
their roofline, in %: each call of polympc_torch.qp.box_admm._epoch is
timed between two CUDA events, and its bound is the frozen
``bound_bbt_epoch`` of the configuration's BBT shape, that call's lanes and
``check_every`` iterations; the share is the bounds' sum over the times'
sum (layer: kernels, ops/bbt_kernel.py -> csrc/bbt_epoch.cu)."""
from port_bench.pb.roofline import BBT, bound_bbt_epoch

SOURCE = "device_trace"
HOOK = "polympc_torch.qp.box_admm:_epoch"


def describe(args, cfg):
    lanes = int(args["qp"].h.shape[0])
    iters = int(args["settings"].check_every)
    return bound_bbt_epoch(BBT(**cfg["sizes"]["bbt"]), lanes, iters)[0]


def read(ctx):
    calls = ctx.hooks.get("qp_epoch_roofline.batch")
    if not calls:
        return None
    spent = sum(t for t, _ in calls)
    return 100.0 * sum(b for _, b in calls) / spent if spent > 0 else None
