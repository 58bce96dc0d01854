"""certify_solve_roofline.batch (device trace): the certify's float32
Newton-KKT solves' share of their roofline, in %: each call of
polympc_torch.nlp.refine._newton_kkt_solve is timed between two CUDA
events, and its bound is one factor-solve, ``ir`` residual products and
``ir`` solves at that call's K and lanes, in the frozen ``bound_ldlt``
arithmetic (layer: kernels, ops/ldlt.py -> csrc/ldlt.cu)."""
from port_bench.pb.roofline import bound_newton_solve

SOURCE = "device_trace"
HOOK = "polympc_torch.nlp.refine:_newton_kkt_solve"


def describe(args, cfg):
    M = args["M"]
    return bound_newton_solve(int(M.shape[0]), int(M.shape[-1]),
                              int(args.get("ir", 2)))[0]


def read(ctx):
    calls = ctx.hooks.get("certify_solve_roofline.batch")
    if not calls:
        return None
    spent = sum(t for t, _ in calls)
    return 100.0 * sum(b for _, b in calls) / spent if spent > 0 else None
