#!/usr/bin/env python3
"""Substitution orders of the LDL^T solve on the certify's refine matrices,
on one NVIDIA card.

    python3 ldlt_solve_orders.py

Builds the kite's (B=512, K=132) and the race car's (B=512, K=165) certify
Newton-KKT matrices at their batches' fp32 solutions (chip_smoke.py's
inputs of kernels 3 and 4), factors them with ``ldlt_factor_plain`` and
solves against that factor in several orders, each emulated in PyTorch
with every product and difference rounded alone, as the kernels round:

  fp32 col/col   forward and backward sweeps column by column (one axpy
                 per pivot): the kernels' sweeps, in float32 as they
                 were before they substituted in float64
  fp32 col/row   the backward sweep row by row, each row a dot product
                 (lanes striding the row, a warp-shuffle tree): the order
                 of the JAX package's ``_solve_sweeps``
  fp32 row/row, fp32 row/col   the other two combinations
  fp64 col/col   column sweeps in float64 against the float32 factor,
                 rounded to float32 once: the kernels' sweeps now

Each is held to chip_smoke.py's residual gate against the plain version
(``ldlt_factor_solve_plain``: the same factor, then two
``solve_triangular``): per live lane (plain residual <= 1e-3) the ratio of
residuals, its largest value and quantiles, and the lanes that fail.  The
fp64 order is also compared with the kernel (``ldlt_solve``) bit for bit,
and the exact solve (float64 against the same float32 factor) with the
plain version.  Prints one JSON line per path.  Needs a card; imports
nothing of JAX.
"""
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def tree(P):
    """Per row of P (B, n): lane l sums P[:, l + 32 t] in turn, then a
    warp-shuffle tree adds the 32 lanes' sums."""
    import torch
    B, n = P.shape
    T = -(-n // 32)
    Pp = torch.zeros(B, T * 32, dtype=P.dtype, device=P.device)
    Pp[:, :n] = P
    Pp = Pp.view(B, T, 32)
    acc = Pp[:, 0]
    for t in range(1, T):
        acc = acc + Pp[:, t]
    for off in (16, 8, 4, 2, 1):
        acc = acc[:, :off] + acc[:, off:2 * off]
    return acc[:, 0]


def fwd_col(F, b):
    y = b.clone()
    for j in range(b.shape[1] - 1):
        y[:, j + 1:] = y[:, j + 1:] - F[:, j, j + 1:] * y[:, j:j + 1]
    return y


def fwd_row(F, b):
    y = b.clone()
    for i in range(1, b.shape[1]):
        y[:, i] = b[:, i] - tree(F[:, :i, i] * y[:, :i])
    return y


def bwd_col(F, y):
    x = y.clone()
    for i in range(y.shape[1] - 1, 0, -1):
        x[:, :i] = x[:, :i] - F[:, :i, i] * x[:, i:i + 1]
    return x


def bwd_row(F, y):
    x = y.clone()
    for i in range(y.shape[1] - 2, -1, -1):
        x[:, i] = y[:, i] - tree(F[:, i, i + 1:] * x[:, i + 1:])
    return x


ORDERS = {"fp32 col/col": (fwd_col, bwd_col, False),
          "fp32 col/row": (fwd_col, bwd_row, False),
          "fp32 row/row": (fwd_row, bwd_row, False),
          "fp32 row/col": (fwd_row, bwd_col, False),
          "fp64 col/col": (fwd_col, bwd_col, True)}


def orders(tag, Ms, rs):
    import torch
    import chip_smoke as cs
    from polympc_torch.ops import ldlt
    M32, r32 = Ms.float().contiguous(), rs.float().contiguous()
    rsd = r32.double()
    xp, Fp, dp = ldlt.ldlt_factor_solve_plain(M32, r32)
    rp = cs.rel_residual(Ms, xp, rsd)
    live = rp <= cs.LDLT_GROWTH
    xk = ldlt.ldlt_solve(Fp, dp, r32)
    out = {"path": tag, "B": int(M32.shape[0]), "K": int(M32.shape[1]),
           "live_lanes": int(live.sum())}
    x64 = ldlt.ldlt_solve_plain(Fp.double(), dp.double(), rsd)
    q = cs.rel_residual(Ms, x64, rsd)[live] / rp[live]
    out["exact_vs_plain_max"] = q.max().item()
    for name, (fwd, bwd, wide) in ORDERS.items():
        F, d, b = ((Fp.double(), dp.double(), rsd) if wide
                   else (Fp, dp, r32))
        x = bwd(F, fwd(F, b) / d).float()
        rc = cs.rel_residual(Ms, x, rsd)
        bad = live & ~(rc <= torch.clamp(cs.LDLT_RES_RATIO * rp,
                                         min=cs.LDLT_RES_FLOOR))
        ratio = rc[live] / rp[live]
        rec = {"failing_lanes": bad.nonzero()[:, 0].tolist(),
               "ratio_max": ratio.max().item(),
               "ratio_median_p90_p99": [ratio.quantile(p).item()
                                        for p in (0.5, 0.9, 0.99)],
               "lanes_above_5x": int((ratio > 5).sum())}
        if wide:
            rec["equals_kernel"] = bool(torch.equal(x, xk))
        out[name] = rec
    print(json.dumps(out), flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ldlt_solve_orders.py needs a CUDA card")
    import chip_smoke as cs
    ref = dict(np.load(cs.REFERENCE))
    x0 = torch.as_tensor(ref["x0s"], dtype=torch.float32, device="cuda")
    orders("kite", *cs.kite_refine_inputs(x0, "cuda"))
    orders("race_car", *cs.race_car_inputs("cuda")[2:])


if __name__ == "__main__":
    main()
