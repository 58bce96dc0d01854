"""Whether what the timed path produced is correct: the plain reference
judges the program's outputs, once the window has closed.

The reference evaluates, in float64 and with its own collocation of its own
model, each recorded answer at the program's point, with node 0 pinned to
the state the program was handed:

batch (``sample_lanes`` lanes drawn from the seed among all lanes of the
       window's batches)
  cert_kkt_max       the largest reference KKT residual of a lane the
                     program counted certified (the certificate's own
                     limit, the configuration's tolerance);
  kkt_gap_rel        the largest gap between the program's certified
                     residual and the reference's, over the smaller of the
                     two (at least the tolerance);
  sqp_viol_gap_rel   the largest gap between the SQP's reported violation
                     (the measure its SOLVED claim rests on) and the
                     reference's at the SQP's point, over the smaller of
                     the two (at least eps_viol).
batch (every lane of the window, by the program's own certificate)
  later_fail_excess  the share of the later batches' lanes that fail to
                     certify less the audit batches' share, in percentage
                     points (0 without a later batch): a run's ``failed``
                     counts the audit batches alone, and this holds the
                     rest of the window to them.
loop (every step in the window)
  viol_gap_rel       as sqp_viol_gap_rel;
  cost_gap_rel       the largest gap between the SQP's reported objective
                     and the reference's at the SQP's point, over the
                     smaller of the two: the model, its weights and the
                     quadrature;
  solved_stat_ratio  over the steps the SQP reports SOLVED, the largest
                     reference stationarity |grad f + J' lam + lam_box|_inf
                     over eps_stat times the dual scale
                     max(1, |lam|_inf, |lam_box|_inf): what the SOLVED claim
                     states of the point and its multipliers (the
                     configuration's limit 1, with room for the claim's
                     float32 rounding);
  and no step may fail.

The control (``control=True``) puts the reference in the program's place at
the precision below the configuration's: the certificate's residual in
float32 (the configuration states float64), and the SQP's reported
violation and objective with TF32 products (it states float32 with TF32
off).  ``solved_stat_ratio`` reads no reported quantity, only the answer
and its status, and ``later_fail_excess`` only the certificate's count, so
the control leaves both as they are.
"""
from __future__ import annotations

import numpy as np
import torch

from port_bench.reference._collocation import stopping_parts

BLOCK = 1024
COST_FLOOR = 1e-6


def scaled_box(nlp, cfg):
    """The shared box bounds (n,) of the configuration in scaled units."""
    b = cfg["problem"]["bounds"]
    sx = nlp._np["sx"]
    su = nlp._np["su"]
    lo = np.concatenate([np.tile(np.asarray(b["xl"]) / sx, nlp.N),
                         np.tile(np.asarray(b["ul"]) / su, nlp.N)])
    up = np.concatenate([np.tile(np.asarray(b["xu"]) / sx, nlp.N),
                         np.tile(np.asarray(b["uu"]) / su, nlp.N)])
    return torch.as_tensor(lo), torch.as_tensor(up)


def _parts(nlp, z, lam, lam_box, x0, lo, up, precision, device):
    """stopping_parts in blocks of lanes on ``device``, on the host after."""
    out = {}
    for i in range(0, z.shape[0], BLOCK):
        sl = slice(i, i + BLOCK)
        lo_b, up_b = nlp.pinned_bounds(lo.to(device), up.to(device),
                                       x0[sl].to(device, torch.float64))
        part = stopping_parts(nlp, z[sl].to(device), lam[sl].to(device),
                              lam_box[sl].to(device), lo_b, up_b, precision)
        for k, v in part.items():
            out.setdefault(k, []).append(v.to("cpu", torch.float64))
    return {k: torch.cat(v) for k, v in out.items()}


def _cat(units, key, pick=None):
    t = torch.cat([u["record"][key] for u in units
                   if u["record"] is not None])
    return t if pick is None else t[pick]


def sample(units, count, seed):
    """Indices of ``count`` lanes drawn from the seed among all the
    window's lanes (all of them where there are fewer)."""
    total = sum(u["record"]["r"].shape[0] for u in units)
    rng = np.random.default_rng([seed, 1])
    return torch.as_tensor(np.sort(rng.choice(total, min(count, total),
                                              replace=False)))


def _fail_share(units):
    return 100.0 * sum(u["lanes"] - u["certified"] for u in units) / sum(
        u["lanes"] for u in units)


def fail_excess(units):
    """Percentage points by which the failure share of the window's later
    batches exceeds its audit batches' (0 without a later batch)."""
    later = [u for u in units if not u["audit"]]
    if not later:
        return 0.0
    return _fail_share(later) - _fail_share([u for u in units
                                             if u["audit"]])


def _gap(prog, ref, floor):
    """The largest gap between the program's reading and the reference's,
    over the smaller of the two in magnitude (at least ``floor``): a reading
    too low counts as much as one too high."""
    return float(torch.max(torch.abs(prog - ref) / torch.clamp(
        torch.minimum(torch.abs(prog), torch.abs(ref)), min=floor)))


def _costs(nlp, z, precision, device):
    """The reference's objective at the lanes z, in blocks, on the host."""
    return torch.cat([nlp.costs(z[i:i + BLOCK].to(device), precision).to(
        "cpu", torch.float64) for i in range(0, z.shape[0], BLOCK)])


def numbers(kind, units, nlp, cfg, device, control=False, pick=None):
    """The compared numbers of one run (name -> value); ``pick`` selects
    the batch lanes compared."""
    lo, up = scaled_box(nlp, cfg)
    eps_viol = cfg["sqp"]["eps_viol"]
    x0 = _cat(units, "x0", pick).to(torch.float64)
    x, lam, lam_box = (_cat(units, k, pick) for k in ("x", "lam", "lam_box"))
    viol = _cat(units, "violation", pick).to(torch.float64)
    ref = _parts(nlp, x, lam, lam_box, x0, lo, up, "fp64", device)
    if control:
        viol = _parts(nlp, x, lam, lam_box, x0, lo, up, "tf32",
                      device)["violation"]
    viol_gap = _gap(viol, ref["violation"], eps_viol)
    if kind == "loop":
        cost = _cat(units, "cost").to(torch.float64)
        if control:
            cost = _costs(nlp, x, "tf32", device)
        solved = _cat(units, "solved")
        ratio = ref["stationarity"] / (cfg["sqp"]["eps_stat"]
                                       * ref["lam_scale"])
        return {"viol_gap_rel": viol_gap,
                "cost_gap_rel": _gap(cost, _costs(nlp, x, "fp64", device),
                                     COST_FLOOR),
                "solved_stat_ratio": float(ratio[solved].max())
                if bool(solved.any()) else 0.0}
    tol = float(cfg["certify"]["tol"])
    z, zl, zb = (_cat(units, k, pick) for k in ("z", "zlam", "zlam_box"))
    cert = _parts(nlp, z, zl, zb, x0, lo, up, "fp64", device)["kkt"]
    r = _cat(units, "r", pick).to(torch.float64)
    if control:
        r = _parts(nlp, z, zl, zb, x0, lo, up, "fp32", device)["kkt"]
    certified = r <= tol
    return {
        "cert_kkt_max": float(cert[certified].max()) if bool(
            certified.any()) else 0.0,
        "kkt_gap_rel": _gap(r, cert, tol),
        "sqp_viol_gap_rel": viol_gap,
        "later_fail_excess": fail_excess(units)}


def judge(nums, limits, failed_steps=None):
    """(correct, checks): every number at most its limit, and (in a loop
    cell) no failed step; checks is name -> {value, limit}."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in nums.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    if failed_steps is not None:
        checks["failed_steps"] = {"value": failed_steps, "limit": 0}
        ok = ok and failed_steps == 0
    return ok, checks
