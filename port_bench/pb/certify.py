"""The configuration's certify schedule over the program's fp64 Newton-KKT
refinement (``polympc_torch.nlp.refine.refine_solution``).

Each stage refines a share of the lanes: all of them, or the worst by the
best residual so far, from the SQP's fp32 point ("sqp") or from the
previous stage's last iterate ("last").  A lane keeps the best (z, lam,
lam_box) by residual over the stages it ran; it is certified where that
residual is at most the configuration's tolerance."""
from __future__ import annotations

import torch

from polympc_torch.nlp.refine import refine_solution
from polympc_torch.parallel import pin_initial_state


def certify(problem, stages, x0s, sol):
    """Returns (z, lam, lam_box, residual) per lane, float64."""
    tr = problem.tr
    bnd, _ = pin_initial_state(tr, problem.bounds64, x0s.to(torch.float64))
    B = x0s.shape[0]
    f64 = torch.float64
    best = [sol.x.to(f64), sol.lam.to(f64), sol.lam_box.to(f64)]
    r = None
    last = None
    for k, stage in enumerate(stages):
        take_last = k + 1 < len(stages) and stages[k + 1]["start"] == "last"
        if r is None or stage["lanes"] >= 1.0:
            idx = None
        else:
            count = max(1, int(round(stage["lanes"] * B)))
            idx = torch.topk(r, min(count, B)).indices
        src = (sol.x, sol.lam, sol.lam_box) if stage["start"] == "sqp" \
            else last
        if idx is None:
            b, start = bnd, src
        else:
            b = bnd._replace(lbx=bnd.lbx[idx], ubx=bnd.ubx[idx])
            start = tuple(t[idx] for t in src)
        kw = {key: stage[key] for key in ("iters", "act_tol", "solve_ir")
              if key in stage}
        out = refine_solution(tr.nlp, *start, b, problem.prm64,
                              solve_dtype=torch.float32,
                              matrix_dtype=torch.float32,
                              return_residual=True, return_last=take_last,
                              **kw)
        z, lam, lam_box, res = out[:4]
        if take_last:
            new_last = out[4:7]
            if idx is None:
                last = new_last
            else:
                last = [t.clone() for t in last]
                for full, part in zip(last, new_last):
                    full[idx] = part
        if idx is None:
            if r is None:
                best, r = [z, lam, lam_box], res
            else:
                better = res < r
                best = [torch.where(better[:, None], a, o)
                        for a, o in zip((z, lam, lam_box), best)]
                r = torch.minimum(r, res)
        else:
            better = res < r[idx]
            for full, part in zip(best, (z, lam, lam_box)):
                full[idx] = torch.where(better[:, None], part, full[idx])
            r = r.clone()
            r[idx] = torch.minimum(r[idx], res)
    return best[0], best[1], best[2], r
