"""Pseudo-arc-length continuation (PSARC) for hard root-finding problems —
the port of polympc_tpu/nlp/psarc.py (the reference's experimental
``symbolic_psarc``, src/experimental/psarc.hpp:153-372).

Given equalities F(x) = 0 and a guess x0, the convex homotopy
(psarc.hpp:173)

    H(x, lam) = lam * (x - x0) + (1 - lam) * F(x)

runs from the trivial root (x0, lam=1) to a root of F at lam = 0; it is
traced by a predictor-corrector scheme, as in the JAX package:

  * tangent: solve H_x r = -H_lam, t = l_dot [r; 1] with
    l_dot = 1/sqrt(1 + r'r), its inf-norm rescaled above ``tangent_clip``
    (psarc.hpp:267-272), oriented to keep moving the same way along the
    path (first step: lam decreasing) (psarc.hpp:260-302);
  * predictor z + h t; corrector the projection NLP
    min_z 1/2||z - z_pred||^2 s.t. H(z) = 0 (psarc.hpp:189-196) through
    the port's ``sqp_solve`` (one lane, float64: its QPs take the LU
    epoch), warm-started from the previous point;
  * adaptive step length (grow on a solved corrector, shrink on a failed
    one); when lam crosses 0, pin lam = 0 and correct once more
    (psarc.hpp:320-327).

The continuation loop is host-side Python (sequential and a handful of
steps long); the tangent solve and the corrector run on x0's device.
``F`` maps one point (n,) to (n,).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import jacrev, vmap

from polympc_torch.nlp.sqp import sqp_solve
from polympc_torch.nlp.types import NLP, NLPBounds, SQPSettings
from polympc_torch.qp.types import ADMMSettings
from polympc_torch.utils import status as st

__all__ = ["PsarcSettings", "PsarcResult", "psarc_solve"]


@dataclasses.dataclass(frozen=True)
class PsarcSettings:
    h0: float = 1.0              # initial arc step
    h_min: float = 1e-4
    h_max: float = 10.0
    grow: float = 1.5
    shrink: float = 0.5
    max_steps: int = 100
    tangent_clip: float = 20.0   # inf-norm rescaling threshold (psarc.hpp:267)
    corrector: SQPSettings | None = None


class PsarcResult(NamedTuple):
    x: torch.Tensor          # root of F
    converged: bool
    steps: int
    lambda_log: np.ndarray   # continuation path of lam


def psarc_solve(F: Callable, x0, settings: PsarcSettings = PsarcSettings(),
                lbx=None, ubx=None) -> PsarcResult:
    """Find a root of F: R^n -> R^n from x0 (n,) by arc-length
    continuation; lbx/ubx optionally bound x during the correction (the
    reference pins selected components the same way, psarc.hpp:206-216)."""
    n = x0.shape[0]
    dt, dev = x0.dtype, x0.device

    def H(z, x0_):
        x, lam = z[:n], z[n]
        return lam * (x - x0_) + (1.0 - lam) * F(x)

    Hjac = jacrev(H)

    def tangent(z, t_prev, first):
        J = Hjac(z, x0)                       # (n, n+1)
        r = torch.linalg.solve(J[:, :n], -J[:, n])
        nrm = torch.amax(torch.abs(r))
        if nrm > settings.tangent_clip:
            r = r * (settings.tangent_clip / nrm)
        l_dot = 1.0 / torch.sqrt(1.0 + r @ r)
        tau = torch.cat([l_dot * r, l_dot[None]])
        # orientation: the first step decreases lam; afterwards keep
        # t't_prev >= 0
        if first:
            return -tau
        return tau if float(t_prev @ tau) >= 0 else -tau

    # corrector NLP: min 1/2||z - w||^2 s.t. H(z) = 0, z = (x, lam)
    nlp = NLP(cost=lambda z, p: 0.5 * torch.sum((z - p["w"]) ** 2, dim=1),
              n=n + 1, eq=lambda z, p: vmap(H, in_dims=(0, None))(
                  z, p["x0"]), ne=n)
    corr = settings.corrector or SQPSettings(
        hessian="exact", max_iter=30,
        qp=ADMMSettings(rho=1.0, eps_abs=1e-8, eps_rel=1e-8, max_epochs=30,
                        equil_iters=2))
    inf = float("inf")
    full = lambda v: torch.full((n,), v, dtype=dt, device=dev)
    lbx_full = full(-inf) if lbx is None else torch.as_tensor(
        lbx, dtype=dt, device=dev)
    ubx_full = full(inf) if ubx is None else torch.as_tensor(
        ubx, dtype=dt, device=dev)
    empty = torch.zeros(0, dtype=dt, device=dev)

    def correct(w, z_init, lam_lb, lam_ub):
        one = lambda v: torch.tensor([v], dtype=dt, device=dev)
        bounds = NLPBounds(lbx=torch.cat([lbx_full, one(lam_lb)]),
                           ubx=torch.cat([ubx_full, one(lam_ub)]),
                           gl=empty, gu=empty)
        sol = sqp_solve(nlp, z_init[None], p={"w": w[None], "x0": x0},
                        bounds=bounds, settings=corr)
        return sol.x[0], int(sol.status[0]) == st.SOLVED

    # the trivial root at lam = 1
    z = torch.cat([x0, torch.ones(1, dtype=dt, device=dev)])
    z, _ = correct(z, z, 1.0, 1.0)
    t_prev = torch.zeros(n + 1, dtype=dt, device=dev)
    h = settings.h0
    lam_log = [1.0]
    steps = 0
    first = True
    while steps < settings.max_steps:
        steps += 1
        tau = tangent(z, t_prev, first)
        z_new, ok = correct(z + h * tau, z, -inf, inf)
        if not ok and h > settings.h_min:
            h = max(settings.h_min, h * settings.shrink)
            continue
        t_prev = tau
        first = False
        z = z_new
        lam = float(z[n])
        lam_log.append(lam)
        h = min(settings.h_max, h * settings.grow)
        if lam < 0.0:
            # crossed the target: pin lam = 0 and refine (psarc.hpp:320-327)
            z = torch.cat([z[:n], torch.zeros(1, dtype=dt, device=dev)])
            z, ok = correct(z, z, 0.0, 0.0)
            lam_log.append(0.0)
            return PsarcResult(x=z[:n], converged=ok, steps=steps,
                               lambda_log=np.asarray(lam_log))
        if lam < 1e-10:
            return PsarcResult(x=z[:n], converged=True, steps=steps,
                               lambda_log=np.asarray(lam_log))
    return PsarcResult(x=z[:n], converged=False, steps=steps,
                       lambda_log=np.asarray(lam_log))
