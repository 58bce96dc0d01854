"""The ``kite_nmpf`` configuration built on the program: PolyMPC's kite
with the NMPF path-state augmentation, on Chebyshev(5) x 2 segments, with
bench.py's solver settings (``kite_nmpf.json``)."""
from __future__ import annotations

import numpy as np
import torch

from polympc_torch.basis import Chebyshev, SegmentedBasis
from polympc_torch.control.nmpf import augment_ocp
from polympc_torch.models import kite_dynamics, kite_output, kite_path
from polympc_torch.ocp import ocp_bounds, transcribe
from polympc_torch.parallel import make_batch_solver

from port_bench.pb.problem import Problem, sqp_settings


def build(cfg, device) -> Problem:
    mdl, p = cfg["model"], cfg["problem"]
    ocp = augment_ocp(
        lambda x, u: kite_dynamics(x, u, L=mdl["L"], E=mdl["E"],
                                   ws=mdl["ws"]),
        kite_output, kite_path, nx=3, nu=1, ny=2, W=mdl["W"])
    tr = transcribe(ocp, SegmentedBasis(Chebyshev(p["order"]),
                                        p["segments"]),
                    x_scale=p["x_scale"], u_scale=p["u_scale"])
    prm = tr.params(d=p["d"], t0=p["t0"], tf=p["tf"], dtype=torch.float32,
                    device=device)
    prm64 = tr.params(d=p["d"], t0=p["t0"], tf=p["tf"], dtype=torch.float64,
                      device=device)
    bounds, bounds64 = (ocp_bounds(tr, dtype=dt, device=device,
                                   **p["bounds"])
                        for dt in (torch.float32, torch.float64))
    settings = sqp_settings(cfg, tr.bbt_structure())
    cold = make_batch_solver(tr, bounds, prm, settings, rollout_guess=True)
    warm = make_batch_solver(tr, bounds, prm, settings)
    return Problem(tr=tr, bounds=bounds, prm=prm, bounds64=bounds64,
                   prm64=prm64, batch_solve=cold, loop_first=cold,
                   loop_next=warm)


def draw(cfg, rng, B):
    """bench.py's initial conditions (its draw order), (B, 5) float32."""
    d = cfg["draw"]
    s0 = rng.uniform(0.0, 2 * np.pi, B)
    theta = (d["theta_base"] + d["theta_amp"] * np.sin(2 * s0)
             + rng.normal(0.0, d["noise_sd"], B))
    phi = d["phi_amp"] * np.cos(s0) + rng.normal(0.0, d["noise_sd"], B)
    gamma = rng.uniform(-d["gamma_half_width"], d["gamma_half_width"], B)
    return np.stack([np.clip(theta, *d["theta_clip"]),
                     np.clip(phi, *d["phi_clip"]), gamma, s0,
                     np.full(B, d["s_dot0"])], axis=1).astype(np.float32)
