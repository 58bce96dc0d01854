"""The ``race_car`` configuration built on the program: the curvilinear
dynamic bicycle on a 200 m wave track, Chebyshev(5) x 2 segments, the
headline table's settings (``race_car.json``).  Set-up makes the cold
solve at the draw's centre; every batch and loop step warm-starts from it
or from the step before."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from polympc_torch.basis import Chebyshev, SegmentedBasis
from polympc_torch.models.race_car import (CarParams, make_wave_track,
                                           race_car_ocp)
from polympc_torch.ocp import ocp_bounds, transcribe
from polympc_torch.parallel import make_batch_solver
from polympc_torch.utils import status as st

from port_bench.pb.problem import Problem, sqp_settings


def build(cfg, device) -> Problem:
    mdl, p = cfg["model"], cfg["problem"]
    t = mdl["track"]
    kappa = make_wave_track(length=t["length"], amplitude=t["amplitude"],
                            waves=t["waves"], n_samples=t["samples"],
                            device=device)
    ocp = race_car_ocp(kappa, params=CarParams(**mdl["car"]),
                       **mdl["weights"])
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
    warm_s = sqp_settings(cfg, tr.bbt_structure())
    cold_s = dataclasses.replace(warm_s, **cfg["sqp_cold"])
    x0 = torch.as_tensor(cfg["draw"]["x0"], dtype=torch.float32,
                         device=device)[None]
    n, m = tr.nlp.n, tr.nlp.m
    z = tr.initial_guess(x0[0], dtype=torch.float32, device=device)[None]
    sol = make_batch_solver(tr, bounds, prm, cold_s)(
        x0, z, torch.zeros((1, m), device=device),
        torch.zeros((1, n), device=device))
    if int(sol.status[0]) != st.SOLVED:
        raise RuntimeError("race car: the cold solve at the draw's centre "
                           "did not reach SOLVED")
    warm = make_batch_solver(tr, bounds, prm, warm_s)
    start = (sol.x, sol.lam, sol.lam_box)

    def batch_solve(x0s):
        B = x0s.shape[0]
        return warm(x0s, *(t.expand(B, -1) for t in start))

    return Problem(tr=tr, bounds=bounds, prm=prm, bounds64=bounds64,
                   prm64=prm64, batch_solve=batch_solve,
                   loop_first=batch_solve, loop_next=warm)


def draw(cfg, rng, B):
    """The draw's centre jittered by scale * N(0, 1) per lane, (B, 6)
    float32."""
    d = cfg["draw"]
    dx = rng.standard_normal((B, len(d["x0"]))) * np.asarray(d["scale"])
    return (np.asarray(d["x0"])[None] + dx).astype(np.float32)
