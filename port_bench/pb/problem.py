"""What a configuration's loader hands the harness."""
from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass
class Problem:
    """The program's problem of one configuration on one device.

    ``bounds`` are float32 (the solve's), ``bounds64`` the configuration's
    bounds made in float64 (the certify's).  ``batch_solve(x0s)`` solves a batch (B, nx) float32 from the
    configuration's start; ``loop_first(x0)`` the first closed-loop step at
    (1, nx) and ``loop_next(x0, z, lam, lam_box)`` a warm-started one.  Each
    returns the program's batched ``SQPSolution``."""
    tr: object
    bounds: object
    prm: dict
    bounds64: object
    prm64: dict
    batch_solve: Callable
    loop_first: Callable
    loop_next: Callable


def sqp_settings(cfg, structure, **override):
    """The configuration's SQP and boxADMM settings as the program's
    ``SQPSettings`` (``override`` replaces SQP fields)."""
    from polympc_torch.nlp import SQPSettings
    from polympc_torch.qp.types import ADMMSettings
    qp = ADMMSettings(structure=structure, **cfg["admm"])
    return SQPSettings(qp=qp, **{**cfg["sqp"], **override})

