"""The long-horizon batch: the partitioned full-space Newton engine
(``parallel/long_horizon.py``) on a horizon far longer than one segment
count holds.

The damped pendulum of ``tests/test_long_horizon.py`` (x = (angle, rate),
u a torque; L = x'x + 0.1 u'u) on S = 512 Chebyshev(4) segments of 0.5 s
(t in [0, 256] s), B = 32 lanes: lane 0 from x0 = (2, 0), the JAX test's,
lanes 1-31 uniform on [-2, 2] x [-1, 1] from ``default_rng(5)``; 12 Newton
steps in float64 from the constant initial guess.  Per lane the segment
blocks are (512, 25, 25) and the interface system has 2 (S - 1) = 1,022
unknowns.  ``chip_smoke.py`` drives :func:`run` on the card and holds the
lanes against the JAX package's record
(``tests/data/long_horizon_jax_cpu.npz``,
``tests/data/make_long_horizon_reference.py``).
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from polympc_torch.basis import Chebyshev
from polympc_torch.ocp.ocp import OCP
from polympc_torch.parallel import long_horizon as lh_mod
from polympc_torch.parallel.long_horizon import (
    LongHorizon, solve_long_horizon)

__all__ = ["SEGMENTS", "LANES", "ORDER", "SEG_LEN", "ITERS", "SEED",
           "pendulum_ocp", "long_horizon", "lane_x0s", "lanes_of",
           "split_timer", "batch_fn", "run"]

SEGMENTS = 512
LANES = 32
ORDER = 4
SEG_LEN = 0.5
ITERS = 12
SEED = 5


def pendulum_ocp() -> OCP:
    """The damped pendulum of tests/test_long_horizon.py:30-37."""
    def dyn(x, u, p, d, t):
        return torch.stack([x[1], -torch.sin(x[0]) - 0.2 * x[1] + u[0]])

    def lag(x, u, p, d, t):
        return x @ x + 0.1 * (u @ u)

    return OCP(nx=2, nu=1, dynamics=dyn, lagrange=lag)


def long_horizon(S: int = SEGMENTS) -> LongHorizon:
    """The pendulum on S Chebyshev(ORDER) segments of SEG_LEN seconds."""
    return LongHorizon(pendulum_ocp(), Chebyshev(ORDER), S=S, t0=0.0,
                       tf=SEG_LEN * S)


def lane_x0s(B: int = LANES):
    """(B, 2) float64: lane 0 at (2, 0), the others uniform on
    [-2, 2] x [-1, 1] from ``default_rng(SEED)``."""
    rng = np.random.default_rng(SEED)
    rest = np.stack([rng.uniform(-2.0, 2.0, B - 1),
                     rng.uniform(-1.0, 1.0, B - 1)], axis=1)
    return np.concatenate([[[2.0, 0.0]], rest]).astype(np.float64)


def lanes_of(lh: LongHorizon, Z, hist):
    """What the record holds of a solve, as numpy: the per-iteration
    defect and continuity (iters, B), the boundary states X[:, :, -1, :]
    (B, S, nx) and Z (B, S, nz)."""
    X, _ = lh.split(Z)
    return {"defect": np.stack([h["defect"] for h in hist]),
            "continuity": np.stack([h["continuity"] for h in hist]),
            "boundary": X[:, :, -1, :].cpu().numpy(),
            "Z": Z.cpu().numpy()}


@contextlib.contextmanager
def split_timer(device="cuda"):
    """Time the two halves of every Newton step inside the block: the
    segment blocks (``torch.func`` derivatives and assembly) and the
    interface solve (``schur_horizon_solve``), by CUDA events on a card
    (the host clock on the CPU).  Yields a dict of the two totals in
    seconds, filled on exit.  Raises if either half was never called
    (the engine renamed or fused it), so the split never reads 0."""
    cuda = torch.device(device).type == "cuda"
    marks = {"blocks": [], "interface": []}
    saved = (lh_mod._blocks, lh_mod.schur_horizon_solve)

    def timed(name, fn):
        def call(*a, **kw):
            if cuda:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
                out = fn(*a, **kw)
                ev[1].record()
                marks[name].append(ev)
                return out
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            marks[name].append(time.perf_counter() - t0)
            return out
        return call

    totals = {}
    lh_mod._blocks = timed("blocks", saved[0])
    lh_mod.schur_horizon_solve = timed("interface", saved[1])
    try:
        yield totals
    finally:
        lh_mod._blocks, lh_mod.schur_horizon_solve = saved
    if cuda:
        torch.cuda.synchronize(device)
    if not all(marks.values()):
        raise RuntimeError(f"split_timer: no call of "
                           f"{[n for n, m in marks.items() if not m]}")
    for name, ms in marks.items():
        totals[name] = sum(a.elapsed_time(b) / 1e3 for a, b in ms) \
            if cuda else sum(ms)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def batch_fn(B: int = LANES, device="cuda", S: int = SEGMENTS, x0s=None):
    """(lh, once): the engine on S segments and the timed unit, one solve
    of the B lanes (``lane_x0s(B)`` unless ``x0s`` is given) returning
    (Z, LAM, hist)."""
    lh = long_horizon(S)
    x0 = torch.as_tensor(lane_x0s(B) if x0s is None else x0s,
                         dtype=torch.float64, device=device)

    def once():
        return solve_long_horizon(lh, x0, iters=ITERS, device=device)

    return lh, once


def run(B: int = LANES, S: int = SEGMENTS, device="cuda", reps: int = 3,
        warmup: bool = True, x0s=None):
    """Solve the batch ``reps`` times after an optional warm-up; returns
    (summary, lanes): the median wall a solve and a Newton step, the final
    defect and continuity over the lanes, the interface solve's and the
    segment blocks' seconds of one more (split-timed) solve, and
    :func:`lanes_of` the last solve."""
    lh, once = batch_fn(B, device, S, x0s)
    if warmup:
        once()
    walls = []
    for _ in range(reps):
        _sync(device)
        t0 = time.perf_counter()
        Z, _, hist = once()
        _sync(device)
        walls.append(time.perf_counter() - t0)
    with split_timer(device) as split:
        _sync(device)
        t0 = time.perf_counter()
        once()
        _sync(device)
        split_wall = time.perf_counter() - t0
    lanes = lanes_of(lh, Z, hist)
    wall = float(np.median(walls))
    summary = {
        "batch": B, "segments": S, "iters": ITERS, "k": lh.k,
        "interface_unknowns": (S - 1) * lh.nx,
        "wall_s_per_solve": wall, "wall_ms_per_step": wall / ITERS * 1e3,
        "walls": walls,
        "max_final_defect": float(lanes["defect"][-1].max()),
        "max_final_continuity": float(lanes["continuity"][-1].max()),
        "split_wall_s": split_wall, "blocks_s": split["blocks"],
        "interface_s": split["interface"],
        "interface_share": split["interface"] / split_wall,
        "blocks_share": split["blocks"] / split_wall}
    return summary, lanes
