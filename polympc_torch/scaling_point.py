"""The horizon sweep: the port's twin of ``benchmarks/scaling.py``.

The batched kite NMPF (bench.py's OCP) on a Chebyshev(5) x S-segment mesh
for S = 2, 4, 8 and 16 (n = 35 S + 7 primals, m = 25 S + 5 rows, one
k=72 BBT block a segment), B = max(128, 1024 // S) lanes from bench.py's
``default_rng(0)`` draw, each started from its own dynamics rollout, the
float32 SQP with scaling.py's settings (exact Hessian, ``reg="mirror"``,
``max_iter=12``, 3 x 50 boxADMM iterations a QP); then bench.py's
three-stage float64 certify (``headline.certify``: float32 LDL^T solves up
to K = ``nlp.refine.REFINE_LDLT_MAX_K`` = 206, as the JAX package takes
its LDL^T kernel, so at S=2; ``torch.linalg.solve`` above), so every row
reports the certified count beside SOLVED.

Each S runs the inner QPs through the two kernels scaling.py compares:
``"dense"`` (the dense epoch, kernel 7: no structure given) and ``"bbt"``
(the BBT epoch, kernel 1: the transcription's structure), each only where
its fit rule holds, as scaling.py skips its rows; where neither fits
(S=16) one ``"auto"`` row takes the solver's own ``epoch_route`` (the LU
epoch), so every S has a certified count.  ``chip_smoke.py`` drives
:func:`sweep` on the card and holds each certified count against the JAX
package's record (``tests/data/scaling_jax_cpu.npz``).

:func:`run_kernel_micro` is scaling.py's measured epoch time: 20
back-to-back epochs of the real regularised kite KKT, timed with CUDA
events.  scaling.py's ``run_dist_point`` is ``dist_point.b1_point``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from polympc_torch.basis import Chebyshev, SegmentedBasis
from polympc_torch.headline import (
    KITE_BOUNDS, KKT_TOL, bench_x0s, certify, kite_ocp)
from polympc_torch.nlp import SQPSettings
from polympc_torch.ocp import ocp_bounds, transcribe
from polympc_torch.ops.admm_epoch import admm_epoch_batched, \
    epoch_kernel_fits
from polympc_torch.ops.bbt_kernel import bbt_admm_epoch_batched, \
    bbt_kernel_fits
from polympc_torch.parallel import make_batch_solver
from polympc_torch.qp.box_admm import epoch_route
from polympc_torch.qp.types import ADMMSettings
from polympc_torch.utils import status as st

__all__ = ["SEGMENTS", "BACKENDS", "MAX_ITER", "batch_of", "sweep_problem",
           "route_of", "sweep_rows", "batch_fn", "run_point", "sweep",
           "first_epoch", "run_kernel_micro"]

SEGMENTS = (2, 4, 8, 16)
BACKENDS = ("dense", "bbt")
MAX_ITER = 12


def batch_of(S: int) -> int:
    """scaling.py's batch rule."""
    return max(128, 1024 // S)


def _transcription(S):
    return transcribe(kite_ocp(), SegmentedBasis(Chebyshev(5), S))


def sweep_problem(S: int, backend: str, device="cuda",
                  dtype=torch.float32, tr=None):
    """scaling.py's point: (tr, bounds, prm, settings).  ``backend``
    "dense" gives the QP no structure (the dense epoch where it fits),
    "bbt" and "auto" the transcription's (the BBT epoch where it fits);
    every route is ``epoch_route``'s choice by shape."""
    if backend not in BACKENDS + ("auto",):
        raise ValueError(f"backend={backend!r}: expected one of "
                         f"{BACKENDS + ('auto',)}")
    tr = _transcription(S) if tr is None else tr
    prm = tr.params(d=[0.05], t0=0.0, tf=2.0, dtype=dtype, device=device)
    bounds = ocp_bounds(tr, dtype=dtype, device=device, **KITE_BOUNDS)
    settings = SQPSettings(
        hessian="exact", max_iter=MAX_ITER, reg="mirror",
        eps_prim=1e-3, eps_dual=1e-3, eps_viol=1e-3, eps_stat=1e-2,
        qp=ADMMSettings(rho=1.0, eps_abs=1e-4, eps_rel=1e-4,
                        max_epochs=3, check_every=50, equil_iters=0,
                        kkt_solver="kernel",
                        structure=(None if backend == "dense"
                                   else tr.bbt_structure()),
                        polish=False))
    return tr, bounds, prm, settings


def _fits(tr, backend):
    """scaling.py's skip rule by the port's fit rules: the backend's own
    kernel must fit ("auto" always runs)."""
    n, m = tr.nlp.n, tr.nlp.m
    return {"dense": epoch_kernel_fits(n, m),
            "bbt": bbt_kernel_fits(tr.bbt_structure()),
            "auto": True}[backend]


def route_of(S: int, backend: str) -> str:
    """The epoch the point's QPs take (``epoch_route``), or "skipped" where
    the backend's kernel does not fit."""
    tr = _transcription(S)
    if not _fits(tr, backend):
        return "skipped"
    settings = sweep_problem(S, backend, "cpu", tr=tr)[3]
    return epoch_route(tr.nlp.n, tr.nlp.m, settings.qp)


def sweep_rows(segments=SEGMENTS):
    """The sweep's (S, backend) rows: both backends at every S, and one
    "auto" row at an S where neither kernel fits."""
    rows = []
    for S in segments:
        tr = _transcription(S)
        rows += [(S, b) for b in BACKENDS]
        if not any(_fits(tr, b) for b in BACKENDS):
            rows.append((S, "auto"))
    return rows


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def batch_fn(S: int, backend: str, B: int, device="cuda", x0s=None):
    """The timed unit: a function of no arguments that solves the batch
    (bench's draw at B, or ``x0s``) in float32 from each lane's rollout
    and certifies it in float64; returns ``(sols, residual, solve_s,
    certify_s)`` after a synchronise."""
    device = torch.device(device)
    tr, bounds, prm, settings = sweep_problem(S, backend, device)
    solve = make_batch_solver(tr, bounds, prm, settings, rollout_guess=True)
    prm64 = tr.params(d=[0.05], t0=0.0, tf=2.0, dtype=torch.float64,
                      device=device)
    bounds64 = bounds._replace(**{f: getattr(bounds, f).to(torch.float64)
                                  for f in bounds._fields})
    x0 = torch.as_tensor(bench_x0s(B) if x0s is None else x0s,
                         dtype=torch.float32, device=device)

    def once():
        t0 = time.perf_counter()
        sols = solve(x0)
        _sync(device)
        t1 = time.perf_counter()
        kkt = certify(tr, x0, sols, bounds64, prm64)
        _sync(device)
        return sols, kkt, t1 - t0, time.perf_counter() - t1
    return once


def run_point(S: int, backend: str, B: int, reps: int = 3, device="cuda",
              x0s=None, warmup: bool = True):
    """One row of the sweep: an optional warm-up solve, then ``reps`` timed
    solve + certify repetitions (median wall).  Returns ``(row, lanes)``;
    a row whose backend's kernel does not fit is ``{..., "skipped": ...}``
    with ``lanes`` None.  ``lanes`` holds the per-lane numpy arrays
    residual, certified, status, iters, x and lam (of the median
    repetition; every repetition solves the same lanes)."""
    tr = _transcription(S)
    n, m = tr.nlp.n, tr.nlp.m
    head = {"segments": S, "backend": backend, "nodes": tr.N, "K": n + m,
            "k_block": tr.bbt_structure().k, "batch": B}
    if not _fits(tr, backend):
        return {**head, "route": "skipped",
                "skipped": f"the {backend} epoch kernel does not fit "
                           f"K={n + m}"}, None
    once = batch_fn(S, backend, B, device, x0s)
    if warmup:
        once()
    runs = [once() for _ in range(reps)]
    walls = [s + c for _, _, s, c in runs]
    i = int(np.argsort(walls)[len(walls) // 2])
    sols, kkt, solve_s, cert_s = runs[i]
    res = kkt.cpu().numpy()
    ok = res <= KKT_TOL
    status = sols.status.cpu().numpy()
    iters = sols.iters.cpu().numpy()
    wall = walls[i]
    solved = int((status == st.SOLVED).sum())
    row = {**head, "route": route_of(S, backend),
           "wall_s_per_batch": wall, "solve_s": solve_s,
           "certify_s": cert_s, "walls": walls, "solved": solved,
           "certified": int(ok.sum()),
           "mean_sqp_iters": float(iters.mean()),
           "solves_per_s": solved / wall,
           "certified_solves_per_s": int(ok.sum()) / wall}
    lanes = {"residual": res, "certified": ok, "status": status,
             "iters": iters, "x": sols.x.cpu().numpy(),
             "lam": sols.lam.cpu().numpy()}
    return row, lanes


def sweep(segments=SEGMENTS, device="cuda", reps=None, x0s=None):
    """Every row of :func:`sweep_rows` by :func:`run_point` after a
    warm-up, at B = :func:`batch_of` (S); ``reps(S)`` repetitions (default
    3 at S <= 4 and 1 above).  ``x0s(S, B)`` gives a row's initial states
    (default bench's draw).  Yields ``(row, lanes)`` as each row ends."""
    reps = reps or (lambda S: 3 if S <= 4 else 1)
    for S, backend in sweep_rows(segments):
        B = batch_of(S)
        yield run_point(S, backend, B, reps(S), device,
                        None if x0s is None else x0s(S, B))


def first_epoch(S: int, backend: str, B: int, device="cuda", x0s=None):
    """The point's first boxADMM epoch as the path runs it
    (``nlp.sqp.first_epoch`` from each lane's rollout with node 0 pinned
    and zero multipliers): (settings.qp, the 13 epoch arguments)."""
    from polympc_torch.nlp import sqp
    from polympc_torch.parallel import pin_initial_state
    device = torch.device(device)
    tr, bounds, prm, settings = sweep_problem(S, backend, device)
    x0 = torch.as_tensor(bench_x0s(B) if x0s is None else x0s,
                         dtype=torch.float32, device=device)
    bnd, x0sc = pin_initial_state(tr, bounds, x0)
    z0 = tr.rollout_guess(x0, prm)
    z0[:, :tr.ocp.nx] = x0sc
    return settings.qp, sqp.first_epoch(tr.nlp, z0, prm, bnd,
                                        settings=settings)


def run_kernel_micro(S: int, backend: str, B: int, device="cuda",
                     iters: int = 50, sweeps: int = 20):
    """scaling.py's measured epoch time: the real regularised kite KKT at
    a mid-solve point (z, lam from ``default_rng(5)``, Hessian mirrored
    with ridge 1e-4, rho = 1, box penalty rb = 0.1), broadcast to B lanes,
    ``sweeps`` epochs of ``iters`` iterations back to back (each from the
    last one's state) between two CUDA events.  Returns the row (ms per
    epoch over the batch, and scaling.py's bytes and factor-FLOP model of
    one epoch), or a skipped row where the backend's kernel does not fit.
    Unlike scaling.py the KKT's primal block carries the box penalty
    diag(rb) the iteration uses: without it the epochs are not the ADMM's
    own and the state overflows within the first epoch (1e24 after 50
    iterations on the CPU's plain version, NaN after two epochs)."""
    from polympc_torch.nlp.hessian import regularize
    from polympc_torch.nlp.sqp import derivative_fns, exact_hessian_fn
    from polympc_torch.utils.precision import full_precision
    device = torch.device(device)
    tr, _, prm, _ = sweep_problem(S, backend, device)
    n, m = tr.nlp.n, tr.nlp.m
    K, stb = n + m, tr.bbt_structure()
    head = {"mode": "kernel_micro", "segments": S, "backend": backend,
            "K": K, "k_block": stb.k, "batch": B, "iters_per_epoch": iters}
    if backend not in BACKENDS or not _fits(tr, backend):
        return {**head, "skipped": f"the {backend} epoch kernel does not "
                                   f"fit K={K}"}
    rng = np.random.default_rng(5)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    z = f32(rng.standard_normal(n) * 0.1)[None]
    lam = f32(rng.standard_normal(m) * 0.1)[None]
    sigma, rho_v, rb = 1e-6, 1.0, 0.1
    with full_precision():
        H = regularize(exact_hessian_fn(tr.nlp, prm)(z, lam), "mirror",
                       1e-4)[0]
        A = derivative_fns(tr.nlp, prm)[1](z)[0]
    eye = lambda k: torch.eye(k, dtype=torch.float32, device=device)
    kkt1 = torch.cat([torch.cat([H + (sigma + rb) * eye(n), A.T], 1),
                      torch.cat([A, -eye(m) / rho_v], 1)], 0)
    kkt = kkt1.expand(B, K, K).contiguous()
    h = f32(rng.standard_normal(n)).expand(B, n).contiguous()
    full = lambda k, v: torch.full((B, k), v, device=device)
    consts = (kkt, h, full(m, 0.0), full(m, 0.0), full(n, -1.0),
              full(n, 1.0), full(m, rho_v), full(n, rb))
    kw = dict(sigma=sigma, alpha=1.6, iters=iters)
    if backend == "bbt":
        epoch = lambda *s: bbt_admm_epoch_batched(*consts, *s, st=stb, **kw)
    else:
        epoch = lambda *s: admm_epoch_batched(*consts, *s, **kw)
    state = (full(n, 0.0), full(m, 0.0), full(n, 0.0), full(m, 0.0),
             full(n, 0.0))

    def many(s):
        for _ in range(sweeps):
            s = epoch(*s)
        return s
    many(state)
    torch.cuda.synchronize(device)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = many(state)
    b.record()
    torch.cuda.synchronize(device)
    if not all(torch.isfinite(t).all() for t in out):
        raise RuntimeError(f"run_kernel_micro S={S} {backend}: non-finite "
                           "epoch state")
    ms = a.elapsed_time(b) / sweeps
    k = stb.k
    kkt_values = K * K if backend == "dense" else \
        S * k * k + 2 * S * k * max(1, stb.a)
    nbytes = 4 * (kkt_values + 3 * (n + m) + 2 * n)
    flops = K ** 3 / 3 if backend == "dense" else S * k ** 3 / 3
    return {**head, "measured_ms_per_epoch_batch": ms,
            "measured_us_per_epoch_lane": ms / B * 1e3,
            "model_bytes_per_epoch_lane": nbytes,
            "model_factor_flops_per_epoch_lane": flops,
            "gb_per_s": nbytes * B / ms / 1e6,
            "factor_gflops_per_s": flops * B / ms / 1e6}
