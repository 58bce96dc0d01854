"""Timing / profiling utilities on the card's own clocks — the port of
polympc_tpu/utils/timing.py.

The reference's only instrumentation is a wall-clock helper
(``polympc::get_time``, utils/helpers.hpp:60-71) that tests wrap around
``solve()`` calls.  On a CUDA card two extra steps matter: kernel launches
are asynchronous (synchronise before reading a clock) and the first call
pays the kernels' build and the libraries' set-up (warm up before
measuring).  ``Timer`` stops the host clock after synchronising the
cards its results live on; ``time_fn`` brackets its repetitions with CUDA
events where the results live on one card (the card's clock, in its
stream) and with a synchronised host clock otherwise; ``trace`` wraps
``torch.profiler`` and writes a Chrome trace (view it in Perfetto or
chrome://tracing).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import torch

__all__ = ["get_time", "Timer", "time_fn", "SolveStats", "trace"]


def get_time() -> float:
    """Monotonic wall-clock seconds (helpers.hpp:60-71)."""
    return time.perf_counter()


def _cuda_devices(obj, found=None):
    """The CUDA devices of every tensor in a nest of tuples, lists, dicts
    and named tuples."""
    found = set() if found is None else found
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            found.add(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _cuda_devices(v, found)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            _cuda_devices(v, found)
    return found


def _sync(results):
    for dev in _cuda_devices(results):
        torch.cuda.synchronize(dev)


class Timer:
    """Context manager: ``with Timer() as t: ...; t.elapsed`` seconds.

    ``block_on(results)`` names the results to wait for: their cards are
    synchronised before the host clock stops, so asynchronous launches
    cannot fake a fast solve.
    """

    def __init__(self):
        self.elapsed = 0.0
        self._results = None

    def block_on(self, results):
        self._results = results
        return results

    def __enter__(self):
        self._t0 = get_time()
        return self

    def __exit__(self, *exc):
        if self._results is not None:
            _sync(self._results)
        self.elapsed = get_time() - self._t0
        return False


@dataclasses.dataclass
class SolveStats:
    """Solve-rate counters for a timed batch of solves."""
    iters: int              # timed repetitions
    batch: int              # instances per repetition
    total_s: float          # wall-clock for all repetitions
    mean_s: float           # per-repetition wall clock
    solves_per_s: float     # batch * iters / total_s

    def __str__(self):
        return (f"{self.solves_per_s:.1f} solves/s "
                f"({self.mean_s * 1e3:.3f} ms per call, batch {self.batch})")


def time_fn(fn, *args, iters: int = 10, warmup: int = 2,
            batch: int = 1) -> SolveStats:
    """Time ``fn(*args)`` after ``warmup`` calls (at least one).  Where the
    output lives on a card, the repetitions are bracketed by CUDA events on
    that card (its clock); otherwise by the host clock after synchronising
    every card the output touches."""
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    devs = _cuda_devices(out)
    _sync(out)
    if len(devs) == 1:
        dev = next(iter(devs))
        with torch.cuda.device(dev):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            for _ in range(iters):
                out = fn(*args)
            ev[1].record()
            ev[1].synchronize()
        total = ev[0].elapsed_time(ev[1]) / 1e3
    else:
        with Timer() as timer:
            for _ in range(iters):
                out = fn(*args)
            timer.block_on(out)
        total = timer.elapsed
    return SolveStats(iters=iters, batch=batch, total_s=total,
                      mean_s=total / iters,
                      solves_per_s=batch * iters / total if total > 0
                      else float("inf"))


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace context (CPU activity, and CUDA activity
    where a card is present): on exit writes ``<log_dir>/trace.json``, a
    Chrome trace; yields the profiler (``key_averages()`` etc.)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
