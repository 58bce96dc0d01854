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

Those wrap a whole call from outside.  Inside the program, ``span`` and
``count`` mark where the work happens (the SQP loop, the derivatives, the
QP epochs, the certify's Newton steps, the host's blocking reads); they
record only between ``start_recording()`` and ``stop_recording()``, and
``recorded()`` hands back what they saw.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

__all__ = ["get_time", "Timer", "time_fn", "SolveStats", "trace", "span",
           "count", "start_recording", "stop_recording", "recorded",
           "SpanRecord", "Recording"]


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


# ---------------------------------------------------------------------------
# In-program spans and counters

class SpanRecord(NamedTuple):
    """One closed span: ``root`` is the id of the outermost span open when
    it began (its own id for a root), shared by every span of one call."""
    id: int
    parent: int | None
    root: int
    name: str
    start_ns: int
    end_ns: int
    attrs: dict


class Recording(NamedTuple):
    """What the recorder saw: the closed spans in the order they closed,
    each counter's total, and each counter per root span (key None for a
    count made outside any span)."""
    spans: list
    counts: dict
    root_counts: dict


_recording = False
_spans: list = []
_root_counts: dict = {}
_open: list = []
_next_id = 0


class _NoSpan:
    """The span handed out while nothing records: one shared object."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "root", "start", "label")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs

    def set(self, **attrs):
        """Add attributes known only inside the span."""
        self.attrs.update(attrs)

    def __enter__(self):
        global _next_id
        self.id = _next_id
        _next_id += 1
        profiled = _profiler._is_profiler_enabled
        if _open:
            up = _open[-1]
            self.parent, self.root = up.id, up.root
        else:
            self.parent, self.root = None, self.id
            self.attrs["profiled"] = profiled
        _open.append(self)
        self.label = _RecordFunctionFast("polympc." + self.name) \
            if profiled else None
        self.start = time.time_ns()
        if self.label is not None:
            self.label.__enter__()
        return self

    def __exit__(self, *exc):
        if self.label is not None:
            self.label.__exit__(*exc)
        end = time.time_ns()
        _open.pop()
        _spans.append(SpanRecord(self.id, self.parent, self.root, self.name,
                                 self.start, end, self.attrs))
        return False


def span(name: str, **attrs):
    """Context manager marking one piece of the program's work.

    While nothing records (the default) it returns one shared no-op object
    after a single flag check.  While recording it notes (id, parent id,
    root id, name, start, end, attrs) when it closes; a span opened with
    no other open is a root, and its ``attrs["profiled"]`` says whether a
    ``torch.profiler`` was recording when it began.  Times are
    nanoseconds of ``time.time_ns()``, the Unix-epoch clock on which
    ``torch.profiler`` stamps its host events (torch 2.11 with CUDA 12.8
    on an H100 machine and torch 2.13 on the CPU); the start is read just
    before, the end just after, the span's label "polympc." + name, which
    it opens only while a profiler records.  So the span brackets its
    label on the profiler's timeline, and an idle gap of the device is
    named by the innermost span open there.  The label is a host operator
    event (``_RecordFunctionFast``), not a ``record_function`` user
    annotation: the profiler copies user annotations onto the device
    timeline, where readers that cannot tell the kinds apart (torch 2.11's
    events carry no activity type) would count them as device work.
    A span adds no synchronisation and no tensor operation."""
    if not _recording:
        return _NO_SPAN
    return _Span(name, attrs)


def count(name: str, n: int = 1):
    """Add ``n`` to counter ``name`` under the root span now open (None
    outside any span) while recording; nothing otherwise."""
    if not _recording:
        return
    per = _root_counts.setdefault(_open[0].id if _open else None, {})
    per[name] = per.get(name, 0) + n


def start_recording():
    """Clear the recorder and turn it on."""
    global _recording
    _spans.clear()
    _root_counts.clear()
    _recording = True


def stop_recording():
    """Turn the recorder off; what it recorded stays until the next
    ``start_recording()``."""
    global _recording
    _recording = False


def recorded() -> Recording:
    """The spans closed and the counts made since ``start_recording()``
    (copies; nothing is written anywhere)."""
    counts = {}
    for per in _root_counts.values():
        for name, n in per.items():
            counts[name] = counts.get(name, 0) + n
    return Recording(list(_spans), counts,
                     {k: dict(v) for k, v in _root_counts.items()})
