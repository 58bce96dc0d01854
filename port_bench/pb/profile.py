"""The device trace of a traced run, reduced to numbers.

``torch.profiler`` (CPU and CUDA activities) records the first units of
the window.  From its raw events this module takes:

* busy: the length of the union of the device activities' intervals
  (kernels, copies, sets; not the spans' labels that the profiler copies
  onto the device timeline) inside the profiled window, ``busy_ms`` of
  ``trace_port.py:123`` (copied); the window is the wall of the profiled
  units themselves, so a busy share is over the profiled wall;
* launches: the device activities in the window;
* the device operations with the most time, by name;
* the idle gaps between device activities, each named by what the host's
  main thread was doing at the gap's middle (the innermost host event open
  there: an operator, a runtime call such as a synchronise, or the
  harness's own span where Python ran between operators), summed by name.
"""
from __future__ import annotations

WINDOW = "port_bench.window"


def busy_ms(intervals):
    """Length of the union of (start, end) intervals, in ms (intervals in
    microseconds)."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def _innermost(events, points):
    """For each point (sorted), the name of the innermost event (start, end,
    name; sorted by start, then longest first) open there, or None."""
    names, stack, i = [], [], 0
    for t in points:
        while i < len(events) and events[i][0] <= t:
            e = events[i]
            while stack and stack[-1][1] <= e[0]:
                stack.pop()
            stack.append(e)
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        names.append(stack[-1][2] if stack else None)
    return names


def _interval_ns(e):
    """(start, end) of a raw profiler event in ns, in either PyTorch's
    naming of the accessors."""
    if hasattr(e, "start_ns"):
        start = e.start_ns()
        return start, start + e.duration_ns()
    start = e.start_us() * 1000
    return start, start + e.duration_us() * 1000


def _annotation(e):
    """A span's label copied onto the device timeline, not an activity
    (older PyTorch has no ``activity_type`` on its events)."""
    kind = getattr(e, "activity_type", None)
    return (e.name().startswith("port_bench.")
            or (kind is not None and kind() == "gpu_user_annotation"))


class Profiled:
    """Context manager around the profiled units; ``reduce()`` afterwards."""

    def __init__(self, units: int, cuda: bool = True):
        self.units, self.cuda = units, cuda
        self.prof = None
        self._span = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._span = record_function(WINDOW)
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        import torch
        if self.cuda:
            torch.cuda.synchronize()
        self._span.__exit__(*exc)
        self.prof.__exit__(*exc)
        return False

    def reduce(self, top: int = 10):
        from torch.autograd import DeviceType
        events = self.prof.profiler.kineto_results.events()
        win = None
        host, dev = [], []
        for e in events:
            kind = e.device_type()
            start, end = _interval_ns(e)
            if kind == DeviceType.CUDA:
                if not _annotation(e):
                    dev.append((start, end, e.name()))
            elif kind == DeviceType.CPU:
                if e.name() == WINDOW:
                    win = (start, end, e.start_thread_id())
                host.append((start, end, e.name(), e.start_thread_id()))
        if win is None:
            raise RuntimeError("the profiled window's span is missing")
        w0, w1, thread = win
        dev = [(max(a, w0), min(b, w1), n) for a, b, n in dev
               if b > w0 and a < w1]
        busy_s = busy_ms((a / 1e3, b / 1e3) for a, b, _ in dev) / 1e3
        by_name = {}
        for a, b, n in dev:
            by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = _union((a, b) for a, b, _ in dev)
        gaps, prev = [], w0
        for a, b in busy:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if w1 > prev:
            gaps.append((prev, w1))
        main = sorted(((a, b, n) for a, b, n, t in host
                       if t == thread and n != WINDOW),
                      key=lambda e: (e[0], -e[1]))
        mids = sorted(((a + b) / 2, b - a) for a, b in gaps)
        names = _innermost(main, [m for m, _ in mids])
        idle = {}
        for (_, length), n in zip(mids, names):
            key = n or "python (no host event open)"
            idle[key] = idle.get(key, 0.0) + length / 1e9
        gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"busy_s": busy_s, "window_s": (w1 - w0) / 1e9,
                "launches": len(dev),
                "units": self.units,
                "device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": [[n[:120], s] for n, s in gaps_top]}
