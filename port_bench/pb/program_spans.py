"""The program's own spans and counters (``polympc_torch.utils.timing``),
reduced per root span.

``start()`` turns the program's recorder on, once per process; every
reader of a ``program_span`` or ``program_counter`` metric built on it
calls ``start()`` when it is imported.  The runner (``pb/runner.py``)
imports per-layer readers only in a ``--trace 1`` run, after set-up and
before the measured window, so the recorder covers exactly the traced
window (the check after it runs no program code), and no ``--trace 0``
run, the kind whose end-to-end numbers are compared, ever turns it on.

``reduce()`` returns the recorded roots that no profiler saw, with each
root's seconds summed per span name (the root's own name included) and
its counts.  A share built on it is host time: summed span time over the
summed time of the roots; work the host has only enqueued on the device
shows where the host later waits for it, in the ``sync`` spans.  Against
a program without the recorder, ``reduce()`` returns None and the readers
read nothing."""
from __future__ import annotations

_started = False


def _timing():
    try:
        from polympc_torch.utils import timing
    except ImportError:
        return None
    return timing if hasattr(timing, "start_recording") else None


def start():
    """Turn the program's recorder on (once per process)."""
    global _started
    timing = _timing()
    if _started or timing is None:
        return
    timing.start_recording()
    _started = True


def reduce(recording=None):
    """[{"name", "wall_s", "spans": {name: s}, "counts": {name: n}}] per
    root span that no profiler saw, in the order the roots closed;
    ``recording`` defaults to what the program recorded.  None if nothing
    was recorded."""
    if recording is None:
        timing = _timing()
        if timing is None or not _started:
            return None
        recording = timing.recorded()
    roots = {s.id: s for s in recording.spans
             if s.parent is None and not s.attrs.get("profiled")}
    spans = {i: {} for i in roots}
    for s in recording.spans:
        per = spans.get(s.root)
        if per is not None:
            per[s.name] = per.get(s.name, 0.0) + (s.end_ns - s.start_ns) / 1e9
    return [{"name": r.name, "wall_s": (r.end_ns - r.start_ns) / 1e9,
             "spans": spans[i],
             "counts": dict(recording.root_counts.get(i, {}))}
            for i, r in roots.items()] or None


def share(roots, parts, of):
    """100 x the seconds of the spans named in ``parts`` over the wall of
    the roots named in ``of``, summed over those roots; None if there are
    none."""
    if not roots:
        return None
    picked = [r for r in roots if r["name"] in of]
    wall = sum(r["wall_s"] for r in picked)
    spent = sum(r["spans"].get(p, 0.0) for r in picked for p in parts)
    return 100.0 * spent / wall if wall > 0 else None


def per_unit(roots, counter, of, unit):
    """The count ``counter`` summed over the roots named in ``of``, per
    root named ``unit``; None if there is no such root."""
    if not roots:
        return None
    units = sum(r["name"] == unit for r in roots)
    total = sum(r["counts"].get(counter, 0) for r in roots
                if r["name"] in of)
    return total / units if units else None
