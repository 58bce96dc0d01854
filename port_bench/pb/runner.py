"""One run of one cell: set-up, the measured window, the check, the
metrics, and the result's line."""
from __future__ import annotations

import contextlib
import gc
import math
import time
import types

import torch

from port_bench.pb import check
from port_bench.pb.hooks import Hook
from port_bench.pb.profile import Profiled
from port_bench.pb.spec import Cell
from port_bench.pb.traffic import BatchTraffic, LoopTraffic, Spans, sync


class _Gate:
    """Profiles the first ``n`` units of the window."""

    def __init__(self, n, cuda):
        self.n, self.cuda, self.prof, self.closed = n, cuda, None, None

    @contextlib.contextmanager
    def __call__(self, i):
        if i == 0 and self.n > 0:
            self.prof = Profiled(self.n, self.cuda)
            self.prof.__enter__()
        try:
            yield
        finally:
            if self.prof is not None and self.closed is None \
                    and i == self.n - 1:
                self.prof.__exit__(None, None, None)
                self.closed = self.n

    def close(self, units):
        if self.prof is not None and self.closed is None:
            self.prof.__exit__(None, None, None)
            self.prof.units = self.closed = units


def _finite(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def prepare(cell, device, traffic_overrides=None):
    """The cell's traffic settings, reference NLP and traffic generator, set up (the
    program's problem built and the cell's shapes warmed up)."""
    traffic = dict(cell.traffic)
    traffic.update(traffic_overrides or {})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfgmod, ref = cell.loader(), cell.reference()
    refnlp = ref.nlp(cell.cfg)
    problem = cfgmod.build(cell.cfg, device)
    if traffic["kind"] == "batch":
        drv = BatchTraffic(problem, cfgmod, cell.cfg, traffic, device)
    elif traffic["kind"] == "loop":
        drv = LoopTraffic(problem, cfgmod, cell.cfg, traffic, device, refnlp)
    else:
        raise ValueError(f"unknown traffic kind {traffic['kind']!r}")
    drv.setup()
    sync(device)
    return traffic, refnlp, drv


def compared(cell, traffic, units, refnlp, seed, device, control=False):
    """The numbers the check compares for one window's units."""
    kind = traffic["kind"]
    pick = check.sample(units, int(traffic["sample_lanes"]), seed) \
        if kind == "batch" else None
    return check.numbers(kind, units, refnlp, cell.cfg, device,
                         control=control, pick=pick)


def run_cell(workload, seed, seconds, trace, device="cuda",
             traffic_overrides=None, control=False, t_begin=None):
    """Run the cell once; returns (result, check lines for stderr)."""
    t_begin = time.perf_counter() if t_begin is None else t_begin
    cell = Cell(workload)
    cfg = cell.cfg
    limits = cell.limits()
    cuda = torch.device(device).type == "cuda"
    traffic, refnlp, drv = prepare(cell, device, traffic_overrides)
    setup_s = time.perf_counter() - t_begin

    wanted = cell.per_layer() if trace else cell.end_to_end()
    readers = {m["name"]: cell.metric_module(m["name"]) for m in wanted}
    hooks = {}
    if trace:
        for name, mod in readers.items():
            target = getattr(mod, "HOOK", None)
            if target:
                hooks[name] = Hook(target, mod.describe, cfg, device)
                hooks[name].install()
    gate = _Gate(int(traffic["trace_units"]) if trace else 0, cuda)
    try:
        units, window_s = drv.run(seed, seconds, Spans(trace, device), gate)
        gate.close(len(units))
    finally:
        for h in hooks.values():
            h.remove()
    hook_calls = {name: h.results() for name, h in hooks.items()}
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    profile = gate.prof.reduce() if gate.prof is not None else None

    del drv
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    kind = traffic["kind"]
    failed_steps = sum(u["failed"] for u in units) if kind == "loop" \
        else None
    nums = compared(cell, traffic, units, refnlp, seed, device, control)
    correct, checks = check.judge(nums, limits, failed_steps)

    ctx = types.SimpleNamespace(kind=kind, units=units, window_s=window_s,
                                setup_s=setup_s, profile=profile,
                                hooks=hook_calls, cfg=cfg, traffic=traffic)
    metrics = {}
    for m in wanted:
        value = readers[m["name"]].read(ctx)
        if value is not None and _finite(float(value)) is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    if kind == "batch":
        audit = [u for u in units if u["audit"]]
        attempted = sum(u["lanes"] for u in audit)
        failed = attempted - sum(u["certified"] for u in audit)
    else:
        attempted, failed = len(units), failed_steps
    dev = {"platform": "gpu" if cuda else torch.device(device).type,
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if profile is not None:
        dev["busy_s"] = profile["busy_s"]
        dev["window_s"] = profile["window_s"]
        result["breakdown"] = {"device_ops": profile["device_ops"],
                               "idle_gaps": profile["idle_gaps"]}
    result["checks"] = {k: {"value": _finite(c["value"]),
                            "limit": c["limit"]} for k, c in checks.items()}
    lines = [f"check {k} = {c['value']!r} (limit {c['limit']!r})"
             for k, c in checks.items()]
    lines.append(f"check correct = {bool(correct)}")
    return result, lines
