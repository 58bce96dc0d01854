#!/usr/bin/env python3
"""Where the time goes in the port's batched paths, on one NVIDIA card.

    python3 trace_port.py [kite] [spline] [frame] [race_car]

Each named path (all four by default) is built at the widths that
chip_smoke.py drives: bench's certified kite batch (B=512), the spline QP
batch (B=4096), the frame-transform batch (B=4096) and the certified
race-car batch (B=512).  Its timed unit runs once to warm up, once timed on
the host clock (ending in torch.cuda.synchronize()), then once under
torch.profiler with CPU and CUDA activities.  Per path one JSON line:

  wall_ms           the unprofiled wall of one unit;
  profiled_wall_ms  the wall under the profiler (which inflates host time);
  device_ms         the union of the device activities' intervals (kernels,
                    copies, sets);
  busy_share        device_ms / profiled_wall_ms;
  launches          the device activities of the unit (kernels, copies,
                    sets), and kernel_launches the kernels among them;
  top_kernels       the eight kernels with the most device time (ms, count);
  top_host_ops      the eight operators with the most self host time.

Needs a card; imports nothing of JAX.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def units(dev):
    """name -> a function of no arguments running one batched unit."""
    import torch
    from polympc_torch import headline, headline_table as ht
    from polympc_torch.control.path import project_on_path_newton
    from polympc_torch.qp import box_admm_solve

    def spline():
        _, big = ht.spline_batch(4096, dev)
        s = ht.spline_settings()
        return lambda: box_admm_solve(big, settings=s)

    def frame():
        path, _, (pts, s0s, _) = ht.frame_batch(4096, dev)
        return lambda: project_on_path_newton(path, pts, s0=s0s,
                                              dtype=torch.float32)

    def race_car():
        tr, bounds, _, solve, sol = ht.race_car_cold(dev)
        return ht.race_car_batch_fn(tr, bounds, solve, sol, 512)

    return {"kite": lambda: headline.batch_fn(512, dev), "spline": spline,
            "frame": frame, "race_car": race_car}


def busy_ms(intervals):
    """Length of the union of (start, end) intervals, in ms."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def trace(name, fn):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        pwall = (time.perf_counter() - t0) * 1e3
    dev_events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
    kernels = {}
    for e in dev_events:
        k = kernels.setdefault(e.name, [0.0, 0])
        k[0] += e.time_range.elapsed_us() / 1e3
        k[1] += 1
    host = sorted(((a.key, a.self_cpu_time_total / 1e3, a.count)
                   for a in prof.key_averages()
                   if a.device_type == DeviceType.CPU),
                  key=lambda r: -r[1])
    dms = busy_ms((e.time_range.start, e.time_range.end)
                  for e in dev_events)
    is_kernel = lambda n: not n.startswith(("Memcpy", "Memset"))
    return {
        "path": name, "wall_ms": wall, "profiled_wall_ms": pwall,
        "device_ms": dms, "busy_share": dms / pwall,
        "launches": len(dev_events),
        "kernel_launches": sum(c for n, (_, c) in kernels.items()
                               if is_kernel(n)),
        "top_kernels": [[n[:80], ms, c] for n, (ms, c) in sorted(
            kernels.items(), key=lambda kv: -kv[1][0])[:8]],
        "top_host_ops": [[k[:60], ms, c] for k, ms, c in host[:8]],
    }


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("trace_port: torch.cuda.is_available() is false; "
                         "the trace needs a CUDA card")
    sys.path.insert(0, ROOT)
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], f"; torch {torch.__version__}",
          flush=True)
    table = units(dev)
    for name in sys.argv[1:] or list(table):
        print(json.dumps(trace(name, table[name]())), flush=True)


if __name__ == "__main__":
    main()
