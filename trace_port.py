#!/usr/bin/env python3
"""Where the time goes in the port's batched paths, on one NVIDIA card.

    python3 trace_port.py [kite] [spline] [frame] [race_car] [dist_kite_s8]
                          [dist_sharded] [cstr] [kite_ip] [kite_ms]
                          [sweep_s8] [long_horizon]

Each named path (all eleven by default) is built at the widths that
chip_smoke.py drives: bench's certified kite batch (B=512), the spline QP
batch (B=4096), the frame-transform batch (B=4096), the certified
race-car batch (B=512), the certified horizon-partitioned kite batch
(S=8 segments, B=128, polympc_torch/dist_point.py), cut to its first
DIST_TRACE_ITERS SQP iterations: every lane is still active there and
every inner QP runs to its 400-iteration cap, so each iteration does the
same work, while the whole 60-iteration batch under the profiler outlasts
15 minutes; the same cut batch through make_batch_dist_solver on a
("dp", "seg") mesh of one rank in a one-rank NCCL group (dist_sharded:
chip_smoke.py's path of that name, whose Schur solves all_gather over the
"seg" group); and the certified CSTR batch (B=256,
polympc_torch/cstr_point.py), cut to its first CSTR_TRACE_ITERS SQP
iterations (its lanes run 7 to 150, 59 on average in the JAX record); and
bench's kite batch through the float64 interior point (B=512,
polympc_torch/solvers_point.py), cut to its first KITE_IP_TRACE_ITERS
iterations (its lanes run 22 to 100, 52 on average in the JAX record);
and bench's kite by multiple shooting (B=512, polympc_torch/
ocp_extras_point.py: whole-vector torch.func derivatives, the dense epoch
kernel at K=125, the float64 certify), whole; and the horizon sweep's S=8
point (polympc_torch/scaling_point.py: the kite on Chebyshev(5) x 8,
B=128, the BBT epoch at 8 blocks of k=72, the float64 certify by LU at
K=492), whole; and the long-horizon batch (polympc_torch/
long_horizon_point.py: the pendulum on S=512 Chebyshev(4) segments, B=32
lanes, 12 float64 Newton steps of parallel/long_horizon.py: the segment
blocks by torch.func, the interface by torch.linalg.solve), one solve.
Its timed unit runs once to warm up, once timed on the host
clock (ending in torch.cuda.synchronize()), then once under torch.profiler
with CPU and CUDA activities.  Per path one JSON line:

  wall_ms           the unprofiled wall of one unit;
  profiled_wall_ms  the wall under the profiler (which inflates host time);
  device_ms         the union of the device activities' intervals (kernels,
                    copies, sets);
  busy_share        device_ms / profiled_wall_ms;
  launches          the device activities of the unit (kernels, copies,
                    sets), and kernel_launches the kernels among them;
  top_kernels       the eight kernels with the most device time (ms, count);
  top_host_ops      the eight operators with the most self host time;
  collectives       the NCCL kernels ([name, device ms, count]) and the
                    host operators of the c10d collectives ([name, self
                    host ms, total host ms, count]).

Needs a card; imports nothing of JAX.
"""
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DIST_TRACE_ITERS = 3
CSTR_TRACE_ITERS = 10
KITE_IP_TRACE_ITERS = 10


def units(dev):
    """name -> a function of no arguments running one batched unit."""
    import torch
    from polympc_torch import cstr_point, dist_point, headline
    from polympc_torch import ocp_extras_point, scaling_point, solvers_point
    from polympc_torch.nlp import IPNLPSettings, nlp_ip_solve
    from polympc_torch import headline_table as ht
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

    def kite_ip():
        tr, bounds, prm, _ = headline.kite_problem(dev, torch.float64)
        x0 = torch.as_tensor(headline.bench_x0s(512), dtype=torch.float64,
                             device=dev)
        z0, bnd = solvers_point.kite_ip_start(tr, bounds, x0)
        s = IPNLPSettings(max_iter=KITE_IP_TRACE_ITERS)
        return lambda: nlp_ip_solve(tr.nlp, z0, p=prm, bounds=bnd,
                                    settings=s)

    def dist_sharded():
        from polympc_torch.multichip_point import free_port
        from polympc_torch.parallel import initialize_multihost, mesh_2d
        initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0, device=dev)
        return dist_point.batch_fn(128, dev, max_iter=DIST_TRACE_ITERS,
                                   mesh=mesh_2d(1, 1))

    def long_horizon():
        from polympc_torch import long_horizon_point as lp
        return lp.batch_fn(lp.LANES, dev)[1]

    return {"kite": lambda: headline.batch_fn(512, dev), "spline": spline,
            "frame": frame, "race_car": race_car,
            "dist_kite_s8": lambda: dist_point.batch_fn(
                128, dev, max_iter=DIST_TRACE_ITERS),
            "dist_sharded": dist_sharded,
            "cstr": lambda: cstr_point.batch_fn(
                256, dev, max_iter=CSTR_TRACE_ITERS),
            "kite_ip": kite_ip,
            "kite_ms": lambda: ocp_extras_point.batch_fn(512, dev),
            "sweep_s8": lambda: scaling_point.batch_fn(8, "bbt", 128, dev),
            "long_horizon": long_horizon}


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
    averages = [a for a in prof.key_averages()
                if a.device_type == DeviceType.CPU]
    host = sorted(((a.key, a.self_cpu_time_total / 1e3, a.count)
                   for a in averages), key=lambda r: -r[1])
    comm = re.compile(r"nccl|c10d|gather", re.I)
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
        "collectives": {
            "kernels": [[n[:80], ms, c] for n, (ms, c) in kernels.items()
                        if "nccl" in n.lower()],
            "host_ops": [[a.key[:60], a.self_cpu_time_total / 1e3,
                          a.cpu_time_total / 1e3, a.count]
                         for a in averages if comm.search(a.key)]},
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
    try:
        for name in sys.argv[1:] or list(table):
            print(json.dumps(trace(name, table[name]())), flush=True)
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
