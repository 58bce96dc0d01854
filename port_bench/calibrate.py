#!/usr/bin/env python3
"""The readings a cell's limits are set from: the program's and the
control's numbers over many seeds, in one process on the card.

    python3 port_bench/calibrate.py --workload <cell> --seconds <s>
                                    --seeds <n1,n2,...>

It sets the cell up once, then for each seed runs a window of ``--seconds``
(long enough to compare as many answers as a run compares), and prints one
JSON line per seed: the compared numbers of the program's outputs, and of
the control (the reference in the program's place at the precision below
the configuration's) on the same outputs.  A last line gives, per number,
the largest program reading and the smallest control reading.  The
benchmark's own runs never run the control.
"""
import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from port_bench.pb.runner import compared, prepare
    from port_bench.pb.spec import Cell
    from port_bench.pb.traffic import Spans
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = Cell(args.workload, ROOT)
    traffic, refnlp, drv = prepare(cell, "cuda")
    off = lambda i: contextlib.nullcontext()
    high, low = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        units, window_s = drv.run(seed, args.seconds,
                                  Spans(False, "cuda"), off)
        prog = compared(cell, traffic, units, refnlp, seed, "cuda")
        ctrl = compared(cell, traffic, units, refnlp, seed, "cuda",
                        control=True)
        for k, v in prog.items():
            high[k] = max(high.get(k, v), v)
            low[k] = min(low.get(k, ctrl[k]), ctrl[k])
        print(json.dumps({"seed": seed, "units": len(units),
                          "window_s": window_s, "program": prog,
                          "control": ctrl}), flush=True)
    print(json.dumps({"workload": args.workload, "program_max": high,
                      "control_min": low}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
