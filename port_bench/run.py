#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
                              --trace <0|1>

from the root of a checkout.  It builds the cell's problem on the card from
``--seed``, warms up the cell's shapes, measures for ``--seconds``, checks
the outputs against the plain reference, and prints the result as one JSON
object on the last line of standard output (the compared numbers beside
their limits also as the last lines of standard error).  Without a CUDA
card, or with fewer cards than the cell asks for, it exits with code 2 and
prints no result; it exits with code 3 if JAX or the JAX package was loaded.
"""
import time

T_BEGIN = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# build and kernel caches at fixed paths inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda"}
FORBIDDEN = ("jax", "jaxlib", "flax", "polympc_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(ROOT, "build", "port_bench", sub)
    sys.path.insert(0, ROOT)
    import torch
    from port_bench.pb.spec import Cell
    chips = Cell(args.workload, ROOT).chips
    if not torch.cuda.is_available():
        print("port_bench: no CUDA card (torch.cuda.is_available() is "
              "false); the benchmark runs only on the card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    from port_bench.pb.runner import run_cell
    result, lines = run_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace), device="cuda",
                             t_begin=T_BEGIN)
    bad = forbidden_modules()
    if bad:
        print("port_bench: loaded forbidden modules: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    sys.stderr.write("\n".join(lines) + "\n")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
