"""The one general generator: it reads a traffic file and drives the
program's problem with it.

``batch`` (closed loop of one caller): back-to-back batches of
``batch`` lanes, each drawn afresh from the ``--seed`` stream with the
configuration's draw, solved by the program's batch solver and certified
under the configuration's schedule.  A unit is one batch; a lane that does
not certify fails.  The first ``audit_batches`` batches of a window are its
audit batches, and the window ends once ``seconds`` have passed and every
audit batch is done: a run's attempted and failed lanes are theirs alone,
so two programs run on one seed are judged on the same lanes however many
batches each finishes.

``loop`` (a controller in a closed loop): from one fixed start state (the
configuration's draw from a fixed stream, the same for every seed), each
step hands the program the plant's state plus measurement noise drawn from
the ``--seed`` stream (the configuration's ``measurement_noise_sd``), solves
it warm-started from the step before, and applies the first control to the
plant (the reference's float64 model, RK4) for ``dt`` seconds in
``substeps`` steps; the configuration's wrap (a periodic state) is applied
to the state and the warm start.  Every seed so drives the same
trajectory's work, with different inputs.  A unit is one step; a step
fails if it raises, returns a non-finite point, or returns a status other
than SOLVED or MAX_ITER_EXCEEDED.

Set-up warms up exactly the traffic's shapes from a fixed stream, so it is
the same work for every seed.  Records keep what the check compares, on the
host: every loop step, every lane of every batch.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from port_bench.pb.certify import certify
from port_bench.reference._collocation import rk4

WARMUP_SEED = 20261018
LOOP_START_SEED = 31415926


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Spans:
    """Synchronised host spans of a traced run (seconds by name, per unit),
    with a profiler label around each."""

    def __init__(self, on, device):
        self.on, self.device = on, device
        self.current = {}

    @contextlib.contextmanager
    def __call__(self, name):
        if not self.on:
            yield
            return
        from torch.profiler import record_function
        sync(self.device)
        t0 = time.perf_counter()
        with record_function("port_bench." + name):
            yield
        sync(self.device)
        self.current[name] = self.current.get(name, 0.0) + \
            time.perf_counter() - t0

    def take(self):
        out, self.current = self.current, {}
        return out


def _cpu(*ts):
    return [t.detach().to("cpu") for t in ts]


class BatchTraffic:
    kind = "batch"

    def __init__(self, problem, cfgmod, cfg, traffic, device):
        self.p, self.cfgmod, self.cfg, self.t = problem, cfgmod, cfg, traffic
        self.device = device
        self.B = int(traffic["batch"])
        self.audit = int(traffic["audit_batches"])
        self.tol = float(cfg["certify"]["tol"])

    def _unit(self, x0s, spans):
        with spans("solve"):
            sol = self.p.batch_solve(x0s)
        with spans("certify"):
            cert = certify(self.p, self.cfg["certify"]["stages"], x0s, sol)
        sync(self.device)
        return sol, cert

    def setup(self):
        rng = np.random.default_rng(WARMUP_SEED)
        x0 = torch.as_tensor(self.cfgmod.draw(self.cfg, rng, self.B),
                             device=self.device)
        self._unit(x0, Spans(False, self.device))

    def run(self, seed, seconds, spans, profiled):
        """Batches until ``seconds`` have passed and the audit batches are
        done; returns (units, window_s).  ``profiled`` wraps the first
        units of a traced run."""
        rng = np.random.default_rng(seed)
        units = []
        t_start = time.perf_counter()
        while True:
            audit = len(units) < self.audit
            x0s = torch.as_tensor(self.cfgmod.draw(self.cfg, rng, self.B),
                                  device=self.device)
            with profiled(len(units)):
                t0 = time.perf_counter()
                sol, (z, lam, lam_box, r) = self._unit(x0s, spans)
                t1 = time.perf_counter()
            ok = r <= self.tol
            rec = dict(zip(
                ("x0", "x", "lam", "lam_box", "status", "violation",
                 "z", "zlam", "zlam_box", "r"),
                _cpu(x0s, sol.x, sol.lam, sol.lam_box, sol.status,
                     sol.violation, z, lam, lam_box, r)))
            iters, qp_iters = _cpu(sol.iters, sol.qp_iters)
            units.append({
                "wall_s": t1 - t0, "lanes": self.B, "audit": audit,
                "certified": int(ok.sum()), "iters": iters.numpy(),
                "qp_iters": qp_iters.numpy(), "spans": spans.take(),
                "record": rec})
            if len(units) >= self.audit and \
                    time.perf_counter() - t_start >= seconds:
                break
        return units, time.perf_counter() - t_start


class LoopTraffic:
    kind = "loop"

    def __init__(self, problem, cfgmod, cfg, traffic, device, ref):
        self.p, self.cfgmod, self.cfg, self.t = problem, cfgmod, cfg, traffic
        self.device, self.ref = device, ref
        self.nx = ref.nx
        wrap = cfg.get("loop", {}).get("wrap")
        self.wrap = None if not wrap else (int(wrap["state"]),
                                           float(wrap["period"]))
        sx = cfg["problem"].get("x_scale")
        self.sx = np.ones(self.nx) if sx is None else np.asarray(sx)
        self.noise_sd = np.asarray(cfg["loop"]["measurement_noise_sd"])
        from polympc_torch.utils import status as st
        self.solved = int(st.SOLVED)
        self.ok_status = (self.solved, int(st.MAX_ITER_EXCEEDED))

    def _plant(self, x, zrow):
        """The state after one control period (float64, CPU), from the
        first control of the step's solution."""
        _, U = self.ref.physical(zrow.to(torch.float64)[None])
        return rk4(self.ref.model.dynamics, x, U[0, 0], float(self.t["dt"]),
                   int(self.t["substeps"]))

    def _wrap(self, x, warm):
        if self.wrap is None:
            return x, warm
        i, period = self.wrap
        s = float(x[i])
        shift = -period if s >= period else (period if s < 0.0 else 0.0)
        if not shift:
            return x, warm
        x = x.clone()
        x[i] += shift
        z = warm[0].clone()
        N = self.ref.N
        z[:, i:N * self.nx:self.nx] += shift / self.sx[i]
        return x, (z, warm[1], warm[2])

    def _steps(self, seed, count, seconds, spans, profiled):
        x = torch.as_tensor(self.cfgmod.draw(
            self.cfg, np.random.default_rng(LOOP_START_SEED), 1)[0],
            dtype=torch.float64)
        rng = np.random.default_rng(seed)
        units, warm = [], None
        t_start = time.perf_counter()
        while True:
            seen = x + torch.as_tensor(rng.normal(0.0, 1.0, self.nx)
                                       * self.noise_sd)
            x0 = torch.as_tensor(seen, dtype=torch.float32,
                                 device=self.device)[None]
            failed, sol = False, None
            with profiled(len(units)):
                t0 = time.perf_counter()
                try:
                    with spans("solve"):
                        sol = (self.p.loop_first(x0) if warm is None
                               else self.p.loop_next(x0, *warm))
                    sync(self.device)
                except (RuntimeError, ValueError):
                    failed = True
                t1 = time.perf_counter()
            rec = None
            if sol is not None:
                xs, lam, lam_box, status, viol, cost, iters = _cpu(
                    sol.x, sol.lam, sol.lam_box, sol.status, sol.violation,
                    sol.cost, sol.iters)
                failed = (int(status[0]) not in self.ok_status
                          or not bool(torch.isfinite(xs).all()))
                rec = {"x0": x0.to("cpu"), "x": xs, "lam": lam,
                       "lam_box": lam_box, "status": status,
                       "violation": viol, "cost": cost,
                       "solved": status == self.solved}
            units.append({"wall_s": t1 - t0, "failed": failed,
                          "iters": None if sol is None else iters.numpy(),
                          "spans": spans.take(), "record": rec})
            if not failed:
                x = self._plant(x, xs[0])
                warm = (sol.x, sol.lam, sol.lam_box)
                x, warm = self._wrap(x, warm)
            if (count is not None and len(units) >= count) or (
                    seconds is not None
                    and time.perf_counter() - t_start >= seconds):
                break
        return units, time.perf_counter() - t_start

    def setup(self):
        off = lambda i: contextlib.nullcontext()
        self._steps(WARMUP_SEED, int(self.t["warmup_steps"]), None,
                    Spans(False, self.device), off)

    def run(self, seed, seconds, spans, profiled):
        return self._steps(seed, None, seconds, spans, profiled)
