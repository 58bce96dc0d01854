"""Timing hooks of a traced run around named functions of the program.

A hook replaces ``module.attr`` for the run with a wrapper that records a
CUDA event pair around each call (on the CPU, the host clock) together with
what the metric's ``describe(arguments, cfg)`` says of that call, and puts
the original back afterwards.  A target that is gone, or no longer takes
the arguments ``describe`` reads, makes the hook empty: its metric then
reads nothing, and the run goes on."""
from __future__ import annotations

import importlib
import inspect
import time

import torch


class Hook:
    def __init__(self, target: str, describe, cfg, device):
        self.module_name, self.attr = target.split(":")
        self.describe, self.cfg = describe, cfg
        self.cuda = torch.device(device).type == "cuda"
        self.calls = []
        self.missing = False
        self._module = self._orig = None

    def install(self):
        try:
            module = importlib.import_module(self.module_name)
        except ImportError:
            self.missing = True
            return
        orig = getattr(module, self.attr, None)
        if not callable(orig):
            self.missing = True
            return
        sig = inspect.signature(orig)
        hook = self

        def wrapper(*args, **kwargs):
            if hook.missing:
                return orig(*args, **kwargs)
            try:
                bound = sig.bind(*args, **kwargs)
                bound.apply_defaults()
                desc = hook.describe(bound.arguments, hook.cfg)
            except (TypeError, KeyError, AttributeError, IndexError):
                # the target no longer takes what the metric reads
                hook.missing = True
                return orig(*args, **kwargs)
            if hook.cuda:
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                out = orig(*args, **kwargs)
                e.record()
                hook.calls.append((s, e, desc))
            else:
                t0 = time.perf_counter()
                out = orig(*args, **kwargs)
                hook.calls.append((t0, time.perf_counter(), desc))
            return out

        self._module, self._orig = module, orig
        setattr(module, self.attr, wrapper)

    def remove(self):
        if self._module is not None:
            setattr(self._module, self.attr, self._orig)
            self._module = None

    def results(self):
        """[(seconds, description)] of every call, or None if the target is
        gone."""
        if self.missing:
            return None
        if self.cuda:
            torch.cuda.synchronize()
            return [(s.elapsed_time(e) / 1e3, d) for s, e, d in self.calls]
        return [(b - a, d) for a, b, d in self.calls]
