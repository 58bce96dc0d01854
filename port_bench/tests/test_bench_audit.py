"""A batch cell's audit batches: the first ``audit_batches`` batches of
every window, drawn from the seed like every batch, are the lanes a run's
``attempted`` and ``failed`` count, so two programs run on one seed are
judged on the same lanes however many batches each finishes.  The later
batches are held to the audit batches' failure share by the check's
``later_fail_excess``, and ``certified_solves_per_s`` counts them all.

The runs drive the kite cell on the CPU at B=4 with two audit batches.  A
fault is planted in the program's certify of one window batch: its Newton
refinement takes no step, so its lanes keep the SQP's float32 point, whose
residual is above the certificate's tolerance."""
import contextlib

import numpy as np
import pytest
import torch

import polympc_torch.parallel.batch as batch_mod
import port_bench.pb.certify as certify_mod
import port_bench.pb.traffic as traffic_mod
from port_bench.pb.runner import prepare, run_cell
from port_bench.pb.spec import Cell

CELL = "kite_b4096"
B, AUDIT = 4, 2
OVERRIDES = {"batch": B, "sample_lanes": B, "audit_batches": AUDIT}
SEED = 2 ** 31 + 23


@pytest.fixture(autouse=True, scope="module")
def single_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _window(seconds, monkeypatch, fault_in=None):
    """run_cell's result and the window's units; ``fault_in`` is the index
    of the window batch whose refinement takes no step."""
    units, solves = [], [0]
    real_run, real_sqp = traffic_mod.BatchTraffic.run, batch_mod.sqp_solve
    real_refine = certify_mod.refine_solution

    def run(self, *args):
        out = real_run(self, *args)
        units.extend(out[0])
        return out

    def sqp(*args, **kwargs):
        solves[0] += 1
        return real_sqp(*args, **kwargs)

    def refine(*args, **kwargs):
        # the first solve is set-up's warm-up, the second window batch 0
        if fault_in is not None and solves[0] - 2 == fault_in:
            kwargs["iters"] = 0
        return real_refine(*args, **kwargs)

    monkeypatch.setattr(traffic_mod.BatchTraffic, "run", run)
    monkeypatch.setattr(batch_mod, "sqp_solve", sqp)
    monkeypatch.setattr(certify_mod, "refine_solution", refine)
    result, _ = run_cell(CELL, SEED, seconds, False, device="cpu",
                         traffic_overrides=OVERRIDES)
    return result, units


@pytest.fixture(scope="module")
def sound():
    """The sound program's audit-only window (``seconds`` 0) and a window
    twice as long as its audit batches took."""
    with pytest.MonkeyPatch.context() as mp:
        short = _window(0.0, mp)
    seconds = 2.0 * sum(u["wall_s"] for u in short[1])
    with pytest.MonkeyPatch.context() as mp:
        long = _window(seconds, mp)
    assert len(long[1]) > AUDIT, "the longer window held no later batch"
    return {"short": short, "long": long, "seconds": seconds}


def test_a_seed_draws_the_same_audit_batches_in_every_window(monkeypatch):
    cell = Cell(CELL)
    _, _, drv = prepare(cell, "cpu", OVERRIDES)
    x0 = torch.as_tensor(cell.loader().draw(
        cell.cfg, np.random.default_rng(traffic_mod.WARMUP_SEED), B))
    sol, cert = drv._unit(x0, traffic_mod.Spans(False, "cpu"))
    monkeypatch.setattr(drv, "_unit", lambda x0s, spans: (sol, cert))
    off = lambda i: contextlib.nullcontext()
    runs = [drv.run(seed, seconds, traffic_mod.Spans(False, "cpu"), off)[0]
            for seed, seconds in ((SEED, 0.0), (SEED, 0.05),
                                  (SEED + 1, 0.0))]
    assert [len(units) for units in runs[::2]] == [AUDIT, AUDIT]
    assert len(runs[1]) > AUDIT
    for units in runs:
        assert [u["audit"] for u in units] == \
            [True] * AUDIT + [False] * (len(units) - AUDIT)
    short, long, other = ([u["record"]["x0"] for u in units]
                          for units in runs)
    for i in range(AUDIT):
        assert torch.equal(short[i], long[i])
        assert not torch.equal(short[i], other[i])


@pytest.mark.parametrize("window", ["short", "long"])
def test_attempted_counts_the_audit_lanes_alone(sound, window):
    result, units = sound[window]
    assert result["correct"]
    assert result["attempted"] == AUDIT * B
    audit = [u for u in units if u["audit"]]
    assert len(audit) == AUDIT
    assert result["failed"] == AUDIT * B - sum(u["certified"] for u in audit)
    assert result["failed"] == sound["short"][0]["failed"]


def test_a_fault_in_an_audit_batch_raises_failed(sound, monkeypatch):
    result, units = _window(0.0, monkeypatch, fault_in=1)
    assert result["attempted"] == AUDIT * B
    assert units[1]["certified"] < sound["short"][1][1]["certified"]
    assert result["failed"] > sound["short"][0]["failed"]


def test_a_fault_in_a_later_batch_leaves_failed_and_fails_the_check(
        sound, monkeypatch):
    result, units = _window(sound["seconds"], monkeypatch, fault_in=AUDIT)
    assert len(units) > AUDIT
    assert result["attempted"] == AUDIT * B
    assert result["failed"] == sound["short"][0]["failed"]
    assert units[AUDIT]["certified"] < sound["long"][1][AUDIT]["certified"]
    excess = result["checks"]["later_fail_excess"]
    assert excess["value"] > excess["limit"]
    assert not result["correct"]
