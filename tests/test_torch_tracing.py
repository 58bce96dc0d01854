"""The port's in-program spans and counters (polympc_torch.utils.timing):
off, they record nothing and cost one flag check; on, the SQP, QP and
certify spans nest as the solve runs, the sync counter counts the host's
blocking reads, nothing the solve computes changes, and the spans sit on
``torch.profiler``'s host clock.  And the benchmark's reduction of a
recording (port_bench/pb/program_spans.py) into its per-layer shares."""
import importlib.util
from pathlib import Path

import pytest
import torch

from polympc_torch import headline
from polympc_torch.nlp import sqp_solve
from polympc_torch.utils import timing as tm
from port_bench.pb import program_spans

from _torch_parity import single_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with the recorder off and empty."""
    tm.start_recording()
    tm.stop_recording()
    yield
    tm.start_recording()
    tm.stop_recording()


@pytest.fixture(scope="module")
def kite():
    """bench.py's kite at B=2 in float32 on the CPU, started as the batch
    solver starts it (x0 pinned, the initial guess elsewhere)."""
    from polympc_torch.parallel import pin_initial_state
    tr, bounds, prm, settings = headline.kite_problem("cpu", torch.float32)
    x0s = torch.as_tensor(headline.bench_x0s(2, seed=3))
    bnd, x0sc = pin_initial_state(tr, bounds, x0s)
    z0 = tr.initial_guess(dtype=torch.float32, device="cpu")[None].repeat(
        2, 1)
    z0[:, :tr.ocp.nx] = x0sc

    def solve():
        return sqp_solve(tr.nlp, z0, p=prm, bounds=bnd, settings=settings)
    return solve


def _children_within_parents(spans):
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.parent is None:
            assert s.root == s.id
            continue
        up = by_id[s.parent]
        assert s.root == up.root
        assert up.start_ns <= s.start_ns <= s.end_ns <= up.end_ns


def test_off_span_is_the_shared_no_op_and_a_solve_records_nothing(kite):
    a, b = tm.span("sqp.iter"), tm.span("qp.epoch", lanes=3)
    assert a is b
    with a as inner:
        inner.set(lanes=1)
    tm.count("sync")
    kite()
    rec = tm.recorded()
    assert rec.spans == [] and rec.counts == {} and rec.root_counts == {}


def test_on_spans_nest_and_count_the_syncs(kite):
    tm.start_recording()
    sol = kite()
    tm.stop_recording()
    rec = tm.recorded()
    roots = [s for s in rec.spans if s.parent is None]
    assert [r.name for r in roots] == ["sqp.solve"]
    root = roots[0]
    assert root.attrs == {"B": 2, "n": 77, "m": 55, "profiled": False}
    _children_within_parents(rec.spans)
    assert {s.root for s in rec.spans} == {root.id}
    names = [s.name for s in rec.spans]
    # one sqp.iter a pass of the loop, the last finding no lane; each
    # pass gathers the lanes still running
    its = sorted((s for s in rec.spans if s.name == "sqp.iter"),
                 key=lambda s: s.start_ns)
    iters = sol.iters.tolist()
    assert len(its) == max(iters) + 1
    assert [s.attrs["lanes"] for s in its] == [
        sum(i > k for i in iters) for k in range(len(its))]
    for name in ("sqp.hessian", "sqp.regularize", "qp.solve",
                 "sqp.line_search"):
        assert names.count(name) == len(its) - 1, name
    # the first evaluation at x0 and one a pass
    assert names.count("sqp.derivatives") == len(its)
    epochs = names.count("qp.epoch")
    assert names.count("qp.kernel") == epochs - names.count("qp.solve")
    assert names.count("qp.kkt") == names.count("qp.check") == \
        names.count("qp.kernel")
    assert names.count("sqp.gather") == len(its)
    assert names.count("qp.gather") == epochs
    # a blocking read at every pass's and every epoch's lane gather
    assert rec.counts == {"sync": len(its) + epochs}
    assert names.count("sync") == len(its) + epochs
    assert rec.root_counts == {root.id: {"sync": len(its) + epochs}}


def test_the_batch_solver_and_the_certify_are_roots():
    tr, bounds, prm, settings = headline.kite_problem("cpu", torch.float32)
    from polympc_torch.parallel import make_batch_solver
    solve = make_batch_solver(tr, bounds, prm, settings, rollout_guess=True)
    x0s = torch.as_tensor(headline.bench_x0s(2, seed=4))
    prm64 = tr.params(d=[0.05], t0=0.0, tf=2.0, dtype=torch.float64,
                      device="cpu")
    b64 = bounds._replace(**{f: getattr(bounds, f).to(torch.float64)
                             for f in bounds._fields})
    tm.start_recording()
    sol = solve(x0s)
    headline.certify(tr, x0s, sol, b64, prm64)
    tm.stop_recording()
    rec = tm.recorded()
    roots = [s for s in rec.spans if s.parent is None]
    # the certify pins x0 in its bounds outside any refine.solve: the
    # copy of the state scale is a sync root of its own
    assert [r.name for r in roots] == ["batch.solve", "sync"] + [
        "refine.solve"] * 3
    assert roots[0].attrs == {"B": 2, "profiled": False}
    assert [r.attrs["iters"] for r in roots[2:]] == [2, 2, 10]
    _children_within_parents(rec.spans)
    by_id = {s.id: s for s in rec.spans}
    for s in rec.spans:
        if s.name in ("batch.start", "sqp.solve"):
            assert by_id[s.parent].name == "batch.solve"
        if s.name == "refine.kkt_solve":
            assert by_id[s.parent].name == "refine.step"
    names = [s.name for s in rec.spans]
    assert names.count("refine.step") == 2 + 2 + 10
    # per step the Hessian and the new point's derivatives, and the start
    assert names.count("refine.derivatives") == 2 * 14 + 3
    # the SQP's passes and epochs, and the copies of the state scale and
    # the time grid in the start (x0's pin, the rollout's grid and pack)
    assert rec.root_counts[roots[0].id]["sync"] == names.count("sync") - 1 \
        == rec.counts["sync"] - 1 == names.count("sqp.gather") + \
        names.count("qp.gather") + 4
    assert rec.root_counts[roots[1].id] == {"sync": 1}


def test_the_recorder_changes_no_result(kite):
    off = kite()
    tm.start_recording()
    on = kite()
    tm.stop_recording()
    assert len(tm.recorded().spans) > 0
    for field, a, b in zip(off._fields, off, on):
        if a is None:
            assert b is None
            continue
        assert a.dtype == b.dtype and torch.equal(a, b), field


def _labels(prof):
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("polympc."):
            out.setdefault(e.name()[len("polympc."):], []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    return {k: sorted(v) for k, v in out.items()}


def test_spans_bracket_their_profiler_labels_on_one_clock(kite):
    """Each span's start is read just before its label opens and its end
    just after it closes, on the clock the profiler stamps: every span
    brackets its label (to the profiler's 2 us of clock conversion), and
    at each end within 50 us, but for the few labels that wait on the
    profiler's own buffer growth or on a preempted thread (one in about
    200 read 70-320 us late on a loaded CPU): 95% of them and the
    median."""
    from torch.profiler import ProfilerActivity, profile
    kite()  # the profiler's and the solve's first-call costs
    tm.start_recording()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        kite()
    tm.stop_recording()
    rec = tm.recorded()
    labels = _labels(prof)
    spans = {}
    for s in rec.spans:
        spans.setdefault(s.name, []).append((s.start_ns, s.end_ns))
    assert set(labels) == set(spans)
    lags = []
    for name, got in spans.items():
        assert len(got) == len(labels[name]), name
        for (s0, s1), (l0, l1) in zip(sorted(got), labels[name]):
            assert l0 - s0 >= -2_000 and s1 - l1 >= -2_000, name
            lags.append((l0 - s0, s1 - l1))
    for end in (0, 1):
        ns = sorted(lag[end] for lag in lags)
        assert ns[len(ns) // 2] <= 50_000
        assert ns[int(0.95 * len(ns))] <= 50_000, ns[-10:]
    root = [s for s in rec.spans if s.parent is None]
    assert len(root) == 1 and root[0].attrs["profiled"] is True


def test_counts_and_nesting_of_the_recorder_api():
    tm.count("sync")
    assert tm.recorded().counts == {}
    tm.start_recording()
    tm.count("sync", 2)
    with tm.span("a", B=4) as a:
        a.set(lanes=3)
        with tm.span("b"):
            tm.count("sync")
    with tm.span("c"):
        tm.count("sync", 5)
    tm.stop_recording()
    with tm.span("d"):
        tm.count("sync")
    rec = tm.recorded()
    assert [s.name for s in rec.spans] == ["b", "a", "c"]
    b, a, c = rec.spans
    assert a.attrs == {"B": 4, "lanes": 3, "profiled": False}
    assert (b.parent, b.root) == (a.id, a.id) and c.root == c.id
    assert rec.counts == {"sync": 8}
    assert rec.root_counts == {None: {"sync": 2}, a.id: {"sync": 1},
                               c.id: {"sync": 5}}
    tm.start_recording()
    assert tm.recorded() == tm.Recording([], {}, {})


def _rec(*spans, counts=None):
    """A hand-made recording: spans (id, parent, root, name, start s,
    end s, profiled)."""
    out = [tm.SpanRecord(i, p, r, n, int(a * 1e9), int(b * 1e9),
                         {} if p is not None else {"profiled": prof})
           for i, p, r, n, a, b, prof in spans]
    total = {}
    for per in (counts or {}).values():
        for k, v in per.items():
            total[k] = total.get(k, 0) + v
    return tm.Recording(out, total, counts or {})


# two batches of a kite-like cell, the first under the profiler: a root
# batch.solve and its certify's refine.solve root each
BATCHES = _rec(
    (0, None, 0, "batch.solve", 0.0, 10.0, True),
    (1, 0, 0, "sqp.hessian", 1.0, 3.0, None),
    (2, None, 2, "refine.solve", 10.0, 14.0, True),
    (3, None, 3, "batch.solve", 20.0, 26.0, False),
    (4, 3, 3, "sqp.hessian", 20.5, 21.0, None),
    (5, 3, 3, "sqp.derivatives", 21.0, 22.0, None),
    (6, 3, 3, "qp.solve", 22.0, 24.5, None),
    (7, 6, 3, "sync", 23.0, 23.5, None),
    (8, 3, 3, "sync", 25.0, 25.25, None),
    (9, None, 9, "refine.solve", 26.0, 28.0, False),
    (10, 9, 9, "refine.derivatives", 26.0, 26.5, None),
    (11, None, 11, "refine.solve", 28.0, 30.0, False),
    (12, 11, 11, "refine.derivatives", 28.0, 29.0, None),
    (13, None, 13, "sync", 25.9, 26.0, False),
    counts={0: {"sync": 40}, 3: {"sync": 30}, 9: {"sync": 1},
            13: {"sync": 1}, None: {"sync": 7}})


def test_reduce_keeps_the_roots_no_profiler_saw():
    roots = program_spans.reduce(BATCHES)
    assert [r["name"] for r in roots] == ["batch.solve", "refine.solve",
                                          "refine.solve", "sync"]
    assert roots[0]["wall_s"] == pytest.approx(6.0)
    assert roots[0]["spans"] == pytest.approx({
        "batch.solve": 6.0, "sqp.hessian": 0.5, "sqp.derivatives": 1.0,
        "qp.solve": 2.5, "sync": 0.75})
    assert [r["counts"] for r in roots] == [{"sync": 30}, {"sync": 1}, {},
                                            {"sync": 1}]
    assert program_spans.reduce(tm.Recording([], {}, {})) is None


# the readers' values on BATCHES: the unprofiled roots' wall is
# 6 + 2 + 2 = 10 s in the batch cell, 6 s in the loop cell; the syncs of a
# batch are its solve's, its certify's and the certify glue's (root 13)
EXPECTED = {
    "derivatives_share.batch": 100 * (0.5 + 1.0 + 0.5 + 1.0) / 10,
    "qp_share.batch": 100 * 2.5 / 10,
    "refine_share.batch": 100 * 4.0 / 10,
    "sync_wait_share.batch": 100 * 0.75 / 10,
    "syncs_per_solve.batch": 32.0,
    "derivatives_share.loop": 100 * 1.5 / 6,
    "qp_share.loop": 100 * 2.5 / 6,
    "sync_wait_share.loop": 100 * 0.75 / 6,
    "syncs_per_solve.loop": 30.0,
}


def _reader(name):
    path = ROOT / "port_bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "test_reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_each_reader_gives_the_share_its_table_defines(name, monkeypatch):
    roots = program_spans.reduce(BATCHES)
    monkeypatch.setattr(program_spans, "start", lambda: None)
    monkeypatch.setattr(program_spans, "reduce", lambda: roots)
    mod = _reader(name)
    assert mod.read(None) == pytest.approx(EXPECTED[name])


def test_readers_read_nothing_from_a_program_without_the_recorder(
        monkeypatch):
    monkeypatch.setattr(program_spans, "_timing", lambda: None)
    monkeypatch.setattr(program_spans, "_started", False)
    program_spans.start()
    assert program_spans._started is False
    assert program_spans.reduce() is None
    for name in EXPECTED:
        assert _reader(name).read(None) is None
