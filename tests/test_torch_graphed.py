"""The cache policy of polympc_torch.nlp.graphed on the CPU, with a stub in
place of the CUDA capture: CPU inputs stay eager; a key's first call runs
eager, its second captures, later ones replay; the key separates shapes,
dtypes, baked scalars and the matmul precision; the LRU cap evicts; a
capture that raises leaves its key eager for good; the three counters
count; a replay honours a changed parameter and leaves an answer held
from before intact.  The stub keeps the graph's contract: static input
buffers, and outputs that every replay overwrites in place.  The card's
own capture is held to eager bit for bit in tests/test_torch_cuda.py."""
import pytest
import torch

from polympc_torch import headline
from polympc_torch.nlp import graphed
from polympc_torch.nlp.sqp import (constraints_fn, derivative_fns,
                                   exact_hessian_fn)
from polympc_torch.utils import timing as tm

from _torch_parity import single_thread  # noqa: F401


def _flat(out):
    return (out,) if isinstance(out, torch.Tensor) else tuple(out)


class Stub:
    """Stands in for the capture: records each capture and replays by
    calling the function again on the static inputs, writing into the
    outputs it returned at capture."""

    def __init__(self):
        self.captured = []
        self.raising = set()

    def __call__(self, fn, inputs):
        self.captured.append(fn)
        if fn in self.raising:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        outputs = fn(*inputs)

        def replay():
            for o, n in zip(_flat(outputs), _flat(fn(*inputs))):
                o.copy_(n)
        return replay, outputs


@pytest.fixture(autouse=True)
def fresh():
    """Every test starts and ends with an empty cache and the recorder
    off and empty."""
    graphed.clear()
    tm.start_recording()
    tm.stop_recording()
    yield
    graphed.clear()
    tm.start_recording()
    tm.stop_recording()


@pytest.fixture
def stub(monkeypatch):
    """CPU tensors taken for a card's, and the stub for the capture."""
    s = Stub()
    monkeypatch.setattr(graphed, "_on_card", lambda t: True)
    monkeypatch.setattr(graphed, "_ALIGN", 1)
    monkeypatch.setattr(graphed, "_record", s)
    return s


def _affine(x, p, scale):
    return (x * p["a"] + scale, x.sum(dim=1))


def _counts():
    return tm.recorded().counts


def test_cpu_inputs_stay_eager_and_uncounted():
    x = torch.ones(3, 2)
    p = {"a": torch.tensor(2.0)}
    tm.start_recording()
    for _ in range(3):
        out = graphed.call(_affine, x, p, 1.0)
    tm.stop_recording()
    assert torch.equal(out[0], x * 2 + 1)
    assert not graphed._keys and _counts() == {}


def test_first_sight_eager_second_captures_later_replay(stub):
    x = torch.arange(6.0).reshape(3, 2)
    p = {"a": torch.tensor(3.0)}
    want = _affine(x, p, 0.5)
    tm.start_recording()
    outs = [graphed.call(_affine, x, p, 0.5) for _ in range(4)]
    tm.stop_recording()
    assert stub.captured == [_affine]
    assert _counts() == {"derivatives.eager": 1, "derivatives.capture": 1,
                         "derivatives.replay": 2}
    for out in outs:
        assert all(torch.equal(a, b) for a, b in zip(out, want))


@pytest.mark.parametrize("other", [
    lambda x, p, s: (x[:2], p, s),                        # shape
    lambda x, p, s: (x.double(), p, s),                   # dtype
    lambda x, p, s: (x, {"a": p["a"].double()}, s),       # p's dtype
    lambda x, p, s: (x, {"a": p["a"][None]}, s),          # p's shape
    lambda x, p, s: (x, p, s + 1.0),                      # a baked scalar
], ids=["shape", "dtype", "param_dtype", "param_shape", "scalar"])
def test_the_key_separates(stub, other):
    x, p, s = torch.ones(3, 2), {"a": torch.tensor(2.0)}, 1.0
    graphed.call(_affine, x, p, s)
    graphed.call(_affine, x, p, s)
    assert stub.captured == [_affine]
    y, q, t = other(x, p, s)
    graphed.call(_affine, y, q, t)
    assert stub.captured == [_affine]        # a first sight: eager
    out = graphed.call(_affine, y, q, t)
    assert stub.captured == [_affine, _affine]
    assert all(torch.equal(a, b) for a, b in zip(out, _affine(y, q, t)))
    assert len(graphed._keys) == 2


def test_the_key_separates_the_matmul_precision(stub):
    x, p = torch.ones(3, 2), {"a": torch.tensor(2.0)}
    saved = torch.get_float32_matmul_precision()
    try:
        for prec in ("highest", "high"):
            torch.set_float32_matmul_precision(prec)
            graphed.call(_affine, x, p, 1.0)
            graphed.call(_affine, x, p, 1.0)
    finally:
        torch.set_float32_matmul_precision(saved)
    assert len(stub.captured) == 2 and len(graphed._keys) == 2


def test_the_lru_cap_evicts(stub, monkeypatch):
    monkeypatch.setattr(graphed, "MAX_GRAPHS", 2)
    p = {"a": torch.tensor(2.0)}
    xs = [torch.ones(b, 2) for b in (1, 2, 3)]
    for x in xs:
        graphed.call(_affine, x, p, 1.0)
        graphed.call(_affine, x, p, 1.0)
    graphed.call(_affine, xs[1], p, 1.0)     # B=2 the most recent
    assert len(stub.captured) == 3
    held = [k[1][0][0][0] for k, v in graphed._keys.items()
            if v is not graphed._SEEN]
    assert held == [3, 2]                    # B=1 evicted
    tm.start_recording()
    graphed.call(_affine, xs[0], p, 1.0)     # seen afresh: eager
    graphed.call(_affine, xs[0], p, 1.0)     # captured again, evicts B=3
    tm.stop_recording()
    assert _counts() == {"derivatives.eager": 1, "derivatives.capture": 1}
    held = [k[1][0][0][0] for k, v in graphed._keys.items()
            if v is not graphed._SEEN]
    assert held == [2, 1]


def test_the_key_count_is_capped(stub, monkeypatch):
    monkeypatch.setattr(graphed, "MAX_KEYS", 3)
    p = {"a": torch.tensor(2.0)}
    for b in range(1, 6):
        graphed.call(_affine, torch.ones(b, 2), p, 1.0)
    assert [k[1][0][0][0] for k in graphed._keys] == [3, 4, 5]
    assert stub.captured == []


def test_a_capture_that_raises_is_eager_for_good(stub):
    stub.raising.add(_affine)
    x, p = torch.ones(3, 2), {"a": torch.tensor(2.0)}
    tm.start_recording()
    outs = [graphed.call(_affine, x, p, 1.0) for _ in range(4)]
    tm.stop_recording()
    assert stub.captured == [_affine]        # never retried
    assert _counts() == {"derivatives.eager": 4}
    assert all(torch.equal(o[0], x * 2 + 1) for o in outs)


@pytest.mark.parametrize("why", ["grad", "view", "subclass"])
def test_inputs_a_graph_cannot_hold_run_eager_counted(stub, why):
    x, p = torch.ones(3, 4), {"a": torch.tensor(2.0)}
    if why == "grad":
        x.requires_grad_(True)
    elif why == "view":
        x = x[:, ::2]
    else:
        x = torch.nn.Parameter(x, requires_grad=False)
    tm.start_recording()
    for _ in range(3):
        graphed.call(_affine, x, p, 1.0)
    tm.stop_recording()
    assert stub.captured == [] and not graphed._keys
    assert _counts() == {"derivatives.eager": 3}


def test_a_replay_follows_the_parameter_and_keeps_held_answers(stub):
    x = torch.arange(6.0).reshape(3, 2)
    p = {"a": torch.tensor(2.0)}
    graphed.call(_affine, x, p, 0.0)
    graphed.call(_affine, x, p, 0.0)         # captured with a = 2
    first = graphed.call(_affine, x, p, 0.0)
    kept = first[0].clone()
    p["a"] = torch.tensor(5.0)
    second = graphed.call(_affine, x + 1, p, 0.0)
    assert torch.equal(second[0], (x + 1) * 5)
    assert torch.equal(first[0], kept)       # not aliased to the buffers


def test_the_solvers_entry_points_go_through_the_cache(stub):
    """The kite's grad, constraints, Jacobian and Lagrangian Hessian, in
    float32 and float64, replay what eager computes (with the stub,
    replaying is calling again on the static inputs)."""
    tr, _, _, _ = headline.kite_problem("cpu", torch.float32)
    nlp = tr.nlp
    for dt in (torch.float32, torch.float64):
        prm = tr.params(d=[0.05], t0=0.0, tf=2.0, dtype=dt, device="cpu")
        gen = torch.Generator().manual_seed(0)
        x = 0.1 * torch.randn(3, nlp.n, generator=gen, dtype=dt)
        lam = torch.randn(3, nlp.m, generator=gen, dtype=dt)
        g_fn, j_fn = derivative_fns(nlp, prm)
        c_fn, h_fn = constraints_fn(nlp, prm), exact_hessian_fn(nlp, prm)
        assert nlp.ineq is None
        want = (nlp.cost_grad(x, prm), nlp.eq(x, prm), nlp.eq_jac(x, prm),
                nlp.lag_hessian(x, lam, prm))
        for _ in range(3):
            got = (g_fn(x), c_fn(x), j_fn(x), h_fn(x, lam))
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert len(stub.captured) == 8
