"""The plain reference against the mathematics and against the program at
small sizes on the CPU, and the check's numbers on a sound and a perturbed
solve."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from port_bench.pb import check
from port_bench.reference import _collocation as col

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture(autouse=True, scope="module")
def single_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(name):
    return json.loads((ROOT / "port_bench" / "configs" /
                       f"{name}.json").read_text())


@pytest.mark.parametrize("order", [3, 5, 8])
def test_cgl_operators_are_exact_on_polynomials(order):
    x, D = col.cgl_diff(order)
    w = col.clenshaw_curtis(order)
    assert np.all(np.diff(x) > 0) and x[0] == -1.0 and x[-1] == 1.0
    for k in range(order + 1):
        assert np.allclose(D @ x ** k, k * x ** max(k - 1, 0) * (k > 0),
                           atol=1e-11)
    for k in range(0, order + 1, 2):
        assert w @ x ** k == pytest.approx(2.0 / (k + 1), abs=1e-13)


def test_composite_keeps_the_left_row_at_a_shared_node():
    Dg, wg = col.composite(2, 2)
    _, D = col.cgl_diff(2)
    assert np.array_equal(Dg[:3, :3], D)
    assert np.array_equal(Dg[3:, 2:], D[1:])
    assert wg.sum() == pytest.approx(4.0)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    t = torch.tensor([1.0 + 2 ** -11 + 2 ** -13, 1.0 + 2 ** -10 + 2 ** -12,
                      -3.0], dtype=torch.float32)
    r = col.round_tf32(t)
    assert r.tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, -3.0]
    x = torch.randn(10000, generator=torch.Generator().manual_seed(0)) * 50
    r = col.round_tf32(x)
    assert torch.all(torch.abs(r - x) <= 2 ** -11 * torch.abs(x))
    assert not torch.any(r.view(torch.int32) & 0x1FFF)


def _program(name):
    """The program's problem on the CPU in float64, and x0s of two lanes."""
    import importlib.util
    path = ROOT / "port_bench" / "configs" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"cfg_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cfg = _cfg(name)
    x0 = torch.as_tensor(mod.draw(cfg, np.random.default_rng(5), 2),
                         dtype=torch.float64)
    return mod, cfg, x0


@pytest.mark.parametrize("name", ["kite_nmpf", "race_car"])
def test_reference_nlp_equals_the_programs(name):
    from polympc_torch.parallel import pin_initial_state
    mod, cfg, x0 = _program(name)
    from port_bench.reference import kite_nmpf, race_car
    ref = {"kite_nmpf": kite_nmpf, "race_car": race_car}[name].nlp(cfg)
    p = mod.build(cfg, "cpu")
    nlp, prm = p.tr.nlp, p.prm64
    bnd, _ = pin_initial_state(p.tr, p.bounds64, x0)
    z = p.tr.rollout_guess(x0, prm) + 0.01 * torch.randn(
        2, nlp.n, dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    lam = torch.randn(2, nlp.m, dtype=torch.float64)
    lb = torch.randn(2, nlp.n, dtype=torch.float64)
    g, c, J = ref.evaluate(z)
    assert torch.allclose(c, nlp.eq(z, prm), rtol=1e-12, atol=1e-12)
    assert torch.allclose(g, nlp.cost_grad(z, prm), rtol=1e-11, atol=1e-12)
    assert torch.allclose(J, nlp.eq_jac(z, prm), rtol=1e-11, atol=1e-12)
    assert torch.allclose(ref.costs(z), nlp.cost(z, prm), rtol=1e-12)
    lo, up = check.scaled_box(ref, cfg)
    lo, up = ref.pinned_bounds(lo, up, x0)
    assert torch.allclose(lo, bnd.lbx) and torch.allclose(up, bnd.ubx)
    from polympc_torch.nlp import kkt_residual
    mine = col.stopping_parts(ref, z, lam, lb, lo, up)["kkt"]
    theirs = kkt_residual(nlp, z, lam, lb, bnd, prm).max
    assert torch.allclose(mine, theirs, rtol=1e-11)


def test_check_passes_a_converged_solve_and_flags_a_perturbed_one():
    """A kite batch of 4 solved and certified on the CPU by the harness's
    own path: every number under its limit; then one certified lane's
    point moved by 1e-4: the certified residual no longer holds."""
    from port_bench.pb.runner import compared, prepare
    from port_bench.pb.spec import Cell
    cell = Cell("kite_b4096", ROOT)
    traffic, refnlp, drv = prepare(cell, "cpu", {"batch": 4,
                                                  "audit_batches": 1})
    from port_bench.pb.traffic import Spans
    import contextlib
    units, _ = drv.run(7, 0.0, Spans(False, "cpu"),
                       lambda i: contextlib.nullcontext())
    limits = cell.limits()
    good = compared(cell, traffic, units, refnlp, 7, "cpu")
    assert check.judge(good, limits, None)[0]
    rec = units[0]["record"]
    lane = int(torch.nonzero(rec["r"] <= 1e-6)[0])
    rec["z"][lane, 7] += 1e-4
    bad = compared(cell, traffic, units, refnlp, 7, "cpu")
    assert bad["cert_kkt_max"] > 1e-6 and bad["kkt_gap_rel"] > 0.5
    assert not check.judge(bad, limits, None)[0]
