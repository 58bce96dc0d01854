"""Package-level checks of the PyTorch port (polympc_torch):

  * no file of the port, and not chip_smoke.py, trace_port.py,
    kernel_ab.py or ldlt_solve_orders.py, imports JAX or the JAX package
    (an AST scan): the card's machine has no JAX;
  * the committed JAX reference of the certified kite batch loads, and its
    x0s are bench.py's;
  * the port imports and runs its small pieces where there is no nvcc and
    no card (the kernels build only at their first CUDA launch);
  * chip_smoke.py refuses to run without a card, and outside a checkout.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "polympc_torch"
REFERENCE = ROOT / "tests" / "data" / "kite_b512_jax_cpu.npz"
FORBIDDEN = ("jax", "jaxlib", "polympc_tpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "")
              == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "trace_port.py",
                                         ROOT / "kernel_ab.py",
                                         ROOT / "ldlt_solve_orders.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_imports_jax(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _bench_x0s(B):
    """bench.py's draw, as written there (bench.py:97-104)."""
    rng = np.random.default_rng(0)
    s0 = rng.uniform(0.0, 2 * np.pi, B)
    theta0 = np.pi / 6 + 0.2 * np.sin(2 * s0) + rng.normal(0, 0.05, B)
    phi0 = 0.8 * np.cos(s0) + rng.normal(0, 0.05, B)
    gamma0 = rng.uniform(-0.5, 0.5, B)
    return np.stack([np.clip(theta0, 0.05, 1.5), np.clip(phi0, -1.5, 1.5),
                     gamma0, s0, np.full(B, 0.05)], axis=1).astype(
        np.float32)


def test_reference_record_loads_with_bench_x0s():
    from polympc_torch.headline import KKT_TOL, bench_x0s
    assert REFERENCE.stat().st_size < 100 * 1024
    ref = np.load(REFERENCE)
    B = ref["x0s"].shape[0]
    assert ref["x0s"].shape == (B, 5) and B in (128, 512)
    np.testing.assert_array_equal(ref["x0s"], _bench_x0s(512)[:B])
    np.testing.assert_array_equal(bench_x0s(B), _bench_x0s(512)[:B])
    for key in ("residual", "certified", "status", "iters"):
        assert ref[key].shape == (B,)
    np.testing.assert_array_equal(ref["certified"],
                                  ref["residual"] <= KKT_TOL)
    assert ref["certified"].sum() >= B - 10
    assert set(np.unique(ref["status"])) <= {1, 2}
    assert 1 <= ref["iters"].min() and ref["iters"].max() <= 9


def test_status_codes_match_jax():
    from polympc_tpu.utils import status as js
    from polympc_torch.utils import status as ts
    for name in ("UNINITIALIZED", "SOLVED", "MAX_ITER_EXCEEDED", "UNSOLVED",
                 "INFEASIBLE", "INCONSISTENT", "INVALID_SETTINGS"):
        assert getattr(ts, name) == getattr(js, name)
        assert ts.status_name(getattr(ts, name)) == name


def test_full_precision_sets_and_restores():
    from polympc_torch.utils.precision import full_precision
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32,
              torch.get_float32_matmul_precision())
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        with full_precision():
            assert torch.backends.cuda.matmul.allow_tf32 is False
            assert torch.backends.cudnn.allow_tf32 is False
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.backends.cudnn.allow_tf32 is True
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before[0]
        torch.backends.cudnn.allow_tf32 = before[1]
        torch.set_float32_matmul_precision(before[2])


def test_block_diag_scatter_matches_jax():
    import jax.numpy as jnp
    from polympc_tpu.utils.solver_utils import block_diag_scatter as jbd
    from polympc_torch.utils.solver_utils import block_diag_scatter
    blocks = np.random.default_rng(0).normal(size=(2, 4, 3, 2))
    got = block_diag_scatter(torch.as_tensor(blocks))
    for b in range(2):
        np.testing.assert_array_equal(got[b].numpy(),
                                      np.asarray(jbd(jnp.asarray(blocks[b]))))


def test_convert_carries_jax_types():
    import jax.numpy as jnp
    from polympc_tpu.nlp.types import NLPBounds as JBounds
    from polympc_torch.nlp.types import NLPBounds
    from polympc_torch.utils import convert
    jb = JBounds(lbx=jnp.zeros(3), ubx=jnp.ones(3), gl=jnp.zeros(0),
                 gu=jnp.zeros(0))
    tb = convert.bounds(jb, torch.float32, device="cpu")
    assert isinstance(tb, NLPBounds) and tb.ubx.dtype == torch.float32
    prm = convert.params({"p": np.zeros(0), "d": [0.05], "t0": 0.0,
                          "tf": jnp.asarray(2.0)}, device="cpu")
    assert prm["tf"].item() == 2.0 and prm["d"].dtype == torch.float64


def test_kernels_are_not_built_at_import():
    code = ("import polympc_torch.headline, polympc_torch.ops._build as b; "
            "assert b._lib is None; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _run_smoke(cwd, tmp_path):
    env = dict(os.environ, HOME=str(tmp_path), TMPDIR=str(tmp_path),
               CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=env)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    out = _run_smoke(ROOT, tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_refuses_outside_a_checkout(tmp_path):
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(ROOT / "chip_smoke.py", alone / "chip_smoke.py")
    out = _run_smoke(alone, tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _public_callables():
    """Every public function, method and dataclass of the port, by module
    (read from the modules, nothing called)."""
    import dataclasses
    import importlib
    import inspect
    import pkgutil
    import polympc_torch
    for info in pkgutil.walk_packages(polympc_torch.__path__,
                                      "polympc_torch."):
        mod = importlib.import_module(info.name)
        for name, obj in vars(mod).items():
            if name.startswith("_") or getattr(obj, "__module__",
                                               None) != mod.__name__:
                continue
            if inspect.isfunction(obj):
                yield f"{mod.__name__}.{name}", obj
            elif inspect.isclass(obj):
                if dataclasses.is_dataclass(obj):
                    yield f"{mod.__name__}.{name}", obj
                for m_name, m in vars(obj).items():
                    if inspect.isfunction(m) and not m_name.startswith("_"):
                        yield f"{mod.__name__}.{name}.{m_name}", m


def test_public_builders_default_to_the_card():
    """Every public function of the port that takes ``device`` defaults to
    "cuda": nothing resolves a missing device to the CPU."""
    import inspect
    seen = []
    for qual, fn in _public_callables():
        params = inspect.signature(fn).parameters
        if "device" in params:
            seen.append(qual)
            assert params["device"].default == "cuda", qual
    for qual in ("polympc_torch.headline.kite_problem",
                 "polympc_torch.ocp.transcription.Transcription.params",
                 "polympc_torch.ocp.transcription.Transcription."
                 "initial_guess",
                 "polympc_torch.ocp.transcription.ocp_bounds",
                 "polympc_torch.utils.convert.tensor",
                 "polympc_torch.ops.structure.random_bbt_kkt",
                 "polympc_torch.basis.splines.CubicSpline",
                 "polympc_torch.control.path.track_from_curvature",
                 "polympc_torch.models.race_car.make_wave_track",
                 "polympc_torch.headline_table.race_car",
                 "polympc_torch.parallel.dist_sqp.dist_bounds",
                 "polympc_torch.utils.convert.dist_bounds",
                 "polympc_torch.utils.convert.dist_solution",
                 "polympc_torch.dist_point.dist_problem",
                 "polympc_torch.dist_point.run"):
        assert qual in seen, qual
