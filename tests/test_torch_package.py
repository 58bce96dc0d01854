"""Package-level checks of the PyTorch port (polympc_torch):

  * no file of the port, and not chip_smoke.py, trace_port.py,
    kernel_ab.py, ldlt_solve_orders.py or the test helpers that run
    without JAX (the gloo ranks' tests/_torch_dist_worker.py,
    tests/_pivot_floor.py), imports JAX or the JAX package (an AST scan):
    the card's machine has no JAX;
  * nor does one name a path under the JAX package in a string literal
    other than a docstring (a file it could read, such as the JAX
    package's native sources), a ``file.py:line`` citation apart;
  * the committed JAX reference of the certified kite batch loads, and its
    x0s are bench.py's;
  * the port imports and runs its small pieces where there is no nvcc and
    no card (the kernels build only at their first CUDA launch);
  * chip_smoke.py refuses to run without a card, and outside a checkout.
"""
import ast
import os
import re
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
    return sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "trace_port.py",
        ROOT / "kernel_ab.py", ROOT / "ldlt_solve_orders.py",
        ROOT / "tests" / "_torch_dist_worker.py",
        ROOT / "tests" / "_pivot_floor.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_imports_jax(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


# a path component "polympc_tpu" (a directory to join or read from), and
# the one form that names it without being a path to open: a citation
# "polympc_tpu/<file>.py:<line>" (chip_smoke.py's "replaces" keys)
_JAX_PATH = re.compile(r"(^|[/\\])polympc_tpu([/\\]|$)")
_CITATION = re.compile(r"^polympc_tpu/[\w/]+\.py:\d+$")


def _string_literals(path):
    """(line, text) of every string constant of a file that is not a
    docstring, the constant parts of f-strings included."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docs = set()
    for node in ast.walk(tree):
        if (isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                              ast.AsyncFunctionDef)) and node.body
                and isinstance(node.body[0], ast.Expr)
                and isinstance(node.body[0].value, ast.Constant)):
            docs.add(id(node.body[0].value))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs):
            yield node.lineno, node.value


def _names_jax_path(text):
    return bool(_JAX_PATH.search(text)) and not _CITATION.match(text)


def test_path_scan_catches_what_it_must():
    for bad in ("polympc_tpu", "polympc_tpu/native/qpmad.cpp",
                "../polympc_tpu/native", "x/polympc_tpu/ops"):
        assert _names_jax_path(bad), bad
    for fine in ("polympc_tpu/ops/ldlt.py:355", "polympc_torch/native",
                 "the JAX package (polympc_tpu.nlp.ip)"):
        assert not _names_jax_path(fine), fine


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_names_a_jax_package_path(path):
    bad = [(line, text[:60]) for line, text in _string_literals(path)
           if _names_jax_path(text)]
    assert not bad, f"{path.relative_to(ROOT)} names {bad}"


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


def test_solvers_record_matches_the_port_on_its_first_lanes():
    """tests/data/solvers_jax_cpu.npz (the JAX package's record of the
    solver layer's card paths) loads, stays small, holds bench's x0s, and
    its QP lanes are the port's own on the CPU: the interior point's x to
    1e-9 and the same iteration counts on the first 8 lanes."""
    from polympc_torch.headline import bench_x0s
    from polympc_torch.headline_table import spline_batch
    from polympc_torch.qp import QPData, qp_ip_solve
    path = ROOT / "tests" / "data" / "solvers_jax_cpu.npz"
    assert path.stat().st_size < 1024 * 1024
    rec = np.load(path)
    np.testing.assert_array_equal(rec["kite_x0s"], bench_x0s(512))
    assert rec["kite_status"].shape == rec["kite_cost"].shape == (512,)
    assert rec["ip_status"].shape == rec["admm_status"].shape == (4096,)
    qp = spline_batch(8, "cpu", torch.float64)[1]
    sol = qp_ip_solve(qp)
    np.testing.assert_array_equal(sol.iters.numpy(), rec["ip_iters"][:8])
    np.testing.assert_allclose(sol.x.numpy(), rec["ip_x"][:8], rtol=0,
                               atol=1e-9)


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
    """Every public function, method, dataclass and class with its own
    constructor of the port, by module (read from the modules, nothing
    called)."""
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
                if dataclasses.is_dataclass(obj) or "__init__" in vars(obj):
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
                 "polympc_torch.dist_point.run",
                 "polympc_torch.control.mpc.MPC",
                 "polympc_torch.control.nmpc.NMPC",
                 "polympc_torch.control.nmpf.NMPF",
                 "polympc_torch.nlp.hessian.block_hessian_identity",
                 "polympc_torch.cstr_point.cstr_problem",
                 "polympc_torch.cstr_point.batch_fn",
                 "polympc_torch.cstr_point.run",
                 "polympc_torch.solvers_point.kite_ip",
                 "polympc_torch.solvers_point.mpc_ip",
                 "polympc_torch.solvers_point.qp_solvers",
                 "polympc_torch.solvers_point.lqr_batch",
                 "polympc_torch.solvers_point.nlp_extras",
                 "polympc_torch.ocp.multiple_shooting.MSTranscription."
                 "initial_guess",
                 "polympc_torch.ocp.multiple_shooting.MSTranscription.params",
                 "polympc_torch.ocp.multiple_shooting.ms_bounds",
                 "polympc_torch.ocp.identification.identify",
                 "polympc_torch.ocp_extras_point.kite_ms_problem",
                 "polympc_torch.ocp_extras_point.batch_fn",
                 "polympc_torch.ocp_extras_point.kite_ms",
                 "polympc_torch.ocp_extras_point.first_epoch",
                 "polympc_torch.ocp_extras_point.certify_system",
                 "polympc_torch.ocp_extras_point.pendulum_data",
                 "polympc_torch.ocp_extras_point.ocp_extras",
                 "polympc_torch.parallel.multihost.initialize_multihost",
                 "polympc_torch.multichip_point.launch",
                 "polympc_torch.multichip_point.stages",
                 "polympc_torch.multichip_point.run",
                 "polympc_torch.scaling_point.sweep_problem",
                 "polympc_torch.scaling_point.batch_fn",
                 "polympc_torch.scaling_point.run_point",
                 "polympc_torch.scaling_point.sweep",
                 "polympc_torch.scaling_point.first_epoch",
                 "polympc_torch.scaling_point.run_kernel_micro",
                 "polympc_torch.nlp.types.unbounded",
                 "polympc_torch.parallel.long_horizon.LongHorizon."
                 "initial_guess",
                 "polympc_torch.parallel.long_horizon.solve_long_horizon",
                 "polympc_torch.long_horizon_point.split_timer",
                 "polympc_torch.long_horizon_point.run"):
        assert qual in seen, qual


def test_top_level_exports_resolve_lazily():
    """``import polympc_torch`` imports no subpackage; every name of the
    JAX package's top-level exports resolves on first access, to the same
    object as the subpackage's."""
    import importlib
    import polympc_tpu
    code = ("import sys, polympc_torch; "
            "print(sorted(m for m in sys.modules "
            "if m.startswith('polympc_torch')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "['polympc_torch']"
    import polympc_torch
    for mod, names in polympc_tpu._EXPORTS.items():
        assert polympc_torch._EXPORTS[mod] == names, mod
        sub = importlib.import_module(f"polympc_torch.{mod}")
        assert getattr(polympc_torch, mod) is sub
        for name in names:
            assert getattr(polympc_torch, name) is getattr(sub, name), name
    assert set(polympc_tpu.__all__) == set(polympc_torch.__all__)
    with pytest.raises(AttributeError):
        polympc_torch.no_such_name


# The JAX package's public top-level names that the port carries under
# another name, each with its counterpart there and the reason; the map
# lists names, never a module.
RENAMED = {
    "ops.ldlt.pallas_fits": (
        ("nlp.refine.REFINE_LDLT_MAX_K", "ops.ldlt.LDLT_MAX_K"),
        "the TPU's VMEM rule for a (K, K, 128) lane tile; the port's LDL^T "
        "route is re-derived for Hopper: the kernels' shared-memory bound "
        "LDLT_MAX_K and the certify's K <= 206 rule"),
    "ops.structure.bbt_solve_jnp": (
        ("ops.structure.bbt_solve_dense",),
        "the same oracle, batch-first with a packed right-hand side "
        "(tests/test_torch_api_parity.py holds it to bbt_solve_jnp's "
        "(xb, xp))"),
}


def _public_api(path):
    """(names, classes) of a module, read by AST: its public top-level
    functions and classes and its ``__all__`` (the literal parts), and per
    public class its public methods and annotated (dataclass) fields."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names, classes = set(), {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and not node.name.startswith("_"):
            names.add(node.name)
        if isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            classes[node.name] = {
                b.name if not isinstance(b, ast.AnnAssign) else b.target.id
                for b in node.body
                if (isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and not b.name.startswith("_"))
                or (isinstance(b, ast.AnnAssign)
                    and isinstance(b.target, ast.Name)
                    and not b.target.id.startswith("_"))}
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            names |= {e.value for lst in ast.walk(node.value)
                      if isinstance(lst, ast.List) for e in lst.elts
                      if isinstance(e, ast.Constant)}
    return names, classes


def _module_names(path):
    """Every name a module binds at its top level: definitions,
    assignments and imports."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out.add(node.target.id)
    return out


def _import_source(path, node):
    """The port's file that ``from ... import`` at ``path`` reads, or None
    (a module outside the port)."""
    if node.level:
        base = path.parents[node.level - 1]
        parts = node.module.split(".") if node.module else []
    else:
        parts = (node.module or "").split(".")
        if parts[0] != PORT.name:
            return None
        base, parts = PORT, parts[1:]
    mod = base.joinpath(*parts)
    for cand in (mod.with_suffix(".py"), mod / "__init__.py"):
        if cand.is_file():
            return cand
    return None


def _class_members(path, cls, hops=4):
    """The public methods and fields of the class a module binds as
    ``cls``: defined there, or imported there from another module of the
    port (followed through re-exports); None if it does not resolve to a
    class definition."""
    _, classes = _public_api(path)
    if cls in classes:
        return classes[cls]
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in tree.body:
        if not isinstance(node, ast.ImportFrom):
            continue
        for a in node.names:
            if (a.asname or a.name) == cls:
                src = _import_source(path, node)
                if src is None or hops == 0:
                    return None
                return _class_members(src, a.name, hops - 1)
    return None


def _resolves(dotted):
    """Whether "sub.module.name" names a top-level binding of the port."""
    mod, name = dotted.rsplit(".", 1)
    path = PORT.joinpath(*mod.split(".")).with_suffix(".py")
    return path.exists() and name in _module_names(path)


def test_subpackage_exports_match_jax():
    """Every module of the JAX package has its counterpart in the port,
    read by AST (no JAX import): the module exists; it defines or exports
    every public top-level function and class and every ``__all__`` name
    of its twin (apart from RENAMED, whose counterparts resolve); each
    public class has every public method and dataclass field of its twin,
    whether the counterpart module defines the class or imports it.
    And polympc_torch.ocp and polympc_torch.utils export what the JAX
    package's ocp and utils export (utils adds full_precision and
    block_diag_scatter, which the port's solvers share)."""
    jax_root = ROOT / "polympc_tpu"
    missing, seen = [], set()
    for jpath in sorted(jax_root.rglob("*.py")):
        rel = jpath.relative_to(jax_root)
        mod = ".".join(rel.with_suffix("").parts)
        tpath = PORT / rel
        if not tpath.exists():
            missing.append(f"module {mod}")
            continue
        names, classes = _public_api(jpath)
        have = _module_names(tpath) | _public_api(tpath)[0]
        for name in sorted(names):
            key = f"{mod}.{name}" if mod != "__init__" else name
            if key in RENAMED:
                seen.add(key)
                continue
            if name not in have:
                missing.append(key)
        for cls, members in classes.items():
            if cls not in have:
                continue
            tmembers = _class_members(tpath, cls)
            if tmembers is None:
                missing.append(f"{mod}.{cls}: not a class of the port")
            elif members - tmembers:
                missing.append(f"{mod}.{cls}: {sorted(members - tmembers)}")
    assert not missing, missing
    assert seen == set(RENAMED), set(RENAMED) - seen
    for key, (counterparts, reason) in RENAMED.items():
        assert key.count(".") >= 2 and reason, key
        for c in counterparts:
            assert _resolves(c), (key, c)

    import polympc_tpu.ocp as jo
    import polympc_tpu.utils as ju
    import polympc_torch.ocp as to
    import polympc_torch.utils as tu
    assert set(to.__all__) == set(jo.__all__)
    assert set(tu.__all__) == set(ju.__all__) | {"full_precision",
                                                 "block_diag_scatter"}
    for m in (to, tu):
        for name in m.__all__:
            assert getattr(m, name) is not None, name


def test_parity_walk_catches_what_it_must(tmp_path):
    """The AST reading behind test_subpackage_exports_match_jax: top-level
    definitions, literal __all__ parts, class methods and dataclass
    fields; private names and nested definitions do not count."""
    src = tmp_path / "m.py"
    src.write_text(
        "import numpy as np\n"
        "from a.b import c as d\n"
        "__all__ = ['x'] + sorted(Y)\n"
        "K = 3\n"
        "def f():\n    def inner(): pass\n"
        "def _g(): pass\n"
        "class C:\n    u: int = 0\n    _v: int = 1\n"
        "    def m(self): pass\n    def _p(self): pass\n")
    names, classes = _public_api(src)
    assert names == {"x", "f", "C"}
    assert classes == {"C": {"u", "m"}}
    assert _module_names(src) == {"np", "d", "__all__", "K", "f", "_g",
                                  "C"}
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("from .a import C\n")
    (pkg / "a.py").write_text("class C:\n    u: int = 0\n"
                              "    def m(self): pass\n")
    (pkg / "b.py").write_text("from . import C as D\nE = D\n"
                              "from numpy import ndarray\n")
    assert _class_members(pkg / "b.py", "D") == {"u", "m"}
    assert _class_members(pkg / "b.py", "E") is None
    assert _class_members(pkg / "b.py", "ndarray") is None
    assert _class_members(PORT / "nlp" / "__init__.py", "SQPSettings") \
        == _public_api(PORT / "nlp" / "types.py")[1]["SQPSettings"]
    assert _resolves("parallel.long_horizon.solve_long_horizon")
    assert not _resolves("parallel.long_horizon.no_such_name")
    assert not _resolves("no_such_module.f")
