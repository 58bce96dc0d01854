"""run.py on a machine without a card: it exits with a non-zero code and
prints no result."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                        "kite_b4096", "--seed", str(2 ** 31 + 7),
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_run_refuses_an_unknown_cell():
    p = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                        "no_such_cell", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_the_jax_check_compares_whole_top_level_names(monkeypatch):
    sys.path.insert(0, str(ROOT / "port_bench"))
    import run
    monkeypatch.setitem(sys.modules, "polympc_tpu_like", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "polympc_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert run.forbidden_modules() == ["jax", "polympc_tpu"]


def test_a_hook_whose_target_is_gone_reads_nothing():
    from port_bench.pb.hooks import Hook
    gone = Hook("polympc_torch.qp.box_admm:no_such_function",
                lambda a, c: 0.0, {}, "cpu")
    gone.install()
    assert gone.results() is None
    import polympc_torch.nlp.refine as refine
    changed = Hook("polympc_torch.nlp.refine:_newton_kkt_solve",
                   lambda a, c: a["no_such_argument"], {}, "cpu")
    changed.install()
    try:
        M = torch.eye(3, dtype=torch.float64)[None]
        x = refine._newton_kkt_solve(M, torch.ones(1, 3, dtype=torch.float64))
    finally:
        changed.remove()
    assert torch.allclose(x, torch.ones(1, 3, dtype=torch.float64))
    assert changed.results() is None
