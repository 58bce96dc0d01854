"""BENCHMARK.json against the benchmark's contract, and every file a cell
names resolves by name."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
HERE = ROOT / "port_bench"

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    assert (ROOT / BENCH["command"][1]).is_file()
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units_use_the_allowed_characters():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and _line(w["why"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert len({w["name"] for w in BENCH["workloads"]}) == \
        len(BENCH["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_end_to_end_bounds_and_sources():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_every_moves_names_an_end_to_end_metric_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert _line(m["layer"])
        for cell in m["workloads"]:
            assert cell in cells
            assert _reports(e2e[m["moves"]], cell)
        layers.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_every_cell_reports_setup_another_metric_and_a_layer_metric():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in BENCH["end_to_end"]
               if _reports(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m["workloads"] for m in BENCH["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_file_of_a_cell_resolves_by_name(cell):
    from port_bench.pb.spec import Cell
    c = Cell(cell, ROOT)
    assert c.config_path.is_file() and c.loader_path.is_file()
    assert c.config_path.is_relative_to(HERE)
    assert c.reference_path.is_file()
    assert c.traffic_path.is_file() and c.limits_path.is_file()
    assert c.cfg["name"] == c.entry["config"]
    assert c.traffic["kind"] in ("batch", "loop")
    for m in c.end_to_end() + c.per_layer():
        assert Cell.metric_path(m["name"]).is_file()
        assert callable(c.metric_module(m["name"]).read)
    keys = {"batch": {"cert_kkt_max", "kkt_gap_rel", "sqp_viol_gap_rel",
                      "later_fail_excess"},
            "loop": {"viol_gap_rel", "cost_gap_rel",
                     "solved_stat_ratio"}}[c.traffic["kind"]]
    assert set(c.limits()) == keys


def test_the_configurations_match_their_entries():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))


def test_a_batch_traffic_without_audit_batches_is_refused(tmp_path,
                                                          monkeypatch):
    from port_bench.pb import spec
    t = json.loads((HERE / "traffic" / "batch_b4096.json").read_text())
    del t["audit_batches"]
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "batch_b4096.json").write_text(json.dumps(t))
    monkeypatch.setattr(spec, "HERE", tmp_path)
    with pytest.raises(ValueError, match="audit_batches"):
        spec.Cell("kite_b4096", ROOT)
