"""BENCHMARK.json and the files it names, found by name.

A cell (``workloads`` entry) names a configuration and a traffic mix:

  configuration  ``configs[].file`` (its JSON), the loader beside it (the
                 same path ending in ``.py``) and its plain reference
                 ``port_bench/reference/<config>.py``;
  traffic        ``port_bench/traffic/<traffic>.json``, with the
                 parameters its kind reads (``TRAFFIC_KEYS``);
  limits         ``port_bench/limits/<workload>.json``: the limit of each
                 number the check compares;
  metrics        ``port_bench/metrics/<metric>.py``, one reader per
                 end-to-end or per-layer metric.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
TRAFFIC_KEYS = {"batch": {"batch", "audit_batches", "sample_lanes",
                          "trace_units"},
                "loop": {"dt", "substeps", "warmup_steps", "trace_units"}}


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    def __init__(self, workload: str, root: Path = ROOT):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.entry = cells[workload]
        self.name = workload
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config_path = self.root / self.config_entry["file"]
        self.cfg = json.loads(self.config_path.read_text())
        self.traffic_path = HERE / "traffic" / f"{self.entry['traffic']}.json"
        self.traffic = json.loads(self.traffic_path.read_text())
        missing = TRAFFIC_KEYS[self.traffic["kind"]] - set(self.traffic)
        if missing:
            raise ValueError(f"traffic {self.entry['traffic']!r} lacks "
                             f"{sorted(missing)}")
        if self.traffic["kind"] == "batch" and \
                int(self.traffic["audit_batches"]) < 1:
            raise ValueError("a batch traffic needs one audit batch or more")
        self.limits_path = HERE / "limits" / f"{workload}.json"
        self.chips = int(self.entry["chips"])

    @property
    def loader_path(self) -> Path:
        return self.config_path.with_suffix(".py")

    @property
    def reference_path(self) -> Path:
        return HERE / "reference" / f"{self.entry['config']}.py"

    def loader(self):
        return load_module(self.loader_path,
                           f"port_bench_config_{self.entry['config']}")

    def reference(self):
        return importlib.import_module(
            f"port_bench.reference.{self.entry['config']}")

    def limits(self):
        return json.loads(self.limits_path.read_text())

    def _reports(self, metric) -> bool:
        ws = metric.get("workloads")
        return ws is None or self.name in ws

    def end_to_end(self):
        return [m for m in self.bench["end_to_end"] if self._reports(m)]

    def per_layer(self):
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if self._reports(m) and m["moves"] in e2e]

    @staticmethod
    def metric_path(name: str) -> Path:
        return HERE / "metrics" / f"{name}.py"

    def metric_module(self, name: str):
        return load_module(self.metric_path(name),
                           "port_bench_metric_" + name.replace(".", "_"))
