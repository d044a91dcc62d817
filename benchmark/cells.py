"""Where the harness finds a cell's parts, by the names in BENCHMARK.json.

A workload names its configuration (the file that the configuration's entry
names, relative to BENCHMARK.json) and its traffic (``traffic/<name>.json``
beside this file); a metric is read by ``metrics/<name>.py`` beside this
file, whose ``read(window)`` returns the value, or None where it finds
nothing to read.  Adding a cell, a configuration, a traffic mix or a metric
adds files and entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
BENCHMARK = HERE.parent / "BENCHMARK.json"


class Catalog:
    def __init__(self, bench_path=BENCHMARK, traffic_dir=HERE / "traffic"):
        self.path = pathlib.Path(bench_path)
        self.bench = json.loads(self.path.read_text())
        self.traffic_dir = pathlib.Path(traffic_dir)

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in {self.path}")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return json.loads((self.path.parent / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in {self.path}")

    def traffic(self, name: str) -> dict:
        return json.loads((self.traffic_dir / f"{name}.json").read_text())

    def metrics(self, workload: str, trace: bool) -> list[dict]:
        """The metrics a run of ``workload`` reports: its end-to-end ones
        untraced, its per-layer ones traced."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if workload in m.get("workloads", [workload])]


def reader(name: str):
    """The ``read`` of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"{__package__}.metrics.{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
