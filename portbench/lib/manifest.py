"""The benchmark's manifest and the files it names, found by name.

`BENCHMARK.json` at the checkout's root lists the configurations, cells and
metrics. Each piece is a file of its own under `portbench/`:

  configs/<file named by the configuration>   sizes, source, layer map
  traffic/<traffic>.json                      a traffic mix: its driver's
                                              `kind` and its parameters
  limits/<cell>.json                          the correctness limits of a cell
  metrics/<metric>.py                         a per-layer metric's reader:
                                              `read(ctx)` -> a number or None

so that a later change adds a cell, a mix or a metric by adding files and
entries, and edits none.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One entry of `workloads` with what it names: its configuration (the
    manifest's entry and the file's contents), its traffic mix, its limits
    and the metrics it reports."""

    def __init__(self, bench: dict, name: str, root: Path = ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
        self.root, self.bench = root, bench
        self.entry = cells[name]
        self.name, self.chips = name, int(self.entry["chips"])
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = _read_json(root / configs[self.entry["config"]]["file"])
        self.traffic = _read_json(root / "portbench" / "traffic" / f"{self.entry['traffic']}.json")
        limits = root / "portbench" / "limits" / f"{name}.json"
        self.limits: Dict[str, float] = _read_json(limits) if limits.exists() else {}

    def _reports(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def end_to_end(self) -> List[dict]:
        return [m for m in self.bench["end_to_end"] if self._reports(m)]

    def per_layer(self) -> List[dict]:
        """The per-layer metrics this cell reports: those listing it, and
        those without a list whose end-to-end metric the cell reports."""
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def metric_reader(name: str, root: Path = ROOT) -> Callable[[dict], Optional[float]]:
    """`read` of portbench/metrics/<name>.py."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
