"""`BENCHMARK.json` and the files it names, found by name.

- a configuration: its `file` (under `portbench/configs/`);
- a traffic mix: `portbench/traffic/<traffic>.json`, whose `driver` names
  `portbench/drivers/<driver>.py`;
- a cell's limits for `correct`: `portbench/limits/<cell>.json`;
- a metric, end-to-end or per-layer: the reader `portbench/metrics/<name>.py`,
  whose `read(run)` returns the number, or None where it finds nothing.

A cell added as these files and an entry in `BENCHMARK.json` runs with no
edit to any file that is there.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_module(path: Path):
    """A Python file of the benchmark, loaded by path (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"portbench_file_{path.stem}", path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Metric:
    name: str
    unit: str
    entry: dict
    read: Callable


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file's `config`
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[Metric]
    per_layer: List[Metric]
    root: Path

    def driver(self):
        return load_module(self.root / "portbench" / "drivers" / f"{self.traffic['driver']}.py")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config_file = _json(root / configs[w["config"]]["file"])
    pb = root / "portbench"

    def metrics(entries) -> List[Metric]:
        return [Metric(m["name"], m["unit"], m,
                       load_module(pb / "metrics" / f"{m['name']}.py").read)
                for m in entries]

    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", ()) or
                 ("workloads" not in m and m["moves"] in reported)]
    return Cell(name=name, chips=int(w["chips"]), config=config_file["config"],
                traffic=_json(pb / "traffic" / f"{w['traffic']}.json"),
                limits=_json(pb / "limits" / f"{name}.json"),
                end_to_end=metrics(e2e), per_layer=metrics(per_layer), root=root)
