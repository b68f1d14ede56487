"""Finding a cell and everything it names, from files alone.

`BENCHMARK.json` at the root of the checkout lists the cells, the
configurations and the metrics. Each of them lives in files of its own,
found by name:

    portbench/configs/<config>.json     sizes, dtypes, source, reduced, assumed
    portbench/traffic/<traffic>.json    a traffic mix: parameters for
                                        `harness.traffic`, the one generator
    portbench/workloads/<cell>.json     slots, page pool, chunking, the
                                        correctness sample and its limits
    portbench/metrics/<metric>.py       a reader of the run's record (every
                                        metric, end-to-end or per-layer):
                                        `read(record) -> float | None`

so a later change adds a cell, a configuration, a mix or a metric with new
files and entries, and edits no file that is there."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List, Optional

BENCH_DIR = "portbench"


@dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    reader: Optional[Callable] = None


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic: dict
    workload: dict
    end_to_end: List[Metric] = field(default_factory=list)
    per_layer: List[Metric] = field(default_factory=list)


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"benchmark file {path} is missing")
    with open(path) as f:
        return json.load(f)


def load_reader(root: Path, name: str) -> Callable:
    """The `read` function of `portbench/metrics/<name>.py`."""
    path = Path(root) / BENCH_DIR / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"metric reader {path} is missing")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root, name: str) -> Cell:
    """The cell `name` of `<root>/BENCHMARK.json`, with its configuration,
    traffic mix, workload file and the metrics it reports."""
    root = Path(root)
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"unknown workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    d = root / BENCH_DIR
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / configs[w["config"]]["file"])
    cell = Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                config=config,
                traffic=_json(d / "traffic" / f"{w['traffic']}.json"),
                workload=_json(d / "workloads" / f"{name}.json"))
    for group, out in (("end_to_end", cell.end_to_end),
                       ("per_layer", cell.per_layer)):
        for m in bench[group]:
            if _applies(m, name):
                out.append(Metric(m["name"], m["unit"], m["better"],
                                  m["source"],
                                  reader=load_reader(root, m["name"])))
    return cell
