"""What one cell of the benchmark is, read from data by name.

`BENCHMARK.json` at the root of the checkout lists the cells, the metrics
and the configurations. A cell names a configuration, found as
`configs/<config>.json`, and a traffic mix, found as
`traffic/<traffic>.json`; each per-layer metric is read by
`metrics/<name>.py`, or where there is none by the reader of the quantity
its name holds before the first "." (`k1_ms.per_step` by `metrics/k1_ms.py`);
the limits of the comparison that decides `correct`
are `limits/<cell>.json`. Adding a configuration, a traffic mix, a cell or a
metric adds files and entries and edits none of this code.

A configuration file names the program's side and the reference's side of
each part it needs: `"objective"` (the port's "module:Class") and `"cost"`
(a module under `reference/costs/`); and, for a task that plans with a tape
prior, `"prior"` (the port's "module:function", called with the task
configuration, that makes the planner's prior) and `"reference_prior"` (a
module under `reference/priors/`). A configuration without the two prior
keys plans without a prior.
"""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


@dataclass
class Metric:
    name: str
    unit: str
    entry: dict             # its entry in BENCHMARK.json


@dataclass
class Cell:
    name: str
    chips: int
    config: dict            # configs/<config>.json
    traffic: dict           # traffic/<traffic>.json
    limits: dict            # limits/<cell>.json: number → limit
    end_to_end: List[Metric] = field(default_factory=list)
    per_layer: List[Metric] = field(default_factory=list)

    def reader(self, metric: Metric) -> Callable:
        """The `read(ctx)` of metrics/<name>.py, else of metrics/<stem>.py,
        the stem being the name before its first "."."""
        name = metric.name
        path = os.path.join(HERE, "metrics", f"{name}.py")
        if not os.path.exists(path):
            name = name.split(".")[0]
            path = os.path.join(HERE, "metrics", f"{name}.py")
        spec = importlib.util.spec_from_file_location(f"cellbench_metric_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def _applies(entry: dict, cell: str, reported: set) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry.get("moves", entry["name"]) in reported


def load_cell(name: str, bench_path: str = os.path.join(ROOT, "BENCHMARK.json")) -> Cell:
    bench = _load(bench_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_path}: {sorted(cells)}")
    w = cells[name]
    cell = Cell(name=name, chips=int(w["chips"]),
                config=_load(os.path.join(HERE, "configs", f"{w['config']}.json")),
                traffic=_load(os.path.join(HERE, "traffic", f"{w['traffic']}.json")),
                limits=_load(os.path.join(HERE, "limits", f"{name}.json")))
    for e in bench["end_to_end"]:
        if "workloads" not in e or name in e["workloads"]:
            cell.end_to_end.append(Metric(e["name"], e["unit"], e))
    reported = {m.name for m in cell.end_to_end}
    for e in bench["per_layer"]:
        if _applies(e, name, reported):
            cell.per_layer.append(Metric(e["name"], e["unit"], e))
    return cell


def names(kind: str) -> Dict[str, str]:
    """The files of one kind under the benchmark ("configs", "traffic",
    "metrics", "limits"): name → path."""
    d = os.path.join(HERE, kind)
    out = {}
    for f in sorted(os.listdir(d)):
        stem, ext = os.path.splitext(f)
        if ext in (".json", ".py") and not f.startswith("_"):
            out[stem] = os.path.join(d, f)
    return out
