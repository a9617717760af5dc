"""Every configuration, traffic mix, metric reader and limits file loads, and
BENCHMARK.json names them as the benchmark's contract asks."""
import json
import os
import re

import pytest

from cellbench import spec
from cellbench.judge import NUMBERS, OPTIONAL

ROOT = spec.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["cellbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH).encode()) < 64 * 1024


def test_names_units_and_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("cellbench/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                   "higher")
    names = [x["name"] for k in ("configs", "workloads") for x in BENCH[k]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))


def test_every_file_is_named_and_loads():
    configs = {c["name"] for c in BENCH["configs"]}
    assert set(spec.names("configs")) == configs
    for c in BENCH["configs"]:
        d = json.load(open(os.path.join(ROOT, c["file"])))
        assert d["name"] == c["name"] and d["reduced"] == c["reduced"]
        assert int(d["checked_steps"]) >= 1 and ":" in d["objective"]
        assert os.path.exists(os.path.join(ROOT, "cellbench", "reference", "costs",
                                           f"{d['cost']}.py"))
    assert {w["config"] for w in BENCH["workloads"]} == configs
    assert set(spec.names("traffic")) == {w["traffic"] for w in BENCH["workloads"]}
    assert set(spec.names("limits")) == {w["name"] for w in BENCH["workloads"]}
    # every per-layer metric has a reader, by its name or its stem, and every
    # reader serves a metric
    readers = set(spec.names("metrics"))
    used = {m["name"] if m["name"] in readers else m["name"].split(".")[0]
            for m in BENCH["per_layer"]}
    assert used == readers


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads(workload):
    cell = spec.load_cell(workload)
    assert set(NUMBERS) - set(OPTIONAL) <= set(cell.limits) <= set(NUMBERS)
    assert all(v >= 0 for v in cell.limits.values())
    e2e = {m.name for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m.entry["moves"] in e2e
        assert cell.reader(m)({}) is None      # finds nothing to read: returns nothing
