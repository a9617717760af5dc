"""The control, the reference with every value that crosses a stage kept
in bfloat16, put in the port's place, comes out not correct under each
cell's limits (`python3 -m cellbench.control` reads it on the card at the
cells' own sizes)."""
import json
import os

import pytest
import torch

from cellbench import control, judge
from cellbench.loop import Program
from cellbench.reference.controller import Reference
from cellbench.run import candidates, shrink
from cellbench.spec import ROOT, load_cell

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_control_is_not_correct(workload):
    cell = load_cell(workload)
    shrink(cell)
    cell.config["conf"]["mppi"]["horizon"] = 3
    prog = Program(cell.config, cell.traffic, torch.device("cpu"))
    prog.warm()
    _, recs = control.episode_records(prog, 5, 2, candidates(cell.traffic))
    prog.free()
    ref = Reference(cell.config["conf"], cell.config["cost"], "cpu")
    ctl = Reference(cell.config["conf"], cell.config["cost"], "cpu", store=torch.bfloat16)
    crecs = control.control_records(ctl, recs)
    values = {"start_gap": judge.start_gap(ref, control.control_start(ctl, 5), 5)}
    values.update(judge.numbers(ref, crecs, judge.outputs(ref, crecs), judge.u_range(ref)))
    correct, rows = judge.verdict(values, cell.limits)
    assert not correct, rows
