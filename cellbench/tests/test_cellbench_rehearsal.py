"""A CPU rehearsal of each cell prints a well-formed last line, and the
process that printed it holds no JAX and no JAX package; a run that loads
one anywhere before its last line prints no result."""
import io
import json
import os
import subprocess
import sys
import types

import pytest
import torch

from cellbench import judge, run
from cellbench.spec import ROOT, load_cell

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
FORBIDDEN = {"jax", "jaxlib", "flax", "mppiisaac_tpu"}

CODE = """
import json, sys
from cellbench import run
rc = run.main(sys.argv[1:])
print("MODULES " + json.dumps(sorted({m.split(".")[0] for m in sys.modules})), file=sys.stderr)
sys.exit(rc)
"""


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal(workload, trace):
    out = subprocess.run(
        [sys.executable, "-c", CODE, "--workload", workload, "--seed", str(2 ** 31 + 12345),
         "--seconds", "0.1", "--trace", str(trace), "--rehearse"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert line["device"]["platform"] == "cpu"
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and m["value"] > 0, name
    if not trace:
        assert set(line["metrics"]) == {m.name for m in load_cell(workload).end_to_end}
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]
    err = out.stderr.strip().splitlines()
    modules = set(json.loads(err[-1].split(" ", 1)[1]))
    assert "mppiisaac_tpu_torch" in modules and not modules & FORBIDDEN
    assert err[-2].startswith("check ")


@pytest.mark.parametrize("trace", [0, 1])
def test_late_import_is_caught(monkeypatch, trace):
    """JAX loaded by the comparison, after the window, still stops the run."""
    outputs = judge.outputs

    def importing(*a, **k):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return outputs(*a, **k)

    monkeypatch.setattr(judge, "outputs", importing)
    out, err = io.StringIO(), io.StringIO()
    args = run.parse(["--workload", "panda_reach.per_step", "--seed", "3", "--seconds", "0.1",
                      "--trace", str(trace), "--rehearse"])
    n = torch.get_num_threads()
    try:
        rc = run.run(args, out=out, err=err)
    finally:
        torch.set_num_threads(n)
    assert rc != 0 and out.getvalue() == ""
    assert "jax" in err.getvalue()
