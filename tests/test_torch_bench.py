"""The bench twin (`python -m mppiisaac_tpu_torch.bench`) on the CPU at a
small size (K=4, H=2; the plain K1, eagerly):

* it prints one JSON line with the keys of the JAX package's `bench.py`
  (read from its source) plus the device and its power limit, and calls
  the rollout once per command: the warm-up (one batch and one
  unpipelined command), iters × chunk timed commands and 5 for the latency
  (on the card, chip_smoke.py counts the same as K1 launches);
* bench.py's environment overrides reach the planner and the record;
* a batch of commands equals the same commands made one after another by
  `_command_impl`, bit for bit (the carry chained, the draws made ahead
  from the same key chain).
"""
import json
import os
import re

import pytest
import torch

from mppiisaac_tpu_torch import bench
from mppiisaac_tpu_torch.ops.fused_rollout import FusedRollout
from mppiisaac_tpu_torch.planner.mppi_isaac import MPPIisaacPlanner
from mppiisaac_tpu_torch.tasks.panda_pick import PandaPickObjective
from mppiisaac_tpu_torch.utils.config_store import load_config

torch.set_num_threads(1)
BENCH_PY = os.path.join(os.path.dirname(__file__), os.pardir, "bench.py")


def bench_py_keys():
    with open(BENCH_PY) as f:
        src = f.read()
    body = src[src.index("json.dumps("):]
    return set(re.findall(r'^\s+"(\w+)":', body, re.M))


@pytest.fixture
def rollouts(monkeypatch):
    """Counts FusedRollout.run calls (the wrapper's entry: the kernel on
    the card, its plain version here)."""
    calls = []
    run = FusedRollout.run

    def counted(self, *a):
        calls.append(1)
        return run(self, *a)

    monkeypatch.setattr(FusedRollout, "run", counted)
    return calls


def _record(capsys):
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


def test_bench_prints_one_json_line_with_bench_keys(capsys, rollouts):
    iters, chunk = 2, 2
    out = bench.main(K=4, H=2, iters=iters, chunk=chunk, device="cpu")
    rec = _record(capsys)
    keys = bench_py_keys()
    assert keys == {"metric", "value", "unit", "vs_baseline", "control_hz",
                    "substeps_per_env_step", "rollout_sweeps", "rollout_fidelity"}
    assert set(rec) == keys | {"device", "power_limit"}
    assert rec["unit"] == "env-steps/s" and rec["device"] == "cpu"
    assert rec["rollout_fidelity"] == "world" and rec["rollout_sweeps"] == 1
    assert rec["substeps_per_env_step"] == 4                       # matched to the world
    assert rec["value"] > 0 and rec["vs_baseline"] == round(rec["value"] / 300_000.0, 2)
    assert "K=4, H=2" in rec["metric"] and "manifold=reduced" in rec["metric"]
    assert out["latency_ms"] > 0 and out["per_command_ms"] > 0
    assert len(rollouts) == (chunk + 1) + iters * chunk + bench.LATENCY_CALLS


def test_bench_reads_the_environment_overrides(capsys, rollouts, monkeypatch):
    for k, v in (("BENCH_FIDELITY", "fast"), ("BENCH_SUBSTEPS", "2"), ("BENCH_SWEEPS", "2"),
                 ("BENCH_MANIFOLD", "full")):
        monkeypatch.setenv(k, v)
    bench.main(K=4, H=2, iters=1, chunk=1, device="cpu")
    rec = _record(capsys)
    assert (rec["rollout_fidelity"], rec["substeps_per_env_step"], rec["rollout_sweeps"]) == \
        ("fast", 2, 2)
    assert "fidelity=fast" in rec["metric"] and "manifold=full" in rec["metric"]
    assert len(rollouts) == 2 + 1 + bench.LATENCY_CALLS


def test_command_batch_equals_commands_one_after_another():
    cfg = load_config("tasks/panda_pick", ["mppi.num_samples=4", "mppi.horizon=2"])
    planner = MPPIisaacPlanner(cfg, PandaPickObjective(cfg), randomize=True, device="cpu")
    state0 = (planner.sim.state, planner._params_K)
    mppi = planner.mppi
    carry = mppi.carry
    batch = bench.CommandBatch(mppi, state0, 2)
    batch.run()
    sums = []
    for _ in range(2):
        action, carry, _ = mppi._command_impl(carry, state0)
        sums.append(action.sum())
    got = batch.carry
    for f in ("U", "lambda_", "sigma", "t0"):
        assert torch.equal(getattr(got, f), getattr(carry, f)), f
    assert (got.key == carry.key).all()
    assert torch.equal(batch._asum, torch.stack(sums))
