"""The rest of a run, with the timed path broken underneath, comes out not
correct: one test for each fault a cell can have. (One chip: no exchange
between chips to leave out.)"""
import io
import json

import pytest
import torch

from cellbench import run


def unchanged_world_step(monkeypatch):
    from mppiisaac_tpu_torch.ops.fused_rollout import FusedWorldStep

    monkeypatch.setattr(FusedWorldStep, "step", lambda self, state, params: state)


def half_the_batch(monkeypatch):
    """K1 leaves out the second half of the samples: their costs are huge,
    so the update's weighted mean is taken over the rest."""
    from mppiisaac_tpu_torch.ops.fused_rollout import FusedRollout

    rollout = FusedRollout.rollout

    def halved(self, *a):
        costs, vis = rollout(self, *a)
        costs = costs.clone()
        costs[costs.shape[0] // 2:] = 1e30
        return costs, vis

    monkeypatch.setattr(FusedRollout, "rollout", halved)


def later_steps(monkeypatch):
    """K1 right at the first horizon step and off by 1% after it."""
    from mppiisaac_tpu_torch.ops.fused_rollout import FusedRollout

    rollout = FusedRollout.rollout

    def later(self, *a):
        costs, vis = rollout(self, *a)
        costs = costs.clone()
        costs[:, 1:] *= 1.01
        return costs, vis

    monkeypatch.setattr(FusedRollout, "rollout", later)


def tenth_of_the_samples(monkeypatch):
    """K1's costs of one sample in ten off by 10%, at every horizon step."""
    from mppiisaac_tpu_torch.ops.fused_rollout import FusedRollout

    rollout = FusedRollout.rollout

    def tenth(self, *a):
        costs, vis = rollout(self, *a)
        costs = costs.clone()
        costs[: costs.shape[0] // 10] *= 1.1
        return costs, vis

    monkeypatch.setattr(FusedRollout, "rollout", tenth)


def altered_action(monkeypatch):
    from mppiisaac_tpu_torch.planner.mppi_isaac import MPPIisaacPlanner

    full = MPPIisaacPlanner._full

    def altered(self, *a, **k):
        action, carry, info = full(self, *a, **k)
        return action + 0.01, carry, info

    monkeypatch.setattr(MPPIisaacPlanner, "_full", altered)


def rehearse(workload):
    out, err = io.StringIO(), io.StringIO()
    args = run.parse(["--workload", workload, "--seed", "99", "--seconds", "0.1", "--trace", "0",
                      "--rehearse"])
    n = torch.get_num_threads()
    try:
        assert run.run(args, out=out, err=err) == 0
    finally:
        torch.set_num_threads(n)
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("workload", ["panda_reach.per_step", "panda_reach.chunked",
                                      "panda_pick.per_step"])
@pytest.mark.parametrize("fault,number", [(unchanged_world_step, "pose_gap"),
                                          (half_the_batch, "cost_gap"),
                                          (later_steps, "horizon_cost_gap"),
                                          (tenth_of_the_samples, "cost_gap"),
                                          (altered_action, "command_gap")])
def test_fault_is_not_correct(monkeypatch, workload, fault, number):
    # 20 samples, so that one in ten is two of them
    monkeypatch.setitem(run.REHEARSAL, "num_samples", 20)
    fault(monkeypatch)
    line = rehearse(workload)
    assert line["correct"] is False and line["failed"] > 0
    c = line["checks"][number]
    assert not c["value"] <= c["limit"]
