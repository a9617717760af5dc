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


# ----------------------------------------------------------------------
# a configuration with a tape prior: anymal, cut to K=8 and H=2 on the CPU

TAPE_TRAFFIC = {"loop": "chunked", "episode_steps": 4, "device_steps": 2, "episodes": [11]}


def tape_dropped(monkeypatch, config):
    """The program plans without the tape: no prior passed to the planner."""
    config.pop("prior")


def tape_late(monkeypatch, config):
    """The tape's phase one control step late."""
    from mppiisaac_tpu_torch.planner.priors import QuadrupedGaitPrior

    tape = QuadrupedGaitPrior.tape
    monkeypatch.setattr(QuadrupedGaitPrior, "tape", lambda self, view, t0: tape(self, view, t0 - 1))


@pytest.mark.parametrize("fault", [None, tape_dropped, tape_late],
                         ids=["honest", "tape_dropped", "tape_late"])
def test_tape_fault_is_not_correct(monkeypatch, anymal_config, fault):
    """The judge, under the loosest limits the benchmark holds (pick
    chunked's), calls the honest program correct and a program whose tape
    is dropped or late not correct."""
    import os

    from cellbench import control, judge
    from cellbench.loop import Program
    from cellbench.run import candidates
    from cellbench.spec import HERE

    limits = json.load(open(os.path.join(HERE, "limits", "panda_pick.chunked.json")))
    config = anymal_config(8, horizon=2)
    if fault is not None:
        fault(monkeypatch, config)
    prog = Program(config, TAPE_TRAFFIC, torch.device("cpu"))
    start, recs = control.episode_records(prog, 5, 2, candidates(TAPE_TRAFFIC))
    prog.free()
    assert [int(r["step"]) for r in recs] == [0, 2]
    ref = judge.reference(anymal_config(8, horizon=2), "cpu")
    values = {"start_gap": judge.start_gap(ref, start, 5)}
    values.update(judge.numbers(ref, recs, judge.outputs(ref, recs), judge.u_range(ref)))
    correct, rows = judge.verdict(values, limits)
    if fault is None:
        assert correct and all(v == 0 for v in values.values()), values
    else:
        assert not correct, values
        assert not values["command_gap"] <= limits["command_gap"], values
