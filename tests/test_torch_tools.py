"""The port's tools around the control loop, on the CPU:

* `utils/profiling`: `trace` (torch.profiler, a Chrome trace with the
  program's spans; no device time without a GPU);
* `benchmarks/runner`: the point_robot and panda benchmarks for 2 short
  trials at a small K and H, with the goals and obstacles the JAX runner
  draws from the same seed (the JAX runner's planner and world stubbed: the
  draws are what is compared);
* `tasks/tuning`: `Study` suggests what the JAX `Study` suggests from the
  same seed, through its refinement; `Tuning` re-tunes the in-process
  planner and a planner behind `runtime/server.Client` alike.
"""
import json

import numpy as np
import torch

from mppiisaac_tpu.benchmarks import runner as jrunner
from mppiisaac_tpu.tasks import tuning as jtuning

from mppiisaac_tpu_torch.benchmarks import runner
from mppiisaac_tpu_torch.planner.mppi_isaac import MPPIisaacPlanner
from mppiisaac_tpu_torch.runtime.loop import goal_world
from mppiisaac_tpu_torch.runtime.server import Client, Server
from mppiisaac_tpu_torch.tasks import tuning
from mppiisaac_tpu_torch.tasks.point_robot import PointRobotObjective
from mppiisaac_tpu_torch.utils.config_store import load_config
from mppiisaac_tpu_torch.utils.profiling import span, trace

torch.set_num_threads(1)
SMALL = ["mppi.num_samples=16", "mppi.horizon=4"]


def test_phase_profiler_and_trace(tmp_path):
    """`trace`: the Chrome trace holds the block's ops and the program's
    spans; without a GPU no device time."""
    with trace(str(tmp_path), "t.json") as t:
        with span("loop.step"):
            (torch.randn(64, 64) @ torch.randn(64, 64)).sum()
    doc = json.loads((tmp_path / "t.json").read_text())
    names = [str(e.get("name", "")) for e in doc["traceEvents"]]
    assert any("mm" in n for n in names) and "loop.step" in names
    assert t.window_s > 0 and t.device_busy_s == 0.0 and t.idle_share is None
    assert t.kernels == {}


class _StubAdapter:
    """Records the goals and obstacles the JAX runner hands its planner."""

    def __init__(self, cfg, objective_factory, **kw):
        self.goals, self.obsts = [], []
        _StubAdapter.last = self
        self.planner = self

    def setGoal(self, goal):
        self.goals.append(np.asarray(goal, np.float64))

    def reset(self):
        pass

    def computeAction(self, q, qdot, obst=None):
        self.obsts.append(np.asarray(obst[0][0][:2], np.float64))
        return np.zeros(3)

    def compute_action_from_state(self, state):
        return np.zeros(7)


class _StubWorld:
    def __init__(self, *a, **kw):
        import types

        self.state = types.SimpleNamespace(q=np.zeros((1, 9)), qd=np.zeros((1, 9)))
        self.view = types.SimpleNamespace(link_position=lambda *a: np.full((1, 3), 9.0))

    def __getattr__(self, name):
        return lambda *a, **kw: None


def test_runner_benchmarks_draw_the_jax_runner_goals(monkeypatch):
    import mppiisaac_tpu.runtime.sim as jsim

    monkeypatch.setattr(jrunner, "PlannerAdapter", _StubAdapter)
    monkeypatch.setattr(jsim, "Simulation", _StubWorld)
    jrunner.run_point_robot_benchmark(n_trials=2, n_steps=1, seed=3)
    j_goals, j_obsts = _StubAdapter.last.goals, _StubAdapter.last.obsts
    rep = runner.run_point_robot_benchmark(n_trials=2, n_steps=3, seed=3, overrides=SMALL,
                                           device="cpu")
    assert len(rep.trials) == 2 and rep.summary()["n_trials"] == 2
    for t, g, o in zip(rep.trials, j_goals, j_obsts):
        np.testing.assert_array_equal(t.goal, g)
        np.testing.assert_array_equal(t.obstacle, o)
        assert t.steps == 3 and np.isfinite(t.solver_time_ms) and t.path_length > 0.0
    jrunner.run_panda_benchmark(n_trials=2, n_steps=1, seed=4)
    rep = runner.run_panda_benchmark(n_trials=2, n_steps=2, seed=4, overrides=SMALL, device="cpu")
    for t, g in zip(rep.trials, _StubAdapter.last.goals):
        np.testing.assert_array_equal(t.goal, g)
    assert rep.summary()["device"] == "cpu"


def test_runner_main_writes_its_results(tmp_path):
    out = tmp_path / "pr.json"
    runner.main(["point_robot", "1", "device=cpu", f"results={out}", "mppi.num_samples=8",
                 "mppi.horizon=2"])
    doc = json.loads(out.read_text())
    assert doc["summary"]["n_trials"] == 1 and len(doc["trials"]) == 1


def test_study_suggests_what_the_jax_study_suggests():
    space = {"nav": tuning.ParamSpec(0.1, 10.0), "coll": tuning.ParamSpec(0.0, 1.0, log=False)}
    jspace = {"nav": jtuning.ParamSpec(0.1, 10.0), "coll": jtuning.ParamSpec(0.0, 1.0, log=False)}
    ts, js = tuning.Study(space, seed=5, refine_after=4), jtuning.Study(jspace, seed=5,
                                                                        refine_after=4)
    for i in range(12):
        a, b = ts.suggest(), js.suggest()
        assert a.params == b.params, i
        a.value = b.value = float((a.params["nav"] - 2.0) ** 2 + a.params["coll"])
    assert ts.best.params == js.best.params


def _tuner(planner, world, goal):
    def cost(w):
        return float(torch.linalg.norm(w.state.q[0, :2].cpu() - goal))

    space = {"nav": tuning.ParamSpec(0.5, 2.0), "obstacle": tuning.ParamSpec(0.05, 0.5),
             "coll": tuning.ParamSpec(0.0, 0.2, log=False)}
    return tuning.Tuning(planner, world, space,
                         sigma_space=tuning.ParamSpec(0.1, 1.0), nu=3, n_steps=2,
                         episode_cost=cost, seed=1)


def test_tuning_in_process_and_over_rpc():
    """Two trials against the in-process planner, then the same two against
    the same kind of planner served over RPC: the same suggestions, the
    weights and Σ applied to the served planner, finite episode costs."""
    cfg = load_config("tasks/point_robot", SMALL)
    goal = torch.tensor(cfg.goal, dtype=torch.float32)
    planner = MPPIisaacPlanner(cfg, PointRobotObjective(cfg), randomize=False, device="cpu")
    local = _tuner(planner, goal_world(cfg, "cpu"), goal)
    best = local.tune(2)
    assert len(local.study.trials) == 2 and np.isfinite(best.value)
    last = local.study.trials[-1].params
    assert planner.objective.weights["nav"] == last["nav"]
    np.testing.assert_allclose(planner.mppi.carry.sigma.numpy(),
                               np.eye(3) * last["noise_sigma"], rtol=1e-6)

    served = MPPIisaacPlanner(cfg, PointRobotObjective(cfg), randomize=False, device="cpu")
    srv = Server(served).bind("tcp://127.0.0.1:0")
    srv.run_in_thread()
    client = Client().connect(f"tcp://127.0.0.1:{srv.port}")
    try:
        remote = _tuner(client, goal_world(cfg, "cpu"), goal)
        remote.tune(2)
    finally:
        client.close()
        srv.stop()
    assert [t.params for t in remote.study.trials] == [t.params for t in local.study.trials]
    assert all(np.isfinite(t.value) for t in remote.study.trials)
    assert served.objective.weights["nav"] == last["nav"]
    np.testing.assert_allclose(served.mppi.carry.sigma.numpy(),
                               np.eye(3) * last["noise_sigma"], rtol=1e-6)
