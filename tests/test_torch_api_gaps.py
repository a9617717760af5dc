"""The public names the port took from the JAX package last, each against
its JAX counterpart on the same inputs:

* `MPPIPlanner.command(state0)`: the stateful command (the carry advanced,
  `last_info` kept, `action[0]` when u_per_command is 1), through the same
  cost stub as tests/test_torch_solver.py, its noise drawn from the same
  keys (`mppi.prng` is JAX's threefry bit for bit);
* `Simulation(viewer=)`, `ModelParams.default`, `scene/assets.load_urdf_file`
  (the panda gripper asset with its meshes fitted);
* `tasks/common.run_objective_task`, `tasks/point_robot.make_config` and
  `tasks/multi_robot.run_jackal`: the config, objective and success test
  each hands to `run_task`, captured in both packages, and one short episode
  of the port on the CPU;
* `validate.py one <task>`, and the suite's per-task error capture with a
  task stubbed to raise.
"""
import json
import os

import numpy as np
import pytest
import torch

from mppiisaac_tpu.mppi.solver import MPPIPlanner as JPlanner
from mppiisaac_tpu.utils.config_store import load_config as j_load
from mppiisaac_tpu_torch import validate
from mppiisaac_tpu_torch.mppi.solver import MPPIPlanner as TPlanner
from mppiisaac_tpu_torch.utils.config_store import load_config as t_load
from test_torch_solver import _JStub, _TStub

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


@pytest.mark.parametrize("task,overrides", [("point_robot", []),
                                            ("panda", ["mppi.u_per_command=2"])])
def test_command_is_the_jax_stateful_command(task, overrides):
    jc, tc = j_load(f"tasks/{task}", overrides), t_load(f"tasks/{task}", overrides)
    jp = JPlanner(jc.mppi, jc.nx, dynamics=None, running_cost=None, fused=_JStub())
    tp = TPlanner(tc.mppi, tc.nx, fused=_TStub(), device="cpu")
    for _ in range(3):
        a_j, a_t = jp.command((None, None)), tp.command((None, None))
        assert tuple(a_t.shape) == tuple(a_j.shape)
        np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tp.carry.U.numpy(), np.asarray(jp.carry.U), rtol=TOL, atol=TOL)
        assert int(tp.carry.t0) == int(jp.carry.t0)
        np.testing.assert_allclose(tp.last_info["costs"].numpy(), np.asarray(jp.last_info["costs"]),
                                   rtol=TOL, atol=TOL)
    assert a_t.dim() == (2 if tc.mppi.u_per_command > 1 else 1)


def test_simulation_viewer_and_default_params():
    from mppiisaac_tpu.physics.types import ModelParams as JParams
    from mppiisaac_tpu.runtime.sim import Simulation as JSim
    from mppiisaac_tpu_torch.physics.types import ModelParams as TParams
    from mppiisaac_tpu_torch.runtime.sim import Simulation as TSim

    jc, tc = j_load("tasks/point_robot"), t_load("tasks/point_robot")
    js = JSim(jc.isaacgym, jc.actors, jc.initial_actor_positions, viewer=True)
    ts = TSim(tc.isaacgym, tc.actors, tc.initial_actor_positions, viewer=True, device="cpu")
    assert js.cfg.viewer is True and ts.cfg.viewer is True
    plain = TSim(t_load("tasks/point_robot").isaacgym, tc.actors, tc.initial_actor_positions,
                 device="cpu")
    assert plain.cfg.viewer is False
    np.testing.assert_allclose(ts.state.q.numpy(), np.asarray(js.state.q), atol=1e-6)
    fric = np.linspace(0.5, 1.5, 5).astype(np.float32)
    jp, tp = JParams.default(4, 5, fric), TParams.default(4, 5, fric, device="cpu")
    for f in ("body_mass_scale", "geom_friction"):
        j, t = np.asarray(getattr(jp, f)), getattr(tp, f)
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), j)


def test_load_urdf_file_matches_jax():
    from mppiisaac_tpu.scene.assets import load_urdf_file as j_load_urdf
    from mppiisaac_tpu_torch.scene.assets import load_urdf_file as t_load_urdf

    path = os.path.join(REPO, "assets", "urdf", "franka_panda_gripper.urdf")
    j, t = j_load_urdf(path), t_load_urdf(path)
    assert [x.name for x in t.joints] == [x.name for x in j.joints]
    assert sorted(t.links) == sorted(j.links)
    for name, jl in j.links.items():
        tl = t.links[name]
        assert abs(tl.mass - jl.mass) < 1e-6, name
        assert len(tl.geoms) == len(jl.geoms), name
        for tg, jg in zip(tl.geoms, jl.geoms):
            assert tg.gtype == jg.gtype, name
            for f in ("size", "pos", "quat"):
                np.testing.assert_allclose(getattr(tg, f), getattr(jg, f), atol=1e-6, err_msg=name)


def _captured(monkeypatch, module):
    """Replace `module.run_task` by a recorder; → the list it appends to."""
    seen = []
    monkeypatch.setattr(module, "run_task",
                        lambda cfg, obj, **kw: seen.append((cfg, obj, kw)) or "metrics")
    return seen


def test_task_helpers_hand_run_task_what_jax_hands_it(monkeypatch):
    import mppiisaac_tpu.runtime.loop as jloop
    import mppiisaac_tpu_torch.runtime.loop as tloop
    from mppiisaac_tpu.tasks import common as jcommon
    from mppiisaac_tpu.tasks import multi_robot as jmulti
    from mppiisaac_tpu.tasks import point_robot as jpoint
    from mppiisaac_tpu_torch.tasks import common as tcommon
    from mppiisaac_tpu_torch.tasks import multi_robot as tmulti
    from mppiisaac_tpu_torch.tasks import point_robot as tpoint

    over = ["mppi.num_samples=8", "mppi.horizon=3"]
    jc, tc = jpoint.make_config(over), tpoint.make_config(over)
    for f in ("n_steps", "nx", "actors", "initial_actor_positions", "goal"):
        assert getattr(tc, f) == getattr(jc, f), f
    assert (tc.mppi.num_samples, tc.mppi.horizon) == (jc.mppi.num_samples, jc.mppi.horizon) == (8, 3)

    js, ts = _captured(monkeypatch, jloop), _captured(monkeypatch, tloop)
    assert jcommon.run_objective_task("point_robot", jpoint.PointRobotObjective, over,
                                      n_steps=2) == "metrics"
    assert tcommon.run_objective_task("point_robot", tpoint.PointRobotObjective, over,
                                      n_steps=2, device="cpu") == "metrics"
    (jcfg, jobj, jkw), (tcfg, tobj, tkw) = js[-1], ts[-1]
    assert type(tobj).__name__ == type(jobj).__name__ and tcfg.goal == jcfg.goal
    np.testing.assert_allclose(tobj.nav_goal.numpy(), np.asarray(jobj.nav_goal))
    assert tkw["n_steps"] == jkw["n_steps"] == 2 and tkw["success_fn"] is None

    assert jmulti.run_jackal(over, device_steps=16) == tmulti.run_jackal(over, device_steps=16)
    (jcfg, jobj, jkw), (tcfg, tobj, tkw) = js[-1], ts[-1]
    assert type(tobj).__name__ == type(jobj).__name__ == "MultiJackalObjective"
    assert tcfg.actors == jcfg.actors and tcfg.mppi.num_samples == jcfg.mppi.num_samples == 8
    for g_t, g_j in zip(tobj.goals, jobj.goals):
        np.testing.assert_allclose(g_t, g_j)
    assert tkw["device_steps"] == jkw["device_steps"] == 16
    assert tkw["success_fn"] is not None and jkw["success_fn"] is not None


def test_run_objective_task_runs_an_episode_on_the_cpu():
    from mppiisaac_tpu_torch.tasks.common import run_objective_task
    from mppiisaac_tpu_torch.tasks.point_robot import PointRobotObjective

    m = run_objective_task("point_robot", PointRobotObjective,
                           ["mppi.num_samples=8", "mppi.horizon=3"], n_steps=2, device="cpu")
    assert m.steps == 2 and m.final_state_finite


def test_validate_one_on_cpu(tmp_path, capsys):
    out = tmp_path / "validate.json"
    s = validate.main(["one", "point_robot", "device=cpu", "mppi.num_samples=4",
                       "mppi.horizon=2", "n_steps=2", "device_steps=2", f"results={out}"])
    # the JAX validator's `one` keys, and the port's
    assert {"task", "overrides", "success_step", "steps", "finite", "wall_s"} <= set(s)
    assert s["task"] == "point_robot" and s["steps"] == 2 and s["finite"]
    doc = json.loads(out.read_text())
    key = "one:point_robot:mppi.num_samples=4,mppi.horizon=2"
    assert doc[key]["steps"] == 2 and doc[key]["device"] == "cpu"
    assert "ONE " in capsys.readouterr().out
    with pytest.raises(ModuleNotFoundError):
        validate.main(["one", "no_such_task", "device=cpu", f"results={out}"])


class _Metrics:
    success_step, steps, final_state_finite, fps = 3, 4, True, [50.0]


def test_suite_records_a_task_that_raises_and_fails(tmp_path, capsys, monkeypatch):
    ran = []

    def ok(name):
        def run(overrides=None, device=None, device_steps=None, use_fused=None, **kw):
            ran.append(name)
            return _Metrics()
        return run

    def broken(overrides=None, **kw):
        ran.append("broken")
        raise ValueError("stubbed task failure")

    monkeypatch.setattr(validate, "suite_plan",
                        lambda: [("a", ok("a"), {}), ("broken", broken, {}), ("b", ok("b"), {})])
    out = tmp_path / "validate.json"
    with pytest.raises(RuntimeError, match="1 of 3 tasks raised"):
        validate.main(["suite", "device=cpu", f"results={out}"])
    assert ran == ["a", "broken", "b"]
    doc = json.loads(out.read_text())["suite"]
    assert "stubbed task failure" in doc["broken"]["error"]
    assert doc["a"]["success_step"] == 3 and doc["b"]["success_step"] == 3
    text = capsys.readouterr().out
    assert "SUCCESS 2/3" in text and 'TASK broken: {"error"' in text
