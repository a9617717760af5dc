"""Seeded episodes on one build (`runtime/loop.run_task_episodes`) on the
CPU, and the entry points of this slice:

* port of tests/test_end_to_end.py:50-72: point_robot at K=64 (H cut to 6
  to keep the CPU plain rollout short), seeds [0, 1], both within 0.2 m of
  the goal within 60 steps;
* the same seed twice on one build gives identical metrics and identical
  world states, step by step; the carry's key for seed s is JAX's
  `PRNGKey(s)` (bit for bit, and through the episode: seed s on a build of
  seed_val 0 runs as a fresh build of seed_val s);
* `run_task(real_time=True)` sleeps out each control period;
* the validate twin's pick subcommand on the CPU at a tiny K and H writes its
  summary.
"""
import json
import time

import jax
import numpy as np
import torch

from mppiisaac_tpu_torch.mppi import prng
from mppiisaac_tpu_torch.physics.types import SIM_STATE_FIELDS
from mppiisaac_tpu_torch.runtime.loop import run_task, run_task_episodes
from mppiisaac_tpu_torch.tasks.point_robot import PointRobotObjective, success_fn
from mppiisaac_tpu_torch.utils.config_store import load_config
from mppiisaac_tpu_torch import validate

torch.set_num_threads(1)


def test_point_robot_episodes_reach_goal():
    cfg = load_config("tasks/point_robot", ["mppi.num_samples=64", "mppi.horizon=6"])
    obj = PointRobotObjective(cfg)
    rs = run_task_episodes(cfg, obj, seeds=[0, 1], n_steps=60,
                           success_fn=success_fn(obj.nav_goal, tol=0.2), randomize=False,
                           device="cpu")
    assert sorted(rs) == [0, 1]
    assert all(m.success_step is not None and m.final_state_finite for m in rs.values()), {
        s: m.summary() for s, m in rs.items()}


def _recorded(cfg, seeds, n):
    """Episodes with a success test that never holds and keeps every
    post-step world state: → (metrics by seed, states per episode)."""
    states = []

    def record(world):
        states.append(world.state)
        return False

    rs = run_task_episodes(cfg, PointRobotObjective(cfg), seeds=seeds, n_steps=n,
                           success_fn=record, randomize=False, device="cpu")
    return rs, [states[i * n:(i + 1) * n] for i in range(len(seeds))]


def _equal_states(a, b):
    return all(torch.equal(getattr(x, f), getattr(y, f))
               for x, y in zip(a, b) for f in SIM_STATE_FIELDS if getattr(x, f) is not None)


def test_same_seed_twice_is_identical_and_keyed_as_jax():
    n = 8
    small = ["mppi.num_samples=16", "mppi.horizon=4"]
    cfg = load_config("tasks/point_robot", small)
    # seed 0, another seed, then seed 0 again (as the string "0": a key of
    # its own in the result, the same PRNG key)
    rs, eps = _recorded(cfg, [0, 1, "0"], n)
    a, b = rs[0].summary(), rs["0"].summary()
    for k in ("steps", "path_length", "success_step"):
        assert a[k] == b[k], k
    assert rs[0].steps == n and _equal_states(eps[0], eps[2])
    assert not _equal_states(eps[0], eps[1])
    # seed 1 on this build runs as a fresh build of seed_val 1
    _, fresh = _recorded(load_config("tasks/point_robot", small + ["mppi.seed_val=1"]), [1], n)
    assert _equal_states(eps[1], fresh[0])
    for s in (0, 1, 7, 2**31 + 5):
        assert np.array_equal(prng.prng_key(s), np.asarray(jax.random.PRNGKey(s), np.uint32)), s


def test_run_task_real_time_paces_the_control_period():
    cfg = load_config("tasks/point_robot", ["mppi.num_samples=4", "mppi.horizon=2",
                                            "isaacgym.dt=0.5"])
    # no collision: no contacts, so a long dt needs no refined substeps
    cfg.actors = [{"type": "robot", "name": "point_robot", "urdf_file": "point_robot.urdf",
                   "fixed": True, "collision": False}]
    t0 = time.perf_counter()
    m = run_task(cfg, PointRobotObjective(cfg), n_steps=2, real_time=True, device="cpu")
    elapsed = time.perf_counter() - t0
    # each step's own time is under the 0.5 s period, and both were slept out
    assert m.steps == 2 and min(m.rt_factor) > 1.0 and elapsed >= 2 * 0.5


def test_validate_pick_on_cpu(tmp_path, capsys):
    out = tmp_path / "validate.json"
    s = validate.main(["pick", "world", "2", "device=cpu", "mppi.num_samples=4",
                       "mppi.horizon=1", "n_steps=1", f"results={out}"])
    assert s["episodes"] == 2 and s["successes"] == 0 and s["all_finite"]
    assert s["success_steps"] == {0: None, 1: None} and s["device"] == "cpu"
    doc = json.loads(out.read_text())
    assert doc["panda_pick:world"]["episodes"] == 2
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert [json.loads(ln)["seed"] for ln in lines] == [0, 1]
