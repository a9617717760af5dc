"""Benchmark harness (parity with the JAX package's `benchmarks/runner.py`):
the reference's `plannerbenchmark` trials on the port's planner.

* a planner adapter with the external-planner interface (`setGoal`,
  `computeAction(q, qdot, obst)`, `reset`);
* N randomized trials (goal and obstacle positions from a numpy
  RandomState, the same draws as the JAX runner's for the same seed);
* metrics: time2Goal, solverTime, pathLength, invClearance;
* a JSON series per trial and a summary.

    python -m mppiisaac_tpu_torch.benchmarks.runner [point_robot|panda] [n_trials] \\
        [device=cuda|cpu] [results=PATH] [key=value ...]

The results go to `chiprun_out/<benchmark>.json` at the repo root unless
`results=` names another path; any other key=value is a config override.
"""
from __future__ import annotations

import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from ..planner.mppi_isaac import MPPIisaacPlanner
from ..runtime.sim import Simulation
from ..utils.config_store import ExampleConfig, load_config

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class PlannerAdapter:
    """External-planner interface (the reference's `MPPIPlanner(Planner)`
    adapter): one planner, rebuilt never; a new goal re-packs the objective
    into the same rollout and moves the goal marker of the rollout scene."""

    def __init__(self, cfg: ExampleConfig, objective_factory: Callable, **planner_kw):
        self.cfg = cfg
        self._objective_factory = objective_factory
        self._planner_kw = planner_kw
        self.planner: Optional[MPPIisaacPlanner] = None
        self.goal = None

    def reset(self):
        if self.planner is not None:
            self.planner.mppi.reset()

    def setGoal(self, goal):
        """Build the planner against a goal position (or give the built one
        the new goal)."""
        self.goal = np.asarray(goal, dtype=np.float64)
        self.cfg.goal = list(map(float, self.goal))
        objective = self._objective_factory(self.cfg)
        if self.planner is None:
            self.planner = MPPIisaacPlanner(self.cfg, objective, **self._planner_kw)
        else:
            self.planner.update_objective(objective)
        # a renamed goal actor must fail loudly, not pass with the marker
        # never moved
        scene = self.planner.sim.scene
        if "goal" in scene.actor_names:
            gpos = np.zeros(3)
            gpos[: len(self.goal)] = self.goal
            self.planner.sim.set_actor_position_by_name("goal", gpos)
        elif any("goal" in n for n in scene.actor_names):
            raise KeyError(
                f"goal marker actor not found by exact name 'goal'; scene has "
                f"{scene.actor_names} — rename the marker or update the adapter"
            )

    def computeAction(self, q, qdot, obst=None):
        return self.planner.compute_action(q, qdot, obst=obst)


@dataclass
class TrialResult:
    success: bool
    time2goal: Optional[float]
    solver_time_ms: float
    path_length: float
    inv_clearance: float
    steps: int
    goal: Optional[List[float]] = None
    obstacle: Optional[List[float]] = None


@dataclass
class BenchmarkReport:
    trials: List[TrialResult] = field(default_factory=list)
    device: str = ""

    def summary(self) -> dict:
        ok = [t for t in self.trials if t.success]

        def mean(xs):
            return float(np.mean(xs)) if xs else None

        return {
            "n_trials": len(self.trials),
            "success_rate": len(ok) / max(len(self.trials), 1),
            "time2Goal": mean([t.time2goal for t in ok]),
            "solverTime_ms": mean([t.solver_time_ms for t in self.trials]),
            "pathLength": mean([t.path_length for t in ok]),
            "invClearance": mean([t.inv_clearance for t in self.trials]),
            "device": self.device,
        }

    def save(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"trials": [t.__dict__ for t in self.trials], "summary": self.summary()},
                      f, indent=2)


def _device_name(device) -> str:
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def run_point_robot_benchmark(
    n_trials: int = 10,
    n_steps: int = 120,
    seed: int = 0,
    overrides: Optional[List[str]] = None,
    goal_radius: float = 0.15,
    device="cuda",
) -> BenchmarkReport:
    """The reference's point_robot experiment: randomized goals and one
    obstacle, the direct `compute_action(q, qdot, obst)` loop (no RPC),
    success = reach."""
    from ..tasks.point_robot import PointRobotObjective

    rng = np.random.RandomState(seed)
    report = BenchmarkReport(device=_device_name(device))
    cfg = load_config("tasks/point_robot", list(overrides or []))
    cfg.actors = ["point_robot", "paper_obst1", "goal"]
    adapter = PlannerAdapter(cfg, lambda c: PointRobotObjective(c, obstacle_names=["obst1"]),
                             randomize=False, device=device)
    dt = cfg.isaacgym.dt

    for _ in range(n_trials):
        goal = rng.uniform(1.2, 2.5, size=2) * rng.choice([-1, 1], size=2)
        obst_pos = goal * rng.uniform(0.3, 0.6)      # the obstacle between start and goal
        adapter.setGoal(goal)
        adapter.reset()
        q, qdot = np.zeros(3), np.zeros(3)
        obst = [(np.array([obst_pos[0], obst_pos[1], 0.15]), np.zeros(3))]
        world = Simulation(cfg.isaacgym, cfg.actors, num_envs=1, device=device)
        world.update_root_state_by_obstacles(obst)

        path_len, min_clear, solver_times, success_step = 0.0, np.inf, [], None
        for step in range(n_steps):
            t0 = time.perf_counter()
            action = adapter.computeAction(q, qdot, obst=obst)
            solver_times.append(time.perf_counter() - t0)
            world.apply_robot_cmd(np.asarray(action))
            world.step()
            new_q = world.state.q[0].cpu().numpy()[:3]
            path_len += float(np.linalg.norm(new_q[:2] - q[:2]))
            q, qdot = new_q, world.state.qd[0].cpu().numpy()[:3]
            min_clear = min(min_clear, float(np.linalg.norm(q[:2] - obst_pos)) - 0.15)
            if np.linalg.norm(q[:2] - goal) < goal_radius:
                success_step = step
                break
        report.trials.append(TrialResult(
            success=success_step is not None,
            time2goal=None if success_step is None else success_step * dt,
            solver_time_ms=float(np.mean(solver_times) * 1e3),
            path_length=path_len,
            inv_clearance=float(1.0 / max(min_clear, 1e-3)),
            steps=step + 1,
            goal=[float(g) for g in goal],
            obstacle=[float(o) for o in obst_pos],
        ))
    return report


def run_panda_benchmark(
    n_trials: int = 5,
    n_steps: int = 150,
    seed: int = 0,
    overrides: Optional[List[str]] = None,
    goal_radius: float = 0.12,
    device="cuda",
) -> BenchmarkReport:
    """The panda_arm reach benchmark: randomized reachable end-effector
    goals, metrics as in the point_robot experiment."""
    from ..tasks.panda_reach import PandaReachObjective

    rng = np.random.RandomState(seed)
    report = BenchmarkReport(device=_device_name(device))
    cfg = load_config("tasks/panda", list(overrides or []))
    adapter = PlannerAdapter(cfg, lambda c: PandaReachObjective(c, ee_link="panda_ee_tip"),
                             randomize=False, device=device)
    dt = cfg.isaacgym.dt

    for _ in range(n_trials):
        r = rng.uniform(0.35, 0.6)
        th = rng.uniform(-1.2, 1.2)
        goal = np.array([r * np.cos(th), r * np.sin(th), rng.uniform(0.25, 0.7)])
        adapter.setGoal(goal)
        adapter.reset()
        world = Simulation(cfg.isaacgym, cfg.actors, cfg.initial_actor_positions, num_envs=1,
                           device=device)
        world.set_actor_position_by_name("goal", goal)

        solver_times, path_len, prev_ee, success_step = [], 0.0, None, None
        for step in range(n_steps):
            t0 = time.perf_counter()
            action = adapter.planner.compute_action_from_state(world.state)
            solver_times.append(time.perf_counter() - t0)
            world.apply_robot_cmd(action)
            world.step()
            ee = world.view.link_position("panda_ee_tip", "panda")[0].cpu().numpy()
            if prev_ee is not None:
                path_len += float(np.linalg.norm(ee - prev_ee))
            prev_ee = ee
            if np.linalg.norm(ee - goal) < goal_radius:
                success_step = step
                break
        report.trials.append(TrialResult(
            success=success_step is not None,
            time2goal=None if success_step is None else success_step * dt,
            solver_time_ms=float(np.mean(solver_times) * 1e3),
            path_length=path_len,
            inv_clearance=0.0,
            steps=step + 1,
            goal=[float(g) for g in goal],
        ))
    return report


BENCHMARKS = {"point_robot": run_point_robot_benchmark, "panda": run_panda_benchmark}


def main(argv=None, device="cuda"):
    from ..tasks.common import split_cli

    argv = list(sys.argv[1:] if argv is None else argv)
    positional = [a for a in argv if "=" not in a]
    name = positional[0] if positional else "point_robot"
    if name not in BENCHMARKS:
        raise SystemExit(f"usage: python -m mppiisaac_tpu_torch.benchmarks.runner "
                         f"{{{'|'.join(BENCHMARKS)}}} [n_trials] [key=value ...]")
    overrides, opts = split_cli([a for a in argv if "=" in a],
                                {"device": device, "results": None})
    kw = {} if len(positional) < 2 else {"n_trials": int(positional[1])}
    rep = BENCHMARKS[name](overrides=overrides, device=opts["device"], **kw)
    rep.save(opts["results"] or os.path.join(REPO, "chiprun_out", f"{name}.json"))
    print(json.dumps(rep.summary(), indent=2))
    return rep


if __name__ == "__main__":
    main()
