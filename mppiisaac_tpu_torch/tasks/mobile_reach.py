"""boxer_reach / heijn_reach — a mobile base drives to a goal around a wall
(reference `examples/boxer_reach/planner.py:15-24`, `examples/heijn_reach/`):
goal distance + wall contact-force penalty.

Run the control loop: ``python -m mppiisaac_tpu_torch.tasks.mobile_reach
[robot=boxer|heijn] [device=cuda|cpu] [mppi.num_samples=512 ...]`` (the
card by default; ``device=cpu`` runs the kernels' plain versions).
"""
from __future__ import annotations

import torch

from ..ops.fused_physics import TASK_MOBILE_REACH, CostSpec
from ..planner.objective import Objective
from ..planner.observables import SimView
from .common import const, contact_force_mag, fused_opt, norm, split_cli


class MobileReachObjective(Objective):
    def __init__(self, cfg, robot: str):
        self.robot = robot
        goal = getattr(cfg, "goal", None) or [2.0, 2.0]
        self.goal = torch.tensor(goal, dtype=torch.float32)[:2]
        self.weights = {"goal": 1.0, "collision": 0.1}

    def _robot_xy(self, view: SimView) -> torch.Tensor:
        if self.robot == "heijn":
            return view.actor_q("heijn")[..., :2]
        return view.actor_position(self.robot)[..., :2]

    def compute_cost(self, view: SimView) -> torch.Tensor:
        xy = self._robot_xy(view)
        dist = norm(xy - const(self, "goal", lambda: self.goal, xy))
        wall_f = contact_force_mag(view, "wall", dims=2)
        return self.weights["goal"] * dist + self.weights["collision"] * wall_f

    def kernel_cost(self, built) -> CostSpec:
        """The same cost as the kernels' TASK_MOBILE_REACH branch (heijn's
        xy from its first two dofs, the boxer's from its root)."""
        scene = built.scene
        wall = scene.actor_index("wall")
        heijn = self.robot == "heijn"
        return CostSpec(
            task=TASK_MOBILE_REACH,
            ee_body=-1,
            goal_actor=scene.actor_index("goal"),
            w_dist=float(self.weights["goal"]),
            w_ori=0.0,
            force_body0=int(scene.body_offset[wall]),
            force_nbody=int(scene.actors[wall].nbody),
            force_dims=2,
            w_force=float(self.weights["collision"]),
            xy_actor=-1 if heijn else scene.actor_index(self.robot),
            xy_dof=int(scene.dof_offset[scene.actor_index("heijn")]) if heijn else -1,
            goal_x=float(self.goal[0]),
            goal_y=float(self.goal[1]),
        )


def success_fn(robot: str, goal, tol: float = 0.15):
    """Reached when the base's xy is within `tol` m of the goal."""

    def success(world):
        if robot == "heijn":
            xy = world.view.actor_q("heijn")[0, :2]
        else:
            xy = world.view.actor_position(robot)[0, :2]
        return float(torch.linalg.norm(xy.cpu() - goal)) < tol

    return success


def run(robot="boxer", overrides=None, device="cuda", **kw):
    from ..runtime.loop import run_task
    from ..utils.config_store import load_config

    cfg = load_config(f"tasks/{robot}_reach", overrides)
    obj = MobileReachObjective(cfg, robot)
    return run_task(cfg, obj, success_fn=success_fn(robot, obj.goal), device=device, **kw)


if __name__ == "__main__":
    import sys

    rest, opts = split_cli(sys.argv[1:], {"use_fused": None, "robot": "boxer", "device": "cuda"})
    print(run(opts["robot"], rest, device=opts["device"], use_fused=fused_opt(opts["use_fused"]),
              verbose=True).summary())
