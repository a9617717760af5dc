"""point_robot goal reach (reference
`benchmarks/point_robot/mppi_planner/mppi_planner_wrapper.py:16-33`): the nav
distance, an inverse-distance potential of each obstacle and the robot's
contact force.

Run the control loop: ``python -m mppiisaac_tpu_torch.tasks.point_robot
[device=cuda|cpu] [mppi.num_samples=100 ...]`` (the card by default;
``device=cpu`` runs the kernels' plain versions).
"""
from __future__ import annotations

import torch

from ..ops.fused_physics import TASK_POINT_ROBOT, CostSpec
from ..planner.objective import Objective
from ..planner.observables import SimView
from .common import const, fused_opt, split_cli


class PointRobotObjective(Objective):
    def __init__(self, cfg, obstacle_names=()):
        goal = cfg.goal if getattr(cfg, "goal", None) is not None else [2.0, 2.0]
        self.nav_goal = torch.tensor(goal, dtype=torch.float32)[:2]
        self.obstacle_names = list(obstacle_names)
        self.weights = {"nav": 1.0, "obstacle": 0.1, "coll": 0.0}

    def compute_cost(self, view: SimView) -> torch.Tensor:
        pos = view.actor_q("point_robot")[..., :2]
        nav = torch.linalg.norm(pos - const(self, "nav_goal", lambda: self.nav_goal, pos), dim=-1)
        obstacle = torch.zeros_like(nav)
        for name in self.obstacle_names:
            d = torch.linalg.norm(pos - view.actor_position(name)[..., :2], dim=-1)
            obstacle = obstacle + 1.0 / torch.clamp(d, min=1e-3)
        coll = torch.linalg.norm(view.actor_contact_forces("point_robot"), dim=-1).sum(-1)
        w = self.weights
        return w["nav"] * nav + w["obstacle"] * obstacle + w["coll"] * coll

    def kernel_cost(self, built) -> CostSpec:
        """The kernels' TASK_POINT_ROBOT branch: the robot's xy from its first
        two dofs, each obstacle's from its root, the collision term as
        |F_x| + |F_y| + |F_z| of the robot's summed net contact force."""
        scene = built.scene
        robot = scene.actor_index("point_robot")
        if len(self.obstacle_names) > 4:
            raise ValueError("the kernels' point-robot cost takes at most 4 obstacles")
        w = self.weights
        return CostSpec(
            task=TASK_POINT_ROBOT, ee_body=-1, goal_actor=-1,
            w_dist=float(w["nav"]), w_ori=0.0,
            xy_dof=int(scene.dof_offset[robot]),
            goal_x=float(self.nav_goal[0]), goal_y=float(self.nav_goal[1]),
            xy_actors=tuple(scene.actor_index(n) for n in self.obstacle_names),
            w_pair=float(w["obstacle"]),
            force_body0=int(scene.body_offset[robot]), force_nbody=int(scene.actors[robot].nbody),
            w_force=float(w["coll"]),
        )


def success_fn(goal, tol: float = 0.1):
    """Reached when the robot's xy is within `tol` m of the goal."""

    def success(world):
        q = world.state.q[0, :2].cpu()
        return float(torch.linalg.norm(q - goal)) < tol

    return success


def make_config(overrides=None):
    """conf/tasks/point_robot with CLI-style overrides."""
    from ..utils.config_store import load_config

    return load_config("tasks/point_robot", overrides)


def run(overrides=None, device="cuda", **kw):
    from ..runtime.loop import run_task

    cfg = make_config(overrides)
    obj = PointRobotObjective(cfg)
    return run_task(cfg, obj, success_fn=success_fn(obj.nav_goal), device=device, **kw)


if __name__ == "__main__":
    import sys

    rest, opts = split_cli(sys.argv[1:], {"use_fused": None, "device": "cuda"})
    print(run(rest, device=opts["device"], use_fused=fused_opt(opts["use_fused"]),
              verbose=True).summary())
