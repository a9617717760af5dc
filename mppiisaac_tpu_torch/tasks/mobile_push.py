"""boxer_push / heijn_push — non-prehensile pushing of a block to a goal
(reference `examples/heijn_push/planner.py:26-67`, `examples/boxer_push/`):
robot→block + block→goal + block yaw + push-align cosine + obstacle contact
force + block velocity.

Run the control loop: ``python -m mppiisaac_tpu_torch.tasks.mobile_push
[robot=boxer|heijn] [device=cuda|cpu] [mppi.num_samples=400 ...]`` (the
card by default; ``device=cpu`` runs the kernels' plain versions).
"""
from __future__ import annotations

import torch

from ..ops.fused_physics import TASK_MOBILE_PUSH, CostSpec
from ..planner.objective import Objective
from ..planner.observables import SimView
from .common import const, contact_force_mag, fused_opt, norm, push_align_cost, split_cli, yaw_of

EE_LINK = {"boxer": "ee_link", "heijn": "front_link"}


class MobilePushObjective(Objective):
    def __init__(self, cfg, robot: str, ee_link: str):
        self.robot = robot
        self.ee_link = ee_link
        goal = getattr(cfg, "goal", None) or [2.0, 2.0]
        self.goal = torch.tensor(goal, dtype=torch.float32)[:2]
        self.goal_yaw = 0.0
        if robot == "boxer":
            # the reference weights (`examples/boxer_push/planner.py:12-19`)
            self.weights = {
                "robot_to_block": 0.1,
                "block_to_goal": 2.0,
                "block_to_goal_ort": 3.0,
                "push_align": 0.6,
                "collision": 100.0,
                "velocity": 0.0,
            }
        else:
            self.weights = {
                "robot_to_block": 0.2,
                "block_to_goal": 2.0,
                "block_to_goal_ort": 3.0,
                "push_align": 0.6,
                "collision": 10.0,
                "velocity": 0.0,
            }

    def compute_cost(self, view: SimView) -> torch.Tensor:
        r_pos = view.link_position(self.ee_link, self.robot)[..., :2]
        block = view.actor_position("block")
        block_vel = view.actor_linvel("block")
        block_yaw = yaw_of(view.actor_orientation("block"))
        robot_to_block = r_pos - block[..., :2]
        block_to_goal = const(self, "goal", lambda: self.goal, block) - block[..., :2]
        coll = contact_force_mag(view, "obst1", dims=2) + contact_force_mag(view, "obst2", dims=2)
        w = self.weights
        return (
            w["robot_to_block"] * norm(robot_to_block)
            + w["block_to_goal"] * norm(block_to_goal)
            + w["block_to_goal_ort"] * torch.abs(block_yaw - self.goal_yaw)
            + w["push_align"] * push_align_cost(robot_to_block, block_to_goal)
            + w["collision"] * coll
            + w["velocity"] * norm(block_vel[..., :2])
        )

    def kernel_cost(self, built) -> CostSpec:
        """The same cost as the kernels' TASK_MOBILE_PUSH branch (each
        obstacle's force summed over its bodies, the yaw by atan2)."""
        scene = built.scene
        w = self.weights
        o1, o2 = scene.actor_index("obst1"), scene.actor_index("obst2")
        return CostSpec(
            task=TASK_MOBILE_PUSH,
            ee_body=scene.body_index(self.ee_link, self.robot),
            goal_actor=scene.actor_index("goal"),
            w_dist=float(w["robot_to_block"]),
            w_ori=float(w["block_to_goal_ort"]),
            block_actor=scene.actor_index("block"),
            force_body0=int(scene.body_offset[o1]),
            force_nbody=int(scene.actors[o1].nbody),
            force2_body0=int(scene.body_offset[o2]),
            force2_nbody=int(scene.actors[o2].nbody),
            force_dims=2,
            w_block=float(w["block_to_goal"]),
            w_force=float(w["collision"]),
            w_align=float(w["push_align"]),
            w_vel=float(w["velocity"]),
            goal_x=float(self.goal[0]),
            goal_y=float(self.goal[1]),
            goal_yaw=float(self.goal_yaw),
        )


def success_fn(goal, tol: float = 0.2):
    """Reached when ‖block_xy − goal‖ < `tol` m."""

    def success(world):
        block = world.view.actor_position("block")[0, :2]
        return float(torch.linalg.norm(block.cpu() - goal)) < tol

    return success


def run(robot="heijn", overrides=None, device="cuda", **kw):
    from ..runtime.loop import run_task
    from ..utils.config_store import load_config

    cfg = load_config(f"tasks/{robot}_push", overrides)
    obj = MobilePushObjective(cfg, robot, EE_LINK[robot])
    return run_task(cfg, obj, success_fn=success_fn(obj.goal), device=device, **kw)


if __name__ == "__main__":
    import sys

    rest, opts = split_cli(sys.argv[1:], {"use_fused": None, "robot": "heijn",
                                           "device": "cuda"})
    print(run(opts["robot"], rest, device=opts["device"], use_fused=fused_opt(opts["use_fused"]),
              verbose=True).summary())
