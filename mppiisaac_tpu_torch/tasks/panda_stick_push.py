"""panda_stick_push (reference `examples/panda_stick_push/planner.py:10-69`):
the Franka with a rigid stick pushes a block across a table toward a goal
marker. EE-to-block and block-to-goal distances (3-D), the table's contact
force, the upright EE orientation, |EE_z − block_z| and the push-align
cosine, at the reference weights.

Run the control loop: ``python -m mppiisaac_tpu_torch.tasks.panda_stick_push
[device=cuda|cpu] [mppi.num_samples=1000 ...]`` (the card by default;
``device=cpu`` runs the kernels' plain versions).
"""
from __future__ import annotations

import torch

from ..ops.fused_physics import TASK_STICK_PUSH, CostSpec
from ..planner.objective import Objective
from ..planner.observables import SimView
from .common import (contact_force_mag, ee_upright_cost, fused_opt, norm, push_align_cost,
                     split_cli)


class PandaStickPushObjective(Objective):
    def __init__(self, cfg=None):
        # the reference weights (`examples/panda_stick_push/planner.py:12-19`)
        self.weights = {
            "robot_to_block": 5.0,
            "block_to_goal": 25.0,
            "collision": 0.0,
            "robot_ori": 5.0,
            "block_height": 20.0,
            "push_align": 45.0,
        }

    def compute_cost(self, view: SimView) -> torch.Tensor:
        ee = view.link_position("panda_ee_tip", "panda")
        ee_q = view.link_state("panda_ee_tip", "panda")[..., 3:7]
        block = view.actor_position("panda_push_block")
        goal = view.actor_position("goal")
        robot_to_block, block_to_goal = ee - block, goal - block
        w = self.weights
        return (
            w["robot_to_block"] * norm(robot_to_block)
            + w["block_to_goal"] * norm(block_to_goal)
            + w["collision"] * contact_force_mag(view, "table")
            + w["robot_ori"] * ee_upright_cost(ee_q)
            + w["block_height"] * torch.abs(ee[..., 2] - block[..., 2])
            + w["push_align"] * push_align_cost(robot_to_block[..., :2], block_to_goal[..., :2])
        )

    def kernel_cost(self, built) -> CostSpec:
        """The kernels' TASK_STICK_PUSH branch (the table's force summed over
        its bodies, the pitch by atan2)."""
        scene = built.scene
        w = self.weights
        table = scene.actor_index("table")
        return CostSpec(
            task=TASK_STICK_PUSH,
            ee_body=scene.body_index("panda_ee_tip", "panda"),
            goal_actor=scene.actor_index("goal"),
            w_dist=float(w["robot_to_block"]), w_ori=float(w["robot_ori"]),
            block_actor=scene.actor_index("panda_push_block"),
            force_body0=int(scene.body_offset[table]), force_nbody=int(scene.actors[table].nbody),
            w_block=float(w["block_to_goal"]), w_force=float(w["collision"]),
            w_height=float(w["block_height"]), w_align=float(w["push_align"]),
        )


def success_fn(tol: float = 0.4):
    """Reached when ‖block_xy − goal_xy‖ < `tol` m. The reference task has no
    success test, and its goal marker lies beyond the fixed arm's reach (the
    stick tip gets no closer than 0.344 m in xy), so the block can get no
    closer than ~0.3 m: the JAX package gates at 0.4 m."""

    def success(world):
        v = world.view
        d = v.actor_position("panda_push_block")[0, :2] - v.actor_position("goal")[0, :2]
        return float(torch.linalg.norm(d)) < tol

    return success


def run(overrides=None, device="cuda", **kw):
    from ..runtime.loop import run_task
    from ..utils.config_store import load_config

    cfg = load_config("tasks/panda_stick_push", overrides)
    return run_task(cfg, PandaStickPushObjective(cfg), success_fn=success_fn(), device=device, **kw)


if __name__ == "__main__":
    import sys

    rest, opts = split_cli(sys.argv[1:], {"use_fused": None, "device": "cuda"})
    print(run(rest, device=opts["device"], use_fused=fused_opt(opts["use_fused"]),
              verbose=True).summary())
