"""panda_pick task (reference `examples/panda_pick/planner.py:10-53`): the
Franka with its gripper picks a block off the table and carries it to the
goal. EE-to-block and block-to-goal distances, a table-contact penalty and
the upright EE orientation term.

Run the control loop: ``python -m mppiisaac_tpu_torch.tasks.panda_pick
[device=cuda|cpu] [mppi.num_samples=1000 ...]`` (the card by default;
``device=cpu`` runs the kernels' plain versions).
"""
from __future__ import annotations

import torch

from ..ops.fused_physics import TASK_PANDA_PICK, CostSpec
from ..planner.objective import Objective
from ..planner.observables import SimView
from .common import contact_force_mag, ee_upright_cost, fused_opt, norm, split_cli


class PandaPickObjective(Objective):
    def __init__(self, cfg=None):
        self.weights = {
            "robot_to_block": 40.0,
            "block_to_goal": 10.0,
            "collision": 26.0,
            "robot_ori": 2.0,
        }

    def compute_cost(self, view: SimView) -> torch.Tensor:
        r = view.link_state("panda_ee", "panda")
        block = view.actor_position("panda_pick_block")
        goal = view.actor_position("goal")
        table_f = contact_force_mag(view, "table")
        w = self.weights
        return (
            w["robot_to_block"] * norm(r[..., 0:3] - block)
            + w["block_to_goal"] * norm(block - goal)
            + w["collision"] * table_f
            + w["robot_ori"] * ee_upright_cost(r[..., 3:7])
        )

    def kernel_cost(self, built) -> CostSpec:
        """The same cost as the kernels' TASK_PANDA_PICK branch (the table's
        force summed over its bodies, the pitch by atan2, as the fused kernel
        computes them)."""
        scene = built.scene
        w = self.weights
        table = scene.actor_index("table")
        return CostSpec(
            task=TASK_PANDA_PICK,
            ee_body=scene.body_index("panda_ee", "panda"),
            goal_actor=scene.actor_index("goal"),
            w_dist=float(w["robot_to_block"]),
            w_ori=float(w["robot_ori"]),
            block_actor=scene.actor_index("panda_pick_block"),
            force_body0=int(scene.body_offset[table]),
            force_nbody=int(scene.actors[table].nbody),
            w_block=float(w["block_to_goal"]),
            w_force=float(w["collision"]),
        )


def success_fn(tol: float = 0.2):
    """Reached when ‖block − goal‖ < `tol` m (reference success,
    `examples/omni_panda_pick/world.py:66-75`)."""

    def success(world):
        v = world.view
        d = v.actor_position("panda_pick_block")[0] - v.actor_position("goal")[0]
        return float(torch.linalg.norm(d)) < tol

    return success


def run(overrides=None, device="cuda", **kw):
    from ..runtime.loop import run_task
    from ..utils.config_store import load_config

    cfg = load_config("tasks/panda_pick", overrides)
    return run_task(cfg, PandaPickObjective(cfg), success_fn=success_fn(), device=device, **kw)


if __name__ == "__main__":
    import sys

    rest, opts = split_cli(sys.argv[1:], {"use_fused": None, "device": "cuda"})
    print(run(rest, device=opts["device"], use_fused=fused_opt(opts["use_fused"]),
              verbose=True).summary())
