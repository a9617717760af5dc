"""albert — whole-body mobile manipulation: a diff-drive base with a 7-dof
arm drives its end effector to a goal (reference
`examples/albert/planner.py:21-39`): EE-to-goal distance + an upright term.

Run the control loop: ``python -m mppiisaac_tpu_torch.tasks.albert
[device=cuda|cpu] [mppi.num_samples=500 ...]`` (the card by default;
``device=cpu`` runs the kernels' plain versions). Its URDF gives every
collision element as an OBJ mesh, fit to spheres, capsules and boxes
(scene/assets.py).
"""
from __future__ import annotations

import torch

from ..ops.fused_physics import TASK_ALBERT, CostSpec
from ..physics.math3d import quat_to_euler_zyx
from ..planner.objective import Objective
from ..planner.observables import SimView
from .common import fused_opt, norm, split_cli

EE_LINK = "mmrobot_link7"


class AlbertObjective(Objective):
    def __init__(self, cfg=None):
        self.weights = {"robot_to_goal": 1.0, "robot_ori": 0.3}

    def compute_cost(self, view: SimView) -> torch.Tensor:
        r = view.link_state(EE_LINK, "albert")
        goal = view.actor_position("goal")
        # upright = roll and pitch only: the EE's yaw turns with the base
        roll, pitch, _ = quat_to_euler_zyx(r[..., 3:7])
        ori = torch.sqrt(roll * roll + pitch * pitch + 1e-12)
        return self.weights["robot_to_goal"] * norm(r[..., 0:3] - goal) + self.weights["robot_ori"] * ori

    def kernel_cost(self, built) -> CostSpec:
        """The kernels' TASK_ALBERT branch (its pitch by atan2, as the fused
        kernel computes it)."""
        scene = built.scene
        return CostSpec(
            task=TASK_ALBERT,
            ee_body=scene.body_index(EE_LINK, "albert"),
            goal_actor=scene.actor_index("goal"),
            w_dist=float(self.weights["robot_to_goal"]),
            w_ori=float(self.weights["robot_ori"]),
        )


def success_fn(tol: float = 0.15):
    """Reached when the EE is within `tol` m of the goal marker."""

    def success(world):
        v = world.view
        d = v.link_position(EE_LINK, "albert")[0] - v.actor_position("goal")[0]
        return float(torch.linalg.norm(d)) < tol

    return success


def run(overrides=None, device="cuda", **kw):
    from ..runtime.loop import run_task
    from ..utils.config_store import load_config

    cfg = load_config("tasks/albert", overrides)
    return run_task(cfg, AlbertObjective(cfg), success_fn=success_fn(), device=device, **kw)


if __name__ == "__main__":
    import sys

    rest, opts = split_cli(sys.argv[1:], {"use_fused": None, "device": "cuda"})
    print(run(rest, device=opts["device"], use_fused=fused_opt(opts["use_fused"]),
              verbose=True).summary())
