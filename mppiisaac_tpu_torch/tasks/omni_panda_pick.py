"""omni_panda_pick (reference `examples/omni_panda_pick/planner.py:31-89`):
a Franka on a holonomic base (12 dofs, effort drives) picks a block. Nine
terms: EE-to-block, block-to-goal, the table's contact force, the upright
EE orientation, base and arm velocity penalties, a comfortable arm pose and
gripper state, and a floor under the EE height.

Run the control loop: ``python -m mppiisaac_tpu_torch.tasks.omni_panda_pick
[device=cuda|cpu] [mppi.num_samples=750 ...]`` (the card by default;
``device=cpu`` runs the kernels' plain versions).
"""
from __future__ import annotations

import torch

from ..ops.fused_physics import TASK_OMNI_PICK, CostSpec
from ..planner.objective import Objective
from ..planner.observables import SimView
from .common import const, contact_force_mag, ee_upright_cost, fused_opt, norm, split_cli

COMFY_ARM_POSE = (-1.57, -0.94, 0.0, -2.8, 0.0, 1.8675, 0.75)
COMFY_GRIPPER_STATE = (0.025, 0.025)
HEIGHT_FLOOR = 0.12


class OmniPandaPickObjective(Objective):
    def __init__(self, cfg=None):
        # the reference weights and targets
        # (`examples/omni_panda_pick/planner.py:12-25`)
        self.weights = {
            "robot_to_block": 10.0,
            "block_to_goal": 4.0,
            "collision": 0.1,
            "robot_ori": 1.0,
            "base_vel": 2.0,
            "arm_vel": 0.1,
            "comfy_arm_pose": 0.1,
            "comfy_gripper_state": 200.0,
            "height_cost": 10000.0,
        }

    def compute_cost(self, view: SimView) -> torch.Tensor:
        r = view.link_state("panda_hand", "omnipanda")
        block = view.actor_position("block")
        goal = view.actor_position("goal")
        q = view.actor_q("omnipanda")
        qd = view.actor_qd("omnipanda")
        arm = const(self, "arm", lambda: COMFY_ARM_POSE, q)
        grip = const(self, "grip", lambda: COMFY_GRIPPER_STATE, q)
        w = self.weights
        return (
            w["robot_to_block"] * norm(r[..., 0:3] - block)
            + w["block_to_goal"] * norm(block - goal)
            + w["collision"] * contact_force_mag(view, "table")
            + w["robot_ori"] * ee_upright_cost(r[..., 3:7])
            + w["base_vel"] * torch.sum(qd[..., 0:3] ** 2, dim=-1)
            + w["arm_vel"] * torch.sum(qd[..., 3:10] ** 2, dim=-1)
            + w["comfy_arm_pose"] * torch.sum((q[..., 3:10] - arm) ** 2, dim=-1)
            + w["comfy_gripper_state"] * torch.sum((q[..., -2:] - grip) ** 2, dim=-1)
            + w["height_cost"] * torch.clamp(HEIGHT_FLOOR - r[..., 2], min=0.0)
        )

    def kernel_cost(self, built) -> CostSpec:
        """The kernels' TASK_OMNI_PICK branch (the table's force summed over
        its bodies, the pitch by atan2)."""
        scene = built.scene
        w = self.weights
        table = scene.actor_index("table")
        robot = scene.actor_index("omnipanda")
        if scene.actors[robot].ndof != 12:
            raise ValueError("the kernels' omni pick cost reads 3 base, 7 arm and 2 finger dofs")
        return CostSpec(
            task=TASK_OMNI_PICK,
            ee_body=scene.body_index("panda_hand", "omnipanda"),
            goal_actor=scene.actor_index("goal"),
            w_dist=float(w["robot_to_block"]), w_ori=float(w["robot_ori"]),
            block_actor=scene.actor_index("block"),
            force_body0=int(scene.body_offset[table]), force_nbody=int(scene.actors[table].nbody),
            w_block=float(w["block_to_goal"]), w_force=float(w["collision"]),
            dof0=int(scene.dof_offset[robot]),
            w_base_vel=float(w["base_vel"]), w_arm_vel=float(w["arm_vel"]),
            w_pose=float(w["comfy_arm_pose"]), w_grip=float(w["comfy_gripper_state"]),
            pose=COMFY_ARM_POSE + COMFY_GRIPPER_STATE,
            w_height=float(w["height_cost"]), height_floor=HEIGHT_FLOOR,
        )


def success_fn(tol: float = 0.2):
    """Reached when ‖block − goal‖ < `tol` m."""

    def success(world):
        v = world.view
        d = v.actor_position("block")[0] - v.actor_position("goal")[0]
        return float(torch.linalg.norm(d)) < tol

    return success


def run(overrides=None, device="cuda", **kw):
    from ..runtime.loop import run_task
    from ..utils.config_store import load_config

    cfg = load_config("tasks/omni_panda_pick", overrides)
    return run_task(cfg, OmniPandaPickObjective(cfg), success_fn=success_fn(), device=device, **kw)


if __name__ == "__main__":
    import sys

    rest, opts = split_cli(sys.argv[1:], {"use_fused": None, "device": "cuda"})
    print(run(rest, device=opts["device"], use_fused=fused_opt(opts["use_fused"]),
              verbose=True).summary())
