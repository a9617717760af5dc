"""panda reach task (reference `examples/panda/planner.py:10-40`): EE-to-goal
distance + upright orientation term.

Run the control loop: ``python -m mppiisaac_tpu_torch.tasks.panda_reach
[task=panda|panda_effort] [device=cuda|cpu] [mppi.num_samples=500 ...]`` (the
card by default; ``device=cpu`` runs the kernels' plain versions).
panda_effort drives the seven arm joints by effort and reaches with
`panda_link7`.
"""
from __future__ import annotations

import torch

from ..ops.fused_physics import TASK_PANDA_REACH, CostSpec
from ..planner.objective import Objective
from ..planner.observables import SimView
from .common import ee_upright_cost, fused_opt, norm, split_cli


class PandaReachObjective(Objective):
    def __init__(self, cfg, ee_link: str = "panda_ee_tip"):
        self.ee_link = ee_link
        self.weights = {"robot_to_goal": 1.0, "robot_ori": 0.5}

    def compute_cost(self, view: SimView) -> torch.Tensor:
        r = view.link_state(self.ee_link, "panda")
        goal = view.actor_position("goal")
        dist = norm(r[..., 0:3] - goal)
        ori = ee_upright_cost(r[..., 3:7])
        return self.weights["robot_to_goal"] * dist + self.weights["robot_ori"] * ori

    def kernel_cost(self, built) -> CostSpec:
        """The same cost as the kernels' TASK_PANDA_REACH branch (its pitch
        by atan2, as the fused kernel computes it)."""
        scene = built.scene
        return CostSpec(
            task=TASK_PANDA_REACH,
            ee_body=scene.body_index(self.ee_link, "panda"),
            goal_actor=scene.actor_index("goal"),
            w_dist=float(self.weights["robot_to_goal"]),
            w_ori=float(self.weights["robot_ori"]),
        )


def success_fn(ee_link: str = "panda_ee_tip", tol: float = 0.1):
    """Reached when the EE is within `tol` m of the goal marker."""

    def success(world):
        v = world.view
        d = v.link_position(ee_link, "panda")[0] - v.actor_position("goal")[0]
        return float(torch.linalg.norm(d)) < tol

    return success


def run(overrides=None, task="panda", device="cuda", **kw):
    from ..runtime.loop import run_task
    from ..utils.config_store import load_config

    cfg = load_config(f"tasks/{task}", overrides)
    ee = "panda_ee_tip" if task == "panda" else "panda_link7"
    obj = PandaReachObjective(cfg, ee_link=ee)
    return run_task(cfg, obj, success_fn=success_fn(ee), device=device, **kw)


if __name__ == "__main__":
    import sys

    rest, opts = split_cli(sys.argv[1:], {"use_fused": None, "task": "panda", "device": "cuda"})
    print(run(rest, task=opts["task"], device=opts["device"], use_fused=fused_opt(opts["use_fused"]),
              verbose=True).summary())
