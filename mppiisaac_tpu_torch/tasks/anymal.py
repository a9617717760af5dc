"""anymal — quadruped locomotion to a goal, the gait emerging from body and
knee height shaping (reference `examples/anymal/planner.py:22-48`), with the
trot tape prior of planner/priors.py when the conf turns priors on (it
does: `conf/mppi/anymal.yaml`).

Run the control loop: ``python -m mppiisaac_tpu_torch.tasks.anymal
[device=cuda|cpu] [mppi.use_priors=false] [mppi.num_samples=400 ...]`` (the
card by default; ``device=cpu`` runs the kernels' plain versions). The robot
starts 1.2 m up and lands in its first steps; its URDF gives every collision
element as an OBJ mesh (scene/assets.py).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.fused_physics import TASK_ANYMAL, CostSpec
from ..planner.objective import Objective
from ..planner.observables import SimView
from .common import fused_opt, norm, split_cli

LEGS = ("LF", "RF", "LH", "RH")
BODY_LINKS = ("base", "face_front", "face_rear")


class AnymalObjective(Objective):
    def __init__(self, cfg=None):
        self.weights = {"robot_to_goal": 1.0, "robot_off_ground": 5.0, "knees_off_ground": 5.0}
        self.body_height = 0.65
        self.knee_height = 0.35

    def _heights(self):
        """(link, target height, weight) of each height term."""
        w = self.weights
        return ([(link, self.body_height, w["robot_off_ground"]) for link in BODY_LINKS]
                + [(f"{leg}_KFE", self.knee_height, w["knees_off_ground"]) for leg in LEGS])

    def compute_cost(self, view: SimView) -> torch.Tensor:
        body = view.link_position("base", "anymal")
        goal = view.actor_position("goal")
        cost = self.weights["robot_to_goal"] * norm(body - goal)
        for link, z, w in self._heights():
            cost = cost + w * torch.abs(view.link_position(link, "anymal")[..., 2] - z)
        return cost

    def kernel_cost(self, built) -> CostSpec:
        """The kernels' TASK_ANYMAL branch: the base's distance to the goal
        and one (body, height, weight) row per height term."""
        scene = built.scene
        rows = self._heights()
        return CostSpec(
            task=TASK_ANYMAL,
            ee_body=scene.body_index("base", "anymal"),
            goal_actor=scene.actor_index("goal"),
            w_dist=float(self.weights["robot_to_goal"]),
            w_ori=0.0,
            ht_body=tuple(scene.body_index(link, "anymal") for link, _, _ in rows),
            ht_z=tuple(float(z) for _, z, _ in rows),
            ht_w=tuple(float(w) for _, _, w in rows),
        )


def success_fn(tol: float = 0.3):
    """Reached when the base's xy is within `tol` m of the goal's."""

    def success(world):
        v = world.view
        body = v.link_position("base", "anymal")[0, :2].cpu().numpy()
        goal = v.actor_position("goal")[0, :2].cpu().numpy()
        return float(np.linalg.norm(body - goal)) < tol

    return success


def gait_prior(cfg):
    """The trot tape prior the conf asks for (mppi.use_priors), else None."""
    if not cfg.mppi.use_priors:
        return None
    from ..planner.priors import QuadrupedGaitPrior

    return QuadrupedGaitPrior(H=cfg.mppi.horizon, dt=cfg.isaacgym.dt)


def run(overrides=None, device="cuda", **kw):
    from ..runtime.loop import run_task
    from ..utils.config_store import load_config

    cfg = load_config("tasks/anymal", overrides)
    return run_task(cfg, AnymalObjective(cfg), prior=gait_prior(cfg), success_fn=success_fn(),
                    device=device, **kw)


if __name__ == "__main__":
    import sys

    rest, opts = split_cli(sys.argv[1:], {"use_fused": None, "device": "cuda"})
    print(run(rest, device=opts["device"], use_fused=fused_opt(opts["use_fused"]),
              verbose=True).summary())
