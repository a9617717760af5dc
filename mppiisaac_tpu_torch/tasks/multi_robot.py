"""Multi-robot tasks (reference `conf/mppi/multi-pointbot.yaml`,
`multi-jackal.yaml`): N robots in one scene under one MPPI over the
concatenated controls, each driven to its own goal, with a mutual-separation
term.

Run the control loop: ``python -m mppiisaac_tpu_torch.tasks.multi_robot
[task=multi_pointbot] [device=cuda|cpu] [mppi.num_samples=200 ...]`` (the
card by default; ``device=cpu`` runs the kernels' plain versions).
``task=multi_jackal`` runs two floating-base jackals whose URDF gives every
collision element as an OBJ mesh, fit to spheres, capsules and boxes
(scene/assets.py).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.fused_physics import TASK_MULTI_ROBOT, CostSpec
from ..planner.objective import Objective
from ..planner.observables import SimView
from .common import const, fused_opt, split_cli


class _MultiRobotObjective(Objective):
    """Σ_i w_nav·‖xy_i − goal_i‖ + Σ_{i<j} w_sep·max(min_sep − ‖xy_i − xy_j‖, 0)."""

    def __init__(self, goals, min_sep, weights):
        self.goals = [np.asarray(g, dtype=np.float32) for g in goals]
        self.min_sep = min_sep
        self.weights = weights

    def _xys(self, view: SimView):
        raise NotImplementedError

    def _kernel_xy(self, scene):
        """→ (xy_actors, xy_dofs) of the CostSpec."""
        raise NotImplementedError

    def compute_cost(self, view: SimView) -> torch.Tensor:
        w = self.weights
        xys = self._xys(view)
        cost = 0.0
        for i, xy in enumerate(xys):
            goal = const(self, f"goal{i}", lambda i=i: self.goals[i], xy)
            cost = cost + w["nav"] * torch.linalg.norm(xy - goal, dim=-1)
        for i in range(len(xys)):
            for j in range(i + 1, len(xys)):
                d = torch.linalg.norm(xys[i] - xys[j], dim=-1)
                cost = cost + w["separation"] * torch.clamp(self.min_sep - d, min=0.0)
        return cost

    def kernel_cost(self, built) -> CostSpec:
        """The kernels' TASK_MULTI_ROBOT branch."""
        if len(self.goals) > 4:
            raise ValueError("the kernels' multi-robot cost takes at most 4 robots")
        actors, dofs = self._kernel_xy(built.scene)
        return CostSpec(
            task=TASK_MULTI_ROBOT, ee_body=-1, goal_actor=-1,
            w_dist=float(self.weights["nav"]), w_ori=0.0,
            xy_actors=tuple(actors), xy_dofs=tuple(dofs),
            xy_goals=tuple((float(g[0]), float(g[1])) for g in self.goals),
            w_pair=float(self.weights["separation"]), min_sep=float(self.min_sep),
        )


class MultiPointbotObjective(_MultiRobotObjective):
    """Two point robots swap positions while avoiding each other; robot i is
    actor i, its xy its first two dofs."""

    def __init__(self, cfg=None, goals=((2.0, 2.0), (-1.0, 1.0)), min_sep=0.5):
        super().__init__(goals, min_sep, {"nav": 1.0, "separation": 2.0})

    def _xys(self, view):
        return [view.state.q[..., view.scene.dof_offset[i]: view.scene.dof_offset[i] + 2]
                for i in range(len(self.goals))]

    def _kernel_xy(self, scene):
        n = len(self.goals)
        return list(range(n)), [int(scene.dof_offset[i]) for i in range(n)]


class MultiJackalObjective(_MultiRobotObjective):
    """Two diff-drive jackals drive to laterally offset goals; each one's xy
    is its root position (the actors named `jackal`, in scene order)."""

    def __init__(self, cfg=None, goals=((2.0, 0.7), (-0.5, -0.7)), min_sep=0.7):
        super().__init__(goals, min_sep, {"nav": 1.0, "separation": 3.0})

    @staticmethod
    def robot_actor_indices(scene):
        return [i for i, n in enumerate(scene.actor_names) if n == "jackal"]

    def _xys(self, view):
        return [view.state.root_pos[..., i, :2] for i in self.robot_actor_indices(view.scene)]

    def _kernel_xy(self, scene):
        idxs = self.robot_actor_indices(scene)
        return idxs, [-1] * len(idxs)


def success_fn(task, obj):
    """multi_pointbot: both robots within 0.2 m of their goals; multi_jackal:
    both within 0.25 m."""

    def success(world):
        if task == "multi_jackal":
            rp = world.state.root_pos[0].cpu().numpy()
            idxs = MultiJackalObjective.robot_actor_indices(world.scene)
            return all(np.linalg.norm(rp[i, :2] - g) < 0.25 for i, g in zip(idxs, obj.goals))
        q = world.state.q[0].cpu().numpy()
        return bool(np.linalg.norm(q[0:2] - obj.goals[0]) < 0.2
                    and np.linalg.norm(q[3:5] - obj.goals[1]) < 0.2)

    return success


def run(overrides=None, task="multi_pointbot", device="cuda", **kw):
    from ..runtime.loop import run_task
    from ..utils.config_store import load_config

    cfg = load_config(f"tasks/{task}", overrides)
    obj = MultiJackalObjective(cfg) if task == "multi_jackal" else MultiPointbotObjective(cfg)
    return run_task(cfg, obj, success_fn=success_fn(task, obj), device=device, **kw)


def run_jackal(overrides=None, **kw):
    """multi_jackal's episode (the JAX package's suite entry)."""
    return run(overrides, task="multi_jackal", **kw)


if __name__ == "__main__":
    import sys

    rest, opts = split_cli(sys.argv[1:], {"use_fused": None, "task": "multi_pointbot",
                                           "device": "cuda"})
    print(run(rest, task=opts["task"], device=opts["device"], use_fused=fused_opt(opts["use_fused"]),
              verbose=True).summary())
