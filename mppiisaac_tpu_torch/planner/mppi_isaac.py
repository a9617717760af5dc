"""MPPIisaacPlanner — the planner orchestrator (parity with the JAX package's
`planner/mppi_isaac.py` on its per-step path).

One command broadcasts the world state K-wide, rolls the K samples out in one
fused-rollout launch (`ops/fused_rollout.FusedRollout`) and applies the MPPI
update (`mppi/solver.MPPIPlanner`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..mppi.solver import MPPIPlanner
from ..ops.fused_rollout import FusedRollout
from ..runtime.sim import Simulation, broadcast_state, sample_model_params
from ..utils.config_store import ExampleConfig


class MPPIisaacPlanner:
    def __init__(self, cfg: ExampleConfig, objective, randomize: bool = True, device="cpu"):
        if not hasattr(objective, "kernel_cost"):
            raise NotImplementedError(
                f"{type(objective).__name__} has no CUDA cost (kernel_cost)")
        self.cfg = cfg
        self.objective = objective
        self._randomize = randomize
        self.device = torch.device(device)
        self.sim = Simulation(
            cfg=cfg.isaacgym,
            actors=cfg.actors,
            init_positions=cfg.initial_actor_positions,
            num_envs=cfg.mppi.num_samples,
            device=self.device,
            randomize=randomize,
            seed=cfg.mppi.seed_val,
        )
        self._build_solver()

    def _build_solver(self):
        cfg = self.cfg
        K = cfg.mppi.num_samples
        built, engine = self.sim.built, self.sim.engine
        self._params_K = self.sim.params if self._randomize else sample_model_params(
            built, engine, K, seed=cfg.mppi.seed_val, device=self.device)
        fused = FusedRollout(
            built, engine,
            cost=self.objective.kernel_cost(built),
            H=cfg.mppi.horizon, K=K,
            vis_body=built.visualize_bodies[0] if built.visualize_bodies else None,
            substeps=cfg.mppi.rollout_substeps,
            impulse_sweeps=cfg.mppi.rollout_sweeps,
            world_fidelity=cfg.mppi.rollout_fidelity != "fast",
            manifold=cfg.mppi.rollout_manifold,
        )
        self.mppi = MPPIPlanner(cfg.mppi, cfg.nx, fused=fused, device=self.device)
        self._last_vis = None

    def _full(self, carry, world_state, eps=None):
        """Broadcast the 1-env world state K-wide, then one MPPI command."""
        state_K = broadcast_state(world_state.map(lambda x: x[0]), self.cfg.mppi.num_samples)
        return self.mppi._command_impl(carry, (state_K, self._params_K), eps=eps)

    def compute_action_from_state(self, world_state) -> torch.Tensor:
        self.objective.reset()
        action, self.mppi.carry, info = self._full(self.mppi.carry, world_state)
        self.mppi.last_info = info
        self._last_vis = info.get("vis")
        if self.cfg.mppi.u_per_command == 1:
            return action[0]
        return action

    def get_rollouts_array(self) -> np.ndarray:
        """(H, K, 3) visualize-link trajectories of the last command."""
        if self._last_vis is None:
            return np.zeros((1, 1, 3), np.float32)
        return self._last_vis.cpu().numpy()
