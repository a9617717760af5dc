"""Simulation — the user-facing sim wrapper (parity with the JAX package's
`runtime/sim.py`, itself parity with the reference's `IsaacGymWrapper`).

State is one batched SimState attribute; every mutator replaces it. A world
of one env steps through the fused world-step kernel (K2, or its plain
version on the CPU); a K-env instance is the planner's scene holder and is
never stepped.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..ops.fused_rollout import FusedWorldStep
from ..physics.step import Engine
from ..physics.types import ModelParams, SimState
from ..planner.observables import SimView
from ..scene.actor import ActorSpec, load_actor_cfgs
from ..scene.builder import BuiltScene, SimConfig, build_scene
from ..utils.config_store import actors_conf_dir


def broadcast_state(state: SimState, K: int) -> SimState:
    return state.map(lambda x: x.expand((K,) + x.shape))


def sample_model_params(built: BuiltScene, engine: Engine, K: int, seed: int = 0,
                        device="cpu") -> ModelParams:
    """Per-env domain randomization (mass/friction noise), drawn with the
    same numpy RandomState stream as the JAX package — identical arrays."""
    scene = built.scene
    rng = np.random.RandomState(seed)
    mass_scale = np.ones((K, scene.nbody), dtype=np.float32)
    fric_scale = np.ones((K, scene.ngeom), dtype=np.float32)
    geom_cursor = 0
    for ai, (spec, art) in enumerate(zip(built.specs, scene.actors)):
        bsl = slice(scene.body_offset[ai], scene.body_offset[ai] + art.nbody)
        ng = len(art.geoms)
        if spec.noise_percentage_mass > 0:
            mass_scale[:, bsl] *= 1.0 + rng.uniform(
                -spec.noise_percentage_mass, spec.noise_percentage_mass, size=(K, 1)
            ).astype(np.float32)
        if spec.noise_percentage_friction > 0 and ng:
            fric_scale[:, geom_cursor: geom_cursor + ng] *= 1.0 + rng.uniform(
                -spec.noise_percentage_friction, spec.noise_percentage_friction, size=(K, 1)
            ).astype(np.float32)
        geom_cursor += ng
    return ModelParams(
        body_mass_scale=torch.as_tensor(mass_scale, device=device),
        geom_friction=torch.as_tensor(fric_scale, device=device),
    )


class Simulation:
    def __init__(
        self,
        cfg: Optional[SimConfig] = None,
        actors: Sequence[Union[str, ActorSpec, dict]] = (),
        init_positions: Optional[List[List[float]]] = None,
        num_envs: int = 1,
        device="cuda",
        conf_dir: Optional[str] = None,
        randomize: bool = False,
        seed: int = 0,
    ):
        self.cfg = cfg or SimConfig()
        self.num_envs = num_envs
        self.device = torch.device(device)
        self._conf_dir = conf_dir or actors_conf_dir()
        self._seed = seed
        self._randomize = randomize
        self.env_cfg: List[ActorSpec] = self._resolve_specs(actors)
        self._init_positions = init_positions
        self.start_sim()

    def _resolve_specs(self, actors) -> List[ActorSpec]:
        specs = []
        for a in actors:
            if isinstance(a, ActorSpec):
                specs.append(a)
            elif isinstance(a, dict):
                specs.append(ActorSpec.from_dict(a))
            else:
                specs.append(load_actor_cfgs([a], self._conf_dir)[0])
        return specs

    def start_sim(self):
        self.built = build_scene(
            self.env_cfg, self.cfg, self._init_positions,
            seed=self._seed if self._randomize else None,
        )
        self.engine = Engine(self.built.scene)
        if self._randomize:
            self.params = sample_model_params(self.built, self.engine, self.num_envs,
                                              seed=self._seed, device=self.device)
        else:
            s = self.built.scene
            self.params = ModelParams(
                torch.ones(self.num_envs, s.nbody, dtype=torch.float32, device=self.device),
                torch.ones(self.num_envs, s.ngeom, dtype=torch.float32, device=self.device),
            )
        self._world_step = FusedWorldStep(
            self.built, self.engine, impulse_sweeps=self.cfg.fused_world_sweeps,
        ) if self.num_envs == 1 else None
        self.state = broadcast_state(
            self.built.initial_state(self.engine, self.device), self.num_envs
        ).map(torch.Tensor.contiguous)

    # ------------------------------------------------------------------
    @property
    def scene(self):
        return self.built.scene

    @property
    def view(self) -> SimView:
        return SimView(self.built, self.state)

    # ------------------------------------------------------------------
    def apply_robot_cmd(self, u):
        """u: (nu,) or (num_envs, nu) — dof targets through the command map."""
        u = torch.as_tensor(u, dtype=torch.float32, device=self.device)
        if u.ndim == 1:
            u = u.expand(self.num_envs, u.shape[0])
        self.state = self.state.replace(dof_target=self.built.cmd_map.apply(u, self.state.q))

    def step(self):
        """Advance the world one control dt (one env)."""
        if self._world_step is None:
            raise NotImplementedError(
                "stepping a batch of envs (the JAX package's XLA engine) is not ported")
        st0 = self.state.map(lambda x: x[0])
        pr0 = self.params.map(lambda x: x[0])
        self.state = self._world_step.step(st0, pr0).map(lambda x: x[None])

    # ------------------------------------------------------------------
    def get_actor_position_by_name(self, name: str):
        return self.state.root_pos[:, self.scene.actor_index(name)]

    def set_actor_position_by_name(self, name: str, position):
        ai = self.scene.actor_index(name)
        pos = torch.as_tensor(np.asarray(position, np.float32), device=self.device)
        root_pos = self.state.root_pos.clone()
        root_pos[:, ai] = pos
        self.state = self.engine.refresh(self.state.replace(root_pos=root_pos))
