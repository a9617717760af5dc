"""Simulation — the user-facing sim wrapper (parity with the JAX package's
`runtime/sim.py`, itself parity with the reference's `IsaacGymWrapper`).

State is one batched SimState attribute; every mutator replaces it, and each
setter refreshes the body caches (`Engine.refresh`). `step` advances all
num_envs envs, each with its own row of `params` and its own contact_lam:
in one launch of the fused world-step kernel (K2, one warp per env; its
plain version on the CPU) when `SimConfig.fused_world` is None or True, or
through the engine's `Engine.step` batched over the envs when it is False.
(The JAX package's None means K2 for one env only and its XLA engine for
more; the port takes K2 for any N.) The planner's K-env instance is its
scene holder and is stepped only by the unfused rollout.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..ops.fused_rollout import FusedWorldStep
from ..physics.math3d import quat_from_euler_zyx
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
        viewer: bool = False,
        device="cuda",
        conf_dir: Optional[str] = None,
        randomize: bool = False,
        seed: int = 0,
    ):
        self.cfg = cfg or SimConfig()
        if viewer:
            self.cfg.viewer = True
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
        if self.cfg.fused_world is False:
            self._world_step = self.engine          # Engine.step(state, params)
        else:
            self._world_step = FusedWorldStep(
                self.built, self.engine, impulse_sweeps=self.cfg.fused_world_sweeps)
        self.state = broadcast_state(
            self.built.initial_state(self.engine, self.device), self.num_envs
        ).map(torch.Tensor.contiguous)
        self._initial_state = self.state
        self.saved_root_state = None

    def stop_sim(self):
        """Drop the world stepper (start_sim builds a new one)."""
        self._world_step = None

    def add_to_envs(self, additions: List[dict]):
        """Add actors: rebuild the scene, keeping the poses and joint states
        of the actors that were already there."""
        old = self.state
        for a in additions:
            self.env_cfg.append(ActorSpec.from_dict(a))
        self.start_sim()
        na, nd = old.root_pos.shape[-2], old.q.shape[-1]
        kept = {}
        for f, n in (("root_pos", na), ("root_quat", na), ("root_linvel", na),
                     ("root_angvel", na), ("q", nd), ("qd", nd)):
            t = getattr(self.state, f).clone()
            t[:, :n] = getattr(old, f)
            kept[f] = t
        self._set(self.state.replace(**kept))

    # ------------------------------------------------------------------
    @property
    def scene(self):
        return self.built.scene

    @property
    def view(self) -> SimView:
        return SimView(self.built, self.state)

    # raw tensors (reference layout)
    @property
    def root_state(self) -> torch.Tensor:           # (N,A,13)
        return self.state.root_state

    @property
    def dof_state(self) -> torch.Tensor:            # (N,D,2)
        return self.state.dof_state

    @property
    def rigid_body_state(self) -> torch.Tensor:     # (N,B,13)
        return self.state.rigid_body_state

    @property
    def net_cf(self) -> torch.Tensor:               # (N,B,3)
        return self.state.net_contact_force

    @property
    def num_bodies(self) -> int:
        return self.built.scene.nbody

    @property
    def nu(self) -> int:
        return self.built.cmd_map.nu

    # ------------------------------------------------------------------
    def apply_robot_cmd(self, u):
        """u: (nu,) or (num_envs, nu) — dof targets through the command map."""
        u = self._f32(u)
        if u.ndim == 1:
            u = u.expand(self.num_envs, u.shape[0])
        self.state = self.commanded(self.state, u)

    def commanded(self, state: SimState, u: torch.Tensor) -> SimState:
        """`state` with the dof targets of u (num_envs, nu) through the
        command map."""
        return state.replace(dof_target=self.built.cmd_map.apply(u, state.q))

    def step(self):
        """Advance every env one control dt."""
        self.state = self.stepped(self.state)

    def stepped(self, state: SimState) -> SimState:
        """`state` (num_envs envs) one control dt later, each env with its
        own params row: one launch of the world-step kernel over all envs,
        or `Engine.step` over them (fused_world=False)."""
        if self._world_step is None:
            raise RuntimeError("the simulation was stopped (stop_sim): start_sim builds it anew")
        return self._world_step.step(state, self.params)

    # ------------------------------------------------------------------
    def _f32(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x, np.float32)
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _envs(self, x: torch.Tensor, per_env_ndim: int) -> torch.Tensor:
        """x of one env, or of every env → (num_envs, ...) contiguous."""
        if x.ndim == per_env_ndim:
            x = x.expand((self.num_envs,) + tuple(x.shape))
        return x.contiguous()

    def _set(self, state: SimState):
        self.state = self.engine.refresh(state)

    # state save / restore (exact: the whole state is one value)
    def save_root_state(self):
        s = self.state
        self.saved_root_state = (s.root_pos, s.root_quat, s.root_linvel, s.root_angvel)

    def reset_root_state(self):
        if self.saved_root_state is not None:
            rp, rq, rl, ra = self.saved_root_state
            self.state = self.state.replace(root_pos=rp, root_quat=rq, root_linvel=rl,
                                            root_angvel=ra)

    def save_state(self) -> SimState:
        return self.state

    def restore_state(self, state: SimState):
        self.state = state

    def reset_to_initial_poses(self):
        self.state = self._initial_state

    # ------------------------------------------------------------------
    def set_dof_state(self, dof_state):
        """dof_state: (D,2), (num_envs,D,2) or the interleaved flat (2D,)."""
        ds = self._f32(dof_state)
        if ds.ndim == 1:
            ds = ds.reshape(-1, 2)
        self._set(self.state.with_dof_state(self._envs(ds, 2)))

    def set_root_state(self, root_state):
        """root_state: (A,13) or (num_envs,A,13)."""
        self._set(self.state.with_root_state(self._envs(self._f32(root_state), 2)))

    def reset_robot_state(self, q, qdot):
        """Every robot's joints from flat (q, qdot) lists in actor order; a
        diff-drive robot takes (x, y, yaw) and their rates into its root pose
        and velocity, then its arm dofs."""
        q = np.asarray(q, dtype=np.float32).reshape(-1)
        qdot = np.asarray(qdot, dtype=np.float32).reshape(-1)
        scene = self.built.scene
        s0 = self.state.map(lambda x: x[0].clone())
        qi = 0
        for ai, (spec, art) in enumerate(zip(self.built.specs, scene.actors)):
            if spec.type != "robot":
                continue
            off = scene.dof_offset[ai]
            if spec.differential_drive:
                x, y, yaw = (float(v) for v in q[qi: qi + 3])
                vx, vy, wz = (float(v) for v in qdot[qi: qi + 3])
                s0.root_pos[ai, 0], s0.root_pos[ai, 1] = x, y
                s0.root_quat[ai] = quat_from_euler_zyx(0.0, 0.0, yaw).to(self.device)
                s0.root_linvel[ai, 0], s0.root_linvel[ai, 1] = vx, vy
                s0.root_angvel[ai, 2] = wz
                n_arm = art.ndof - int(spec.wheel_count or 2)
                s0.q[off: off + n_arm] = self._f32(q[qi + 3: qi + 3 + n_arm])
                s0.qd[off: off + n_arm] = self._f32(qdot[qi + 3: qi + 3 + n_arm])
                qi += 3 + n_arm
            else:
                n = art.ndof
                s0.q[off: off + n] = self._f32(q[qi: qi + n])
                s0.qd[off: off + n] = self._f32(qdot[qi: qi + n])
                qi += n
        kept = {f: self._envs(getattr(s0, f), getattr(s0, f).ndim)
                for f in ("q", "qd", "root_pos", "root_quat", "root_linvel", "root_angvel")}
        self._set(self.state.replace(**kept))

    # ------------------------------------------------------------------
    # named getters and setters
    def get_actor_position_by_name(self, name: str):
        return self.state.root_pos[:, self.scene.actor_index(name)]

    def get_actor_orientation_by_name(self, name: str):
        return self.state.root_quat[:, self.scene.actor_index(name)]

    def get_actor_velocity_by_name(self, name: str):
        return self.state.root_linvel[:, self.scene.actor_index(name)]

    def get_actor_link_by_name(self, link: str, actor: Optional[str] = None):
        return self.state.body_pos[:, self.scene.body_index(link, actor)]

    def set_actor_position_by_name(self, name: str, position):
        ai = self.scene.actor_index(name)
        root_pos = self.state.root_pos.clone()
        root_pos[:, ai] = self._f32(position)
        self._set(self.state.replace(root_pos=root_pos))

    def update_root_state_by_obstacles(self, obstacles):
        """Poses of the movable spheres and boxes, in actor order, from an
        observation list: each entry a position, or (position, velocity)."""
        movable = [ai for ai, s in enumerate(self.built.specs)
                   if s.type in ("sphere", "box") and not s.fixed]
        rp = self.state.root_pos.clone()
        rl = self.state.root_linvel.clone()
        for ai, obst in zip(movable, obstacles):
            seq = isinstance(obst, (list, tuple))
            rp[:, ai] = self._f32(obst[0] if seq else obst)[:3]
            if seq and len(obst) > 1:
                rl[:, ai] = self._f32(obst[1])[:3]
        self._set(self.state.replace(root_pos=rp, root_linvel=rl))
