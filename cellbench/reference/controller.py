"""The closed-loop control step, worked out again from a configuration file.

`Reference(conf, cost, device)` builds, with the frozen copies under this
package only, what the port builds for a task: the 1-env world with its goal
marker placed, the K-wide rollout scene with its per-sample mass and
friction scales drawn from the configuration's seed, K1's and K2's scene
tables, and the MPPI solver. One control step of the port is then

    command:    draw from the carry's key → noise → controls V → K1 costs
                → softmax update, Savitzky–Golay filter, shift → action
    world step: dof targets of the action → K2 → the next world state

`sample` and `update` are the solver's `_command_impl` split around the
rollout (its one-device path with the fused rollout, and the tape prior
that the configuration names, if any), so that the rollouts of several
steps run as one batch of columns, and so that the update can be worked out
from given costs.

`store=torch.bfloat16` keeps every value that passes from one stage to the
next in bfloat16 (the world state, the noise, K1's costs, U, the action,
K2's output, and the tape) while the arithmetic inside a stage stays
float32: the control of the comparison.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional

import numpy as np
import torch

from . import kernels
from .kernels import stored
from .mppi import prng
from .mppi.solver import MppiCarry, MPPIPlanner
from .physics.step import Engine
from .physics.types import ModelParams, SimState
from .scene.actor import ActorSpec
from .scene.builder import build_scene
from .utils.config_store import config_from_dict


def broadcast_state(state: SimState, K: int) -> SimState:
    return state.map(lambda x: x.expand((K,) + x.shape))


def sample_model_params(built, K: int, seed: int, device) -> ModelParams:
    """Per-sample mass and friction scales, the same numpy stream as the
    port's `runtime/sim.sample_model_params`."""
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
    return ModelParams(body_mass_scale=torch.as_tensor(mass_scale, device=device),
                       geom_friction=torch.as_tensor(fric_scale, device=device))


def state_from(fields: Dict[str, torch.Tensor], device) -> SimState:
    """A SimState of the given fields (any leading env axis), on `device`."""
    return SimState(**{f: v.to(device=device, dtype=torch.float32) for f, v in fields.items()})


class Reference:
    """conf: the task configuration as the benchmark's configuration file
    holds it (actors as dicts); cost: the name of a module under
    `reference/costs/` whose `kernel_cost(built)` gives K1's cost; prior:
    None, or the name of a module under `reference/priors/` whose
    `tape_prior(built, cfg)` gives the tape of each command."""

    def __init__(self, conf: dict, cost: str, device="cpu", store=None,
                 prior: Optional[str] = None):
        self.device = torch.device(device)
        self.store = store
        cfg = config_from_dict({**conf, "actors": []})
        self.cfg = cfg
        specs = [ActorSpec.from_dict(a) for a in conf["actors"]]
        dev = self.device
        # the world: one env, unit scales, its goal marker placed
        self.world_built = build_scene(specs, cfg.isaacgym, cfg.initial_actor_positions, seed=None)
        self.world_engine = Engine(self.world_built.scene)
        st = broadcast_state(self.world_built.initial_state(self.world_engine, dev), 1)
        st = st.map(torch.Tensor.contiguous)
        names = [s.name for s in self.world_built.specs]
        if cfg.goal is not None and "goal" in names:
            ai = self.world_built.scene.actor_index("goal")
            gp = st.root_pos[0, ai].cpu().numpy().astype(np.float64)
            g = np.asarray(cfg.goal, dtype=np.float64).reshape(-1)
            gp[: len(g)] = g[:3]
            root_pos = st.root_pos.clone()
            root_pos[:, ai] = torch.as_tensor(np.asarray(gp, np.float32), device=dev)
            st = self.world_engine.refresh(st.replace(root_pos=root_pos))
        self.initial_world = st
        self.world_step = kernels.WorldStep(self.world_built, self.world_engine,
                                            cfg.isaacgym.fused_world_sweeps)
        # the planner: K samples over a scene built with the solver's seed
        m = cfg.mppi
        self.K = int(m.num_samples)
        seed = int(m.seed_val)
        self.rollout_built = build_scene(specs, cfg.isaacgym, cfg.initial_actor_positions,
                                         seed=seed)
        rollout_engine = Engine(self.rollout_built.scene)
        self.params_K = sample_model_params(self.rollout_built, self.K, seed, dev)
        cost_fn = importlib.import_module(f"{__package__}.costs.{cost}").kernel_cost
        vb = self.rollout_built.visualize_bodies
        self.rollout = kernels.Rollout(
            self.rollout_built, rollout_engine, cost_fn(self.rollout_built), H=m.horizon,
            K=self.K, vis_body=vb[0] if vb else None, substeps=m.rollout_substeps,
            impulse_sweeps=m.rollout_sweeps, world_fidelity=m.rollout_fidelity != "fast",
            manifold=m.rollout_manifold)
        self.solver = MPPIPlanner(m, cfg.nx, fused=self.rollout, device=dev)
        self.tape = None
        if prior is not None:
            self.tape = importlib.import_module(f"{__package__}.priors.{prior}").tape_prior(
                self.rollout_built, cfg)
        self.rollout.store = self.world_step.store = store
        if store is not None:
            self.initial_world = self.initial_world.map(lambda x: stored(x, store))

    # ------------------------------------------------------------------
    def initial_carry(self, episode_seed: int) -> MppiCarry:
        return dataclasses.replace(self.solver.init_carry(), key=prng.prng_key(int(episode_seed)))

    def draw(self, key: np.ndarray) -> torch.Tensor:
        """The first command's draw from `key` (as `MPPIPlanner.draws`)."""
        _, d = self.solver.draws(np.asarray(key, np.uint32), 1)
        return torch.as_tensor(d[0], device=self.device)

    def sample(self, state: SimState, carry: MppiCarry, draw: torch.Tensor):
        """→ (V (K,H,nu) controls, ε_eff) of one command from the 1-env
        world state (read by the tape only)."""
        s, c = self.solver, self.solver.cfg
        K = c.num_samples
        eps = stored(s.noise(draw, carry.sigma), self.store)
        V = torch.clamp(carry.U[None] + eps, s._u_min, s._u_max)
        if c.sample_null_action:
            V[K - 1] = 0.0
        if self.tape is not None and c.use_priors:
            # one sample rolls the tape; with a blend the sampling mean moves
            # to (1 − a)·U + a·tape
            tape = torch.clamp(self.tape(state, carry.t0).to(torch.float32), s._u_min, s._u_max)
            tape = stored(tape, self.store)
            if c.prior_blend > 0.0:
                a = s._prior_blend
                V = torch.clamp((1 - a) * carry.U[None] + a * tape[None] + eps, s._u_min,
                                s._u_max)
                if c.sample_null_action:
                    V[K - 1] = 0.0
            V[K - 2] = tape
        return V, V - carry.U[None]

    def update(self, carry: MppiCarry, eps_eff: torch.Tensor, costs: torch.Tensor):
        """The update from the rollout's costs (K,H) → (action (nu,), the
        carry's new U (H,nu), S (K,))."""
        s, c = self.solver, self.solver.cfg
        eps_eff, costs = stored(eps_eff, self.store), stored(costs, self.store)
        sigma_inv = torch.linalg.inv_ex(carry.sigma + s._eye * 1e-8).inverse
        if c.noise_abs_cost:
            act_cost = carry.lambda_ * torch.einsum("khj,ij->khi", eps_eff.abs(), sigma_inv.abs())
            action_cost = torch.sum(carry.U.abs()[None] * act_cost, dim=(-1, -2))
        else:
            act_cost = carry.lambda_ * torch.einsum("khj,ij->khi", eps_eff, sigma_inv)
            action_cost = torch.sum(carry.U[None] * act_cost, dim=(-1, -2))
        S = torch.sum(costs * s._gamma[None], dim=1) + action_cost
        beta = torch.min(S)
        scaled = -(S - beta) / torch.clamp(carry.lambda_, min=1e-6)
        eta = torch.sum(torch.exp(scaled))
        w = torch.exp(scaled) / eta
        U_new = carry.U + torch.einsum("k,khn->hn", w, eps_eff)
        if s._sg is not None:
            U_new = s._sg @ U_new
        U_new = torch.clamp(U_new, s._u_min, s._u_max)
        action = U_new[: c.u_per_command] * c.u_scale
        U_shift = torch.cat([U_new[c.u_per_command:], s._u_init.expand(c.u_per_command, s.nu)])
        return stored(action[0], self.store), stored(U_shift, self.store), S

    # ------------------------------------------------------------------
    def k1_inputs(self, state: SimState, carry: MppiCarry, with_eps: bool = False):
        """K1's inputs (rows, V, mass, fric) for the command from a 1-env
        world state and a carry (and ε_eff with `with_eps`)."""
        V, eps_eff = self.sample(state, carry, self.draw(carry.key))
        state_K = broadcast_state(state.map(lambda x: x[0]), self.K)
        inputs = self.rollout.pack(state_K, self.params_K, V * self.solver.cfg.u_scale)
        return (inputs, eps_eff) if with_eps else inputs

    def costs(self, steps: List[dict], H: Optional[int] = None):
        """K1's costs (K, H) of each step's command, the rollouts of all the
        steps as one batch of columns; `H` fewer horizon steps. Each step:
        {"state": world SimState (1 env), "carry": MppiCarry}. → (a list of
        costs, a list of ε_eff)."""
        packed, eps = zip(*(self.k1_inputs(s["state"], s["carry"], with_eps=True)
                            for s in steps))
        rows, V, mass, fric = (torch.cat([p[i] for p in packed], -1) for i in range(4))
        costs, _ = self.rollout.run(rows, V, mass, fric, H)
        K = self.K
        return [costs[i * K: (i + 1) * K] for i in range(len(steps))], list(eps)

    def world_steps(self, states: List[SimState], actions: List[torch.Tensor]) -> torch.Tensor:
        """K2 rows (NS + 4·n_fc, N) one dt after each 1-env state under its
        action's dof targets, the N steps as N envs of one call."""
        rows = torch.cat([self.world_step.rows(s) for s in states], 1)
        tgt = torch.cat([self.world_built.cmd_map.apply(a.reshape(1, -1).to(torch.float32), s.q)
                         for s, a in zip(states, actions)], 0)
        return self.world_step.step_rows(rows, tgt)
