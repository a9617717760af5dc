"""MPPIisaacPlanner — the planner orchestrator (parity with the JAX package's
`planner/mppi_isaac.py`).

One command rolls the K samples out from a K-wide copy of the world state —
in one fused-rollout launch (`ops/fused_rollout.FusedRollout`), or through
the unfused rollout (the engine's `Engine.step`, the objective's
`compute_cost` and an optional closed-loop prior, step by step) — and
applies the MPPI update (`mppi/solver.MPPIPlanner`). The entry points:

* `compute_action_from_state(world_state)`: the in-process loop
  (runtime/loop.py) broadcasts the 1-env world state K-wide;
* `compute_action(q, qdot, obst)`: the direct call, the robot's joints and
  the obstacles' poses written into the K-wide rollout sim;
* `compute_action_tensor(dof_bytes, root_bytes)` and `command()`: the RPC
  surface (runtime/server.py), tensors as runtime/transport bytes. Only the
  dof and root states travel; the rollout sim keeps its own λ rows, as the
  JAX package's does;
* online changes: `update_weights` and `update_objective` re-pack the cost
  constants of the same FusedRollout (the unfused rollout reads the
  objective at every command); `update_mppi_params` rebuilds the solver and
  the rollout on a structural key; `add_to_env` rebuilds both over the
  scene with the new actors.

Which rollout (`use_fused`): None takes the fused rollout exactly when the
objective has a `kernel_cost` and the prior is not closed-loop, on any
device (the JAX package takes its XLA rollout on the CPU); False takes the
unfused rollout; True with a closed-loop prior raises (the JAX package drops
the prior there).
"""
from __future__ import annotations

import numpy as np
import torch

from ..mppi.solver import MPPIPlanner
from ..ops.fused_rollout import FusedRollout
from ..runtime.sim import Simulation, broadcast_state, sample_model_params
from ..runtime.transport import bytes_to_torch, torch_to_bytes
from ..utils.config_store import ExampleConfig
from ..utils.device_cache import refresh_cached
from .observables import SimView


class MPPIisaacPlanner:
    """prior: optional; a tape prior (`.tape(view, t0) → (H, nu)`, e.g.
    planner/priors.QuadrupedGaitPrior) is evaluated once per command on the
    world state, a closed-loop prior (`.compute_command(view) → (K, nu)`,
    PointNavigationPrior, ArmJacobianPrior) at every rollout step for one
    sample (unfused rollout only); both with `mppi.use_priors`. use_fused:
    the rollout, as the module says."""

    def __init__(self, cfg: ExampleConfig, objective, prior=None, randomize: bool = True,
                 device="cuda", use_fused=None):
        closed_loop = prior is not None and not hasattr(prior, "tape")
        if use_fused and closed_loop:
            raise ValueError(
                f"use_fused=True with the closed-loop prior {type(prior).__name__}: a prior "
                f"evaluated at every rollout step runs only in the unfused rollout "
                f"(use_fused=None or False)")
        if use_fused and not hasattr(objective, "kernel_cost"):
            raise ValueError(f"use_fused=True, but {type(objective).__name__} has no kernel "
                             f"cost (kernel_cost) for the fused rollout")
        self.cfg = cfg
        self.objective = objective
        self._prior = prior
        self._randomize = randomize
        self.device = torch.device(device)
        if use_fused is None:
            use_fused = hasattr(objective, "kernel_cost") and not closed_loop
        self.use_fused = bool(use_fused)
        self.sim = self._rollout_sim()
        self._build_solver()

    def _rollout_sim(self) -> Simulation:
        cfg = self.cfg
        return Simulation(
            cfg=cfg.isaacgym,
            actors=cfg.actors,
            init_positions=cfg.initial_actor_positions,
            num_envs=cfg.mppi.num_samples,
            device=self.device,
            randomize=self._randomize,
            seed=cfg.mppi.seed_val,
        )

    def _build_solver(self):
        """(Re)build everything downstream of the rollout sim: the model
        parameters, the rollout (a FusedRollout, or the unfused rollout's
        closures) and the solver; the K-wide sim too when num_samples
        changed."""
        cfg = self.cfg
        K = cfg.mppi.num_samples
        if self.sim.num_envs != K:
            self.sim = self._rollout_sim()
        built, engine = self.sim.built, self.sim.engine
        self._params_K = self.sim.params if self._randomize else sample_model_params(
            built, engine, K, seed=cfg.mppi.seed_val, device=self.device)
        prior = self._prior
        tape_fn = prior_fn = None
        if prior is not None and hasattr(prior, "tape"):
            def tape_fn(state0, t0):
                return prior.tape(SimView(built, state0[0].map(lambda x: x[0])), t0)
        elif prior is not None:
            def prior_fn(state, t):
                return prior.compute_command(SimView(built, state[0]))

        rollout = {}
        if self.use_fused:
            rollout["fused"] = self.fused_factory()(K)
        else:
            # the rollout state is (SimState_K, ModelParams_K), so per-sample
            # randomization rides along
            def dynamics(state, u, t):
                st, pr = state
                st = st.replace(dof_target=built.cmd_map.apply(u, st.q))
                return engine.step(st, pr), pr

            def running_cost(state, t):
                return self.objective.compute_cost(SimView(built, state[0]))

            vis_fn = None
            if built.visualize_bodies:
                vb = built.visualize_bodies[0]

                def vis_fn(state):
                    return state[0].body_pos[:, vb]

            rollout = dict(dynamics=dynamics, running_cost=running_cost, prior=prior_fn,
                           vis_fn=vis_fn)
        self.mppi = MPPIPlanner(cfg.mppi, cfg.nx, device=self.device, tape_prior=tape_fn,
                                **rollout)
        self._last_vis = None

    def fused_factory(self):
        """``K_shard -> FusedRollout`` over this planner's scene, cost and
        rollout settings (parallel/sharding.py gives every rank one over its
        K/n samples); None when the objective has no kernel cost."""
        if not hasattr(self.objective, "kernel_cost"):
            return None
        built, engine, cfg = self.sim.built, self.sim.engine, self.cfg

        def make(K_shard: int) -> FusedRollout:
            return FusedRollout(
                built, engine,
                cost=self.objective.kernel_cost(built),
                H=cfg.mppi.horizon, K=K_shard,
                vis_body=built.visualize_bodies[0] if built.visualize_bodies else None,
                substeps=cfg.mppi.rollout_substeps,
                impulse_sweeps=cfg.mppi.rollout_sweeps,
                world_fidelity=cfg.mppi.rollout_fidelity != "fast",
                manifold=cfg.mppi.rollout_manifold,
            )

        return make

    @property
    def built(self):
        return self.sim.built

    # ------------------------------------------------------------------
    def _full(self, carry, world_state, eps=None, draw=None):
        """The 1-env world state K-wide into the rollout sim, then one MPPI
        command (`eps`, `draw`: as `MPPIPlanner._command_impl`)."""
        self.reset_rollout_from_state(world_state)
        return self.mppi._command_impl(carry, (self.sim.state, self._params_K), eps=eps,
                                       draw=draw)

    def _finish(self, action, carry, info):
        self.mppi.carry = carry
        self.mppi.last_info = info
        self._last_vis = info.get("vis")
        if self.cfg.mppi.u_per_command == 1:
            return action[0]
        return action

    def compute_action_from_state(self, world_state) -> torch.Tensor:
        self.objective.reset()
        return self._finish(*self._full(self.mppi.carry, world_state))

    def _command_from_current_state(self) -> torch.Tensor:
        return self._finish(*self.mppi._command_impl(self.mppi.carry,
                                                     (self.sim.state, self._params_K)))

    def compute_action(self, q, qdot, obst=None, obst_tensor=None) -> np.ndarray:
        """The direct call: the robots' joints (q, qdot), optionally the
        movable obstacles' poses, into the rollout sim; → the action."""
        self.sim.reset_root_state()
        self.sim.reset_robot_state(q, qdot)
        if obst is not None:
            self.sim.update_root_state_by_obstacles(obst)
        if obst_tensor is not None:
            self.sim.update_root_state_by_obstacles(
                [torch.as_tensor(o).reshape(-1)[:3] for o in obst_tensor])
        self.sim.save_root_state()
        return self._command_from_current_state().cpu().numpy()

    def reset_rollout_sim(self, dof_state_tensor, root_state_tensor):
        """The world's dof state ((D,2) or flat (2D,)) and root state (A,13),
        as transport bytes, into every sample of the rollout sim: written
        into its first env, whose body caches are refreshed, then broadcast
        K-wide (the refresh works per env and the K envs are alike, so this
        is the JAX package's K-wide refresh done once)."""
        dof = bytes_to_torch(dof_state_tensor, self.device).to(torch.float32).reshape(-1, 2)
        root = bytes_to_torch(root_state_tensor, self.device).to(torch.float32).reshape(-1, 13)
        A = self.sim.built.scene.nactor
        if root.shape[0] != A:
            raise ValueError(
                f"root_state covers {root.shape[0]} actors but the "
                f"planner scene has {A} — after add_to_env the world must send "
                f"state for the SAME actor list (reference restarts both sims)"
            )
        st = self.sim.state.map(lambda x: x[:1]).with_dof_state(dof[None])
        self.reset_rollout_from_state(self.sim.engine.refresh(st.with_root_state(root[None])))

    def reset_rollout_from_state(self, world_state):
        """A 1-env world SimState, broadcast K-wide, as the rollout sim's
        state."""
        self.sim.state = broadcast_state(world_state.map(lambda x: x[0]),
                                         self.cfg.mppi.num_samples)

    def compute_action_tensor(self, dof_state_tensor, root_state_tensor) -> bytes:
        """The RPC entry: state bytes in, action bytes out."""
        self.objective.reset()
        self.reset_rollout_sim(dof_state_tensor, root_state_tensor)
        return self.command()

    def command(self) -> bytes:
        return torch_to_bytes(self._command_from_current_state())

    def get_rollouts(self) -> bytes:
        """(H, K, 3) visualize-link trajectories of the last command, or a
        (1,1,1) zero tensor when there are none."""
        if self._last_vis is None or self._last_vis.shape[-1] == 0 \
                or (self.mppi.fused is not None and self.mppi.fused.vis_body < 0):
            return torch_to_bytes(torch.zeros(1, 1, 1))
        return torch_to_bytes(self._last_vis)

    def get_rollouts_array(self) -> np.ndarray:
        """(H, K, 3) visualize-link trajectories of the last command."""
        if self._last_vis is None:
            return np.zeros((1, 1, 3), np.float32)
        return self._last_vis.cpu().numpy()

    # ------------------------------------------------------------------
    def update_objective(self, objective):
        """Replace the objective: its cost constants go into the same
        FusedRollout's tables (the old objective's goal would stay there
        otherwise); the unfused rollout reads `self.objective`, whose
        device constants (a goal changed on the same objective) are written
        anew in place."""
        self.objective = objective
        refresh_cached(objective)
        if self.mppi.fused is not None:
            self.mppi.fused.set_cost(objective.kernel_cost(self.built))

    def update_weights(self, weights):
        """Online re-tuning: new cost weights, re-packed into the tables of
        the same FusedRollout (read by the unfused rollout's cost)."""
        self.objective.weights = weights
        refresh_cached(self.objective)
        if self.mppi.fused is not None:
            self.mppi.fused.set_cost(self.objective.kernel_cost(self.built))

    # keys whose change rebuilds the solver and the rollout (shapes, static
    # sampling bases, kernel dims); as the JAX package's set
    _STRUCTURAL_PARAMS = frozenset(
        {
            "horizon", "num_samples", "mppi_mode", "sampling_method",
            "u_per_command", "filter_u", "knot_scale", "spline_degree",
        }
    )

    def update_mppi_params(self, params):
        structural = False
        for k, v in params.items():
            if k == "noise_sigma":
                continue
            if hasattr(self.cfg.mppi, k):
                setattr(self.cfg.mppi, k, v)
                # the solver holds a resolved copy of the config
                setattr(self.mppi.cfg, k, v)
                if k in self._STRUCTURAL_PARAMS:
                    structural = True
        if structural:
            self._build_solver()
        else:
            self.mppi.refresh_constants()
        if "noise_sigma" in params:
            self.mppi.update_noise_sigma(params["noise_sigma"])

    def add_to_env(self, env_cfg_additions):
        """Add actors to the rollout scene (poses of the others kept), and
        rebuild the solver and the FusedRollout over it. The world must then
        send states of the new actor list."""
        self.sim.add_to_envs(env_cfg_additions)
        self.cfg.actors = list(self.sim.env_cfg)
        self._build_solver()
