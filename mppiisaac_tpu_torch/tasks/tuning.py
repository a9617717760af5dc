"""Online hyper-parameter tuning (parity with the JAX package's
`tasks/tuning.py`, itself the reference's optuna `Tuning` class: episodes
of a task, cost accumulated over each, knobs = objective weights and
noise_sigma applied live through `update_weights` / `update_mppi_params`).

The search is self-contained: log-uniform random search, then after
`refine_after` finished trials a coin flip between a fresh draw and a
perturbation of the best trial. `Study` draws from a numpy RandomState in
the JAX package's order, so the same seed suggests the same parameters.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np

from ..runtime.server import Client
from ..runtime.transport import bytes_to_torch, torch_to_bytes


@dataclass
class ParamSpec:
    low: float
    high: float
    log: bool = True


@dataclass
class Trial:
    params: Dict[str, float]
    value: Optional[float] = None


class Study:
    """Random search + local refinement around the best trial."""

    def __init__(self, space: Dict[str, ParamSpec], seed: int = 0, refine_after: int = 10):
        self.space = space
        self.rng = np.random.RandomState(seed)
        self.trials: List[Trial] = []
        self.refine_after = refine_after

    def _sample(self, spec: ParamSpec) -> float:
        if spec.log:
            return float(np.exp(self.rng.uniform(np.log(spec.low), np.log(spec.high))))
        return float(self.rng.uniform(spec.low, spec.high))

    def suggest(self) -> Trial:
        done = [t for t in self.trials if t.value is not None]
        if len(done) >= self.refine_after and self.rng.rand() < 0.5:
            best = min(done, key=lambda t: t.value)
            params = {}
            for k, spec in self.space.items():
                v = best.params[k] * float(np.exp(self.rng.randn() * 0.3)) if spec.log else (
                    best.params[k] + self.rng.randn() * 0.1 * (spec.high - spec.low)
                )
                params[k] = float(np.clip(v, spec.low, spec.high))
            t = Trial(params=params)
        else:
            t = Trial(params={k: self._sample(s) for k, s in self.space.items()})
        self.trials.append(t)
        return t

    @property
    def best(self) -> Trial:
        done = [t for t in self.trials if t.value is not None]
        return min(done, key=lambda t: t.value)

    def optimize(self, objective: Callable[[Trial], float], n_trials: int):
        for _ in range(n_trials):
            t = self.suggest()
            t.value = float(objective(t))
        return self.best


class Tuning:
    """Episode-based tuner driving a planner through `update_weights` /
    `update_mppi_params`: the in-process `MPPIisaacPlanner`, or a
    `runtime.server.Client` connected to a planner process (the world's
    dof and root states then travel as transport bytes each step)."""

    def __init__(
        self,
        planner,                       # MPPIisaacPlanner or runtime.server.Client
        world,                         # runtime.sim.Simulation (1 env)
        weight_space: Dict[str, ParamSpec],
        sigma_space: Optional[ParamSpec] = None,
        nu: Optional[int] = None,
        n_steps: int = 200,
        episode_cost: Optional[Callable] = None,
        seed: int = 0,
    ):
        self.planner = planner
        self.world = world
        self.weight_space = weight_space
        self.sigma_space = sigma_space
        self.nu = nu
        self.n_steps = n_steps
        self.episode_cost = episode_cost
        space = dict(weight_space)
        if sigma_space is not None:
            space["noise_sigma"] = sigma_space
        self.study = Study(space, seed=seed)

    def _action(self, state):
        if isinstance(self.planner, Client):
            return bytes_to_torch(self.planner.compute_action_tensor(
                torch_to_bytes(state.dof_state[0]), torch_to_bytes(state.root_state[0])),
                self.world.device)
        return self.planner.compute_action_from_state(state)

    def _run_episode(self) -> float:
        self.world.reset_to_initial_poses()
        total = 0.0
        for _ in range(self.n_steps):
            self.world.apply_robot_cmd(self._action(self.world.state))
            self.world.step()
            if self.episode_cost is not None:
                total += float(self.episode_cost(self.world))
        return total

    def objective(self, trial: Trial) -> float:
        weights = {k: v for k, v in trial.params.items() if k != "noise_sigma"}
        self.planner.update_weights(weights)
        if "noise_sigma" in trial.params and self.nu:
            sigma = (np.eye(self.nu) * trial.params["noise_sigma"]).tolist()
            self.planner.update_mppi_params({"noise_sigma": sigma})
        return self._run_episode()

    def tune(self, n_trials: int = 20) -> Trial:
        return self.study.optimize(self.objective, n_trials)
