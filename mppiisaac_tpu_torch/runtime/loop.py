"""Single-process control loop: world sim + MPPI planner in one process
(parity with the JAX package's `runtime/loop.py` `run_task` and
`run_task_episodes`, per-step path).

Each control step: one planner command from the world state, the action
through the command map, one world step. The chunked device loop of the JAX
package (`device_steps`, many steps per host round trip) is not ported yet.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..mppi import prng
from ..planner.mppi_isaac import MPPIisaacPlanner
from ..utils.config_store import ExampleConfig
from .sim import Simulation


@dataclass
class LoopMetrics:
    fps: List[float] = field(default_factory=list)
    rt_factor: List[float] = field(default_factory=list)
    solver_time: List[float] = field(default_factory=list)
    path_length: float = 0.0
    steps: int = 0
    success_step: Optional[int] = None
    final_state_finite: bool = True

    def summary(self) -> dict:
        return {
            "steps": self.steps,
            "mean_fps": float(np.mean(self.fps)) if self.fps else 0.0,
            "mean_rt": float(np.mean(self.rt_factor)) if self.rt_factor else 0.0,
            "mean_solver_time_ms": float(np.mean(self.solver_time) * 1e3) if self.solver_time else 0.0,
            "path_length": self.path_length,
            "success_step": self.success_step,
            "time2goal": self.success_step,
        }


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def goal_world(cfg: ExampleConfig, device) -> Simulation:
    """The 1-env world of a task, with the goal marker placed from cfg.goal
    (keeping the marker's configured height when cfg.goal is 2D)."""
    world = Simulation(
        cfg=cfg.isaacgym,
        actors=cfg.actors,
        init_positions=cfg.initial_actor_positions,
        num_envs=1,
        device=device,
    )
    if getattr(cfg, "goal", None) is not None and "goal" in [s_.name for s_ in world.built.specs]:
        gp = world.get_actor_position_by_name("goal")[0].cpu().numpy().astype(np.float64)
        g = np.asarray(cfg.goal, dtype=np.float64).reshape(-1)
        gp[: len(g)] = g[:3]
        world.set_actor_position_by_name("goal", gp)
    return world


def run_steps(world: Simulation, act: Callable, n: int, dt: float,
              success_fn=None, observer=None, verbose=False, real_time=False) -> LoopMetrics:
    """One episode of up to n control steps from the world's current state:
    each step the action `act(world.state)` (an in-process planner, or the
    planner process over RPC), then one world step. solver_time holds each
    step's `act`; fps and rt_factor come from the step's own time, before
    the real-time sleep."""
    device = world.device
    metrics = LoopMetrics()
    prev_pos = None
    for step in range(n):
        t0 = time.perf_counter()
        action = act(world.state)
        _sync(device)
        t1 = time.perf_counter()
        world.apply_robot_cmd(action)
        world.step()
        rp = world.state.root_pos[0, 0].cpu().numpy()
        t2 = time.perf_counter()

        metrics.solver_time.append(t1 - t0)
        actual = t2 - t0
        metrics.fps.append(1.0 / max(actual, 1e-9))
        metrics.rt_factor.append(dt / max(actual, 1e-9))
        metrics.steps = step + 1
        if prev_pos is not None:
            metrics.path_length += float(np.linalg.norm(rp - prev_pos))
        prev_pos = rp

        if observer is not None:
            observer(step, world, action)
        if verbose:
            print(
                f"step {step}: FPS {metrics.fps[-1]:8.1f}  RT {metrics.rt_factor[-1]:6.2f}  "
                f"solver {metrics.solver_time[-1]*1e3:7.2f} ms"
            )
        if success_fn is not None and metrics.success_step is None and success_fn(world):
            metrics.success_step = step
            break
        if real_time and actual < dt:
            time.sleep(dt - actual)
    metrics.final_state_finite = bool(all(torch.isfinite(t).all() for t in world.state.tensors()))
    return metrics


def run_task(
    cfg: ExampleConfig,
    objective,
    prior=None,
    n_steps: Optional[int] = None,
    real_time: bool = False,
    success_fn: Optional[Callable] = None,
    observer: Optional[Callable] = None,
    verbose: bool = False,
    randomize: bool = True,
    device="cuda",
) -> LoopMetrics:
    """success_fn(world: Simulation) -> bool; observer(step, world, action);
    prior: a tape prior for the planner (MPPIisaacPlanner). real_time: sleep
    out each control period. device: "cuda" (the kernels; the default) or
    "cpu" (their plain versions)."""
    device = torch.device(device)
    world = goal_world(cfg, device)
    planner = MPPIisaacPlanner(cfg, objective, prior, randomize=randomize, device=device)
    n = n_steps if n_steps is not None else cfg.n_steps
    return run_steps(world, planner.compute_action_from_state, n, cfg.isaacgym.dt,
                     success_fn=success_fn, observer=observer, verbose=verbose,
                     real_time=real_time)


def run_task_episodes(
    cfg: ExampleConfig,
    objective,
    seeds,
    prior=None,
    n_steps: Optional[int] = None,
    success_fn: Optional[Callable] = None,
    randomize: bool = True,
    verbose: bool = False,
    device="cuda",
) -> Dict[int, LoopMetrics]:
    """Seeded episodes on one build: the world and the planner (with their
    FusedRollout and FusedWorldStep) are built once; each seed then runs a
    fresh episode from the initial world state (goal marker placed), with
    the solver carry re-keyed by `prng.prng_key(seed)` (JAX's
    `PRNGKey(seed)`). → {seed: LoopMetrics}. The JAX function's chunked
    device loop (`device_steps`) is not ported: every episode runs the
    per-step loop."""
    device = torch.device(device)
    world = goal_world(cfg, device)
    initial = world.state
    planner = MPPIisaacPlanner(cfg, objective, prior, randomize=randomize, device=device)
    n = n_steps if n_steps is not None else cfg.n_steps
    results = {}
    for seed in seeds:
        world.state = initial
        planner.mppi.carry = dataclasses.replace(planner.mppi.init_carry(),
                                                 key=prng.prng_key(int(seed)))
        results[seed] = run_steps(world, planner.compute_action_from_state, n,
                                  cfg.isaacgym.dt, success_fn=success_fn)
        if verbose:
            print(f"seed {seed}: {results[seed].summary()}", flush=True)
    return results
