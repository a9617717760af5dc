"""Single-process control loop: world sim + MPPI planner in one process
(parity with the JAX package's `runtime/loop.py` `run_task`, per-step path).

Each control step: one planner command from the world state, the action
through the command map, one world step. The chunked device loop of the JAX
package (many steps per host round trip) is not ported yet.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

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


def run_task(
    cfg: ExampleConfig,
    objective,
    prior=None,
    n_steps: Optional[int] = None,
    success_fn: Optional[Callable] = None,
    observer: Optional[Callable] = None,
    verbose: bool = False,
    randomize: bool = True,
    device="cuda",
) -> LoopMetrics:
    """success_fn(world: Simulation) -> bool; observer(step, world, action);
    prior: a tape prior for the planner (MPPIisaacPlanner). device: "cuda"
    (the kernels; the default) or "cpu" (their plain versions)."""
    device = torch.device(device)
    world = Simulation(
        cfg=cfg.isaacgym,
        actors=cfg.actors,
        init_positions=cfg.initial_actor_positions,
        num_envs=1,
        device=device,
    )
    # place the goal marker from cfg.goal, keeping the marker's configured
    # height when cfg.goal is 2D
    if getattr(cfg, "goal", None) is not None and "goal" in [s_.name for s_ in world.built.specs]:
        gp = world.get_actor_position_by_name("goal")[0].cpu().numpy().astype(np.float64)
        g = np.asarray(cfg.goal, dtype=np.float64).reshape(-1)
        gp[: len(g)] = g[:3]
        world.set_actor_position_by_name("goal", gp)
    planner = MPPIisaacPlanner(cfg, objective, prior, randomize=randomize, device=device)
    metrics = LoopMetrics()
    n = n_steps if n_steps is not None else cfg.n_steps
    dt = cfg.isaacgym.dt
    prev_pos = None

    for step in range(n):
        t0 = time.perf_counter()
        action = planner.compute_action_from_state(world.state)
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
    metrics.final_state_finite = bool(all(torch.isfinite(t).all() for t in world.state.tensors()))
    return metrics
