"""Many-balls demo: num_envs worlds of n_balls free spheres, all stepped
together (the port's twin of the JAX package's `examples/balls_demo.py`,
the analog of the reference's collision-group demo of 1080 envs): envs are
isolated by construction (each is its own warp of the world-step kernel,
with its own state), and the whole simulation's state is one value, so a
snapshot restores it exactly.

    python -m mppiisaac_tpu_torch.examples.balls_demo [num_envs=1080] [n_balls=4] [steps=100] [device=cuda]

Every step of every env runs in one launch of the fused world-step kernel
(`Simulation.step`); on the card it also prints the batched step's
env-steps per second beside the card's name and power limit.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..runtime.sim import Simulation
from ..scene.actor import ActorSpec
from ..scene.builder import SimConfig
from ..tasks.common import split_cli

BALLS_CONFIG = dict(dt=0.02, substeps=2)


def ball_actors(n_balls: int):
    """n_balls spheres of radius 0.1 m, 1 kg, friction 0.8, side by side in
    x (0.3 m apart: no two touch) and dropped from staggered heights."""
    return [ActorSpec(type="sphere", name=f"ball{i}", size=[0.1], mass=1.0,
                      init_pos=[0.3 * i - 0.45, 0.0, 0.5 + 0.25 * i], friction=0.8)
            for i in range(n_balls)]


def balls_sim(num_envs: int, n_balls: int, device="cuda") -> Simulation:
    return Simulation(SimConfig(**BALLS_CONFIG), ball_actors(n_balls), num_envs=num_envs,
                      device=device)


def main(num_envs: int = 1080, n_balls: int = 4, steps: int = 100, device="cuda") -> dict:
    """→ {"heights" (num_envs, n_balls) numpy after `steps` steps,
    "mean_height", "identical", "exact", "ms_per_step", "env_steps_per_s",
    and on the card "device" and "power_limit"}."""
    device = torch.device(device)
    sim = balls_sim(num_envs, n_balls, device)
    snapshot = sim.save_state()                        # whole-sim snapshot
    # one step outside the clock (the kernels' library and tables load on
    # the first), then back to the snapshot
    sim.step()
    sim.restore_state(snapshot)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        sim.step()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    z = sim.state.root_pos[:, :, 2].cpu().numpy()
    identical = bool(np.allclose(z, z[0], atol=1e-4))
    print(f"{num_envs} envs × {n_balls} balls after {steps} steps: "
          f"mean height {z.mean():.3f} (identical across envs: {identical})", flush=True)
    sim.restore_state(snapshot)                        # exact reset
    exact = all(torch.equal(a, b) for a, b in zip(sim.state.tensors(), snapshot.tensors()))
    if not exact:
        raise RuntimeError("the restored state differs from the snapshot")
    print("snapshot restore: exact", flush=True)
    out = {"heights": z, "mean_height": float(z.mean()), "identical": identical, "exact": exact,
           "ms_per_step": seconds / max(steps, 1) * 1e3,
           "env_steps_per_s": num_envs * steps / max(seconds, 1e-12)}
    if device.type == "cuda":
        from ..utils.profiling import card

        out.update(card())
        print(f"batched step: {out['env_steps_per_s']:.0f} env-steps/s, {out['ms_per_step']:.3f} "
              f"ms per step of {num_envs} envs (Simulation.step, host clock after a synchronise) "
              f"on {out['device']} ({out['power_limit']})", flush=True)
    return out


if __name__ == "__main__":
    rest, opts = split_cli(sys.argv[1:], {"num_envs": 1080, "n_balls": 4, "steps": 100,
                                          "device": "cuda"})
    if rest:
        sys.exit(f"unknown arguments {rest} (usage: python -m "
                 "mppiisaac_tpu_torch.examples.balls_demo [num_envs=1080] [n_balls=4] "
                 "[steps=100] [device=cuda])")
    main(int(opts["num_envs"]), int(opts["n_balls"]), int(opts["steps"]), opts["device"])
