"""Where a control step of the PyTorch port goes on the GPU.

    python scripts/profile_torch_step.py [--task panda|panda_pick] [--warmup 5]
                                         [--steps 20] [--out profile_out]

Runs the per-step loop of `run_task` (plan → command map → world step) on
CUDA: first --warmup steps (the pick loop grasps the block from about step
110), then host-timed steps with a synchronize between the
phases, then a torch.profiler window over the same steps. Prints the median
phase times, the device time by kernel, the device's busy and idle share of
the window, and the card's name and power limit; writes the Chrome trace to
--out.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mppiisaac_tpu_torch.planner.mppi_isaac import MPPIisaacPlanner  # noqa: E402
from mppiisaac_tpu_torch.runtime.sim import Simulation  # noqa: E402
from mppiisaac_tpu_torch.tasks.panda_pick import PandaPickObjective  # noqa: E402
from mppiisaac_tpu_torch.tasks.panda_reach import PandaReachObjective  # noqa: E402
from mppiisaac_tpu_torch.utils.config_store import load_config  # noqa: E402

OBJECTIVES = {"panda": PandaReachObjective, "panda_pick": PandaPickObjective}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", choices=sorted(OBJECTIVES), default="panda")
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default="profile_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    dev = torch.device("cuda")
    cfg = load_config(f"tasks/{args.task}")
    world = Simulation(cfg.isaacgym, cfg.actors, cfg.initial_actor_positions, device=dev)
    gp = world.get_actor_position_by_name("goal")[0].cpu().numpy().astype(np.float64)
    gp[: len(cfg.goal)] = cfg.goal
    world.set_actor_position_by_name("goal", gp)
    planner = MPPIisaacPlanner(cfg, OBJECTIVES[args.task](cfg), device=dev)

    def step():
        action = planner.compute_action_from_state(world.state)
        world.apply_robot_cmd(action)
        world.step()

    for _ in range(args.warmup):
        step()
    torch.cuda.synchronize()
    plan, act, wstep, total = [], [], [], []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        action = planner.compute_action_from_state(world.state)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        world.apply_robot_cmd(action)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        world.step()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        plan.append(t1 - t0)
        act.append(t2 - t1)
        wstep.append(t3 - t2)
        total.append(t3 - t0)
    med = {k: float(np.median(v) * 1e3) for k, v in
           (("plan", plan), ("apply_cmd", act), ("world_step", wstep), ("control_step", total))}
    print("host-timed medians (ms, synchronized phases):", json.dumps(med))

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    os.makedirs(args.out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.out, f"torch_step_trace_{args.task}.json"))
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    rows = sorted(events, key=lambda e: -e.self_device_time_total)
    print(f"profiled window ({args.task}): {args.steps} control steps in {window * 1e3:.3f} ms "
          f"({window * 1e3 / args.steps:.3f} ms/step)")
    print(f"device busy {busy_us / 1e3:.3f} ms = {busy_us / 1e6 / window:.4f} of the window; "
          f"idle share {1 - busy_us / 1e6 / window:.4f}")
    print("device time by kernel (self, summed over the window):")
    for e in rows[:15]:
        print(f"  {e.self_device_time_total / 1e3:10.3f} ms  {e.count:6d} calls  {e.key[:90]}")
    n_launch = sum(e.count for e in events)
    print(f"device kernels launched: {n_launch} ({n_launch / args.steps:.1f} per control step)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
