"""Where a control step of the PyTorch port goes on the GPU.

    python scripts/profile_torch_step.py [--task panda|panda_pick|boxer_push|albert|...]
                                         [--warmup 5] [--steps 20] [--out profile_out]

Runs the per-step loop of `run_task` (plan → command map → world step) on
CUDA: first --warmup steps (the pick loop grasps the block from about step
110; the boxer reaches the block in boxer_push after about 20), then
host-timed steps with a synchronize between the phases, then a
torch.profiler window over the same steps. Prints the median phase times,
the device time by kernel, the device's busy and idle share of the window,
and the card's name and power limit; writes the Chrome trace to --out.
`--task anymal` plans with its gait tape prior (the conf turns priors on);
`--task panda_pick_fast` is panda_pick with K1 at fast fidelity and the
reduced manifold (`mppi.rollout_fidelity=fast mppi.rollout_manifold=reduced`).

    python scripts/profile_torch_step.py --task boxer_push --drift STATES

runs on the CPU instead: how far the kernels' plain versions in float32
drift from the same in float64, at the task's shipped config, from each
world state in STATES (the files `chip_smoke.py` writes to
chiprun_out/<task>_states.pt, for boxer_push, the point-robot paths
point_robot, point_robot_obst1 and multi_pointbot, panda_effort,
panda_stick_push, omni_panda_pick, multi_jackal, albert, anymal,
panda_pick_fast and box_pair, the full box–box manifold scene of phase
17) — K1 with the inputs and the statistics chip_smoke.py holds the kernel
to (for all but boxer_push its hold controls, and for the paths of phases
10-16 its first PLAIN_K1_SAMPLES samples), and K2 over 5 world steps by row
group (not for panda_pick_fast, whose world step is panda_pick's).
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
from chip_smoke import (  # noqa: E402
    ARM_PATHS, FAST_OVERRIDES, MESH_LOOPS, PLAIN_K1_SAMPLES, POINT_PATHS, box_pair_scene,
    hold_controls, point_config, rollout_for)
from mppiisaac_tpu_torch.tasks.albert import AlbertObjective  # noqa: E402
from mppiisaac_tpu_torch.tasks.anymal import AnymalObjective, gait_prior  # noqa: E402
from mppiisaac_tpu_torch.tasks.multi_robot import MultiJackalObjective  # noqa: E402
from mppiisaac_tpu_torch.tasks.mobile_push import EE_LINK, MobilePushObjective  # noqa: E402
from mppiisaac_tpu_torch.tasks.mobile_reach import MobileReachObjective  # noqa: E402
from mppiisaac_tpu_torch.tasks.omni_panda_pick import OmniPandaPickObjective  # noqa: E402
from mppiisaac_tpu_torch.tasks.panda_pick import PandaPickObjective  # noqa: E402
from mppiisaac_tpu_torch.tasks.panda_reach import PandaReachObjective  # noqa: E402
from mppiisaac_tpu_torch.tasks.panda_stick_push import PandaStickPushObjective  # noqa: E402
from mppiisaac_tpu_torch.utils.config_store import load_config  # noqa: E402

OBJECTIVES = {
    "panda": PandaReachObjective,
    "panda_pick": PandaPickObjective,
    "panda_effort": lambda cfg: PandaReachObjective(cfg, "panda_link7"),
    "panda_stick_push": PandaStickPushObjective,
    "omni_panda_pick": OmniPandaPickObjective,
    "albert": AlbertObjective,
    "anymal": AnymalObjective,
    "multi_jackal": MultiJackalObjective,
    "panda_pick_fast": PandaPickObjective,
    **{f"{r}_push": (lambda cfg, r=r: MobilePushObjective(cfg, r, EE_LINK[r])) for r in EE_LINK},
    **{f"{r}_reach": (lambda cfg, r=r: MobileReachObjective(cfg, r)) for r in EE_LINK},
}


# the paths whose plain K1 chip_smoke.py runs on its first PLAIN_K1_SAMPLES samples
SAMPLED = {*ARM_PATHS, *MESH_LOOPS, "anymal", "panda_pick_fast"}


def setup(task):
    """The conf and objective of a conf task or of a path of chip_smoke.py's
    phase 9 (point_robot, point_robot_obst1, multi_pointbot) or 16
    (panda_pick_fast)."""
    if task in POINT_PATHS:
        return point_config(task)[:2]
    if task == "panda_pick_fast":
        cfg = load_config("tasks/panda_pick", FAST_OVERRIDES)
    else:
        cfg = load_config(f"tasks/{task}")
    return cfg, OBJECTIVES[task](cfg)


def drift(task, path):
    """float32 against float64 of the plain K1 and K2 from the saved states."""
    from mppiisaac_tpu_torch.ops.fused_rollout import (
        FusedWorldStep, rollout_plain, world_step_plain)
    from mppiisaac_tpu_torch.physics.types import ModelParams, SimState
    from mppiisaac_tpu_torch.runtime.sim import broadcast_state

    torch.set_num_threads(os.cpu_count() or 1)
    if task == "box_pair":
        cfg, obj, b, engine, _ = box_pair_scene("cpu")
    else:
        cfg, obj = setup(task)
        world = Simulation(cfg.isaacgym, cfg.actors, cfg.initial_actor_positions, device="cpu")
        b, engine = world.built, world.engine
    K, H = cfg.mppi.num_samples, cfg.mppi.horizon
    fr = rollout_for(cfg, obj, b, engine)
    fw = FusedWorldStep(b, engine, impulse_sweeps=cfg.isaacgym.fused_world_sweeps)
    ks = fw.ks
    A, D, NS = ks.nactor, ks.ndof, ks.n_state_rows
    pm = ModelParams(torch.ones(K, b.scene.nbody), torch.ones(K, b.scene.ngeom))
    # the inputs of chip_smoke.py's holds (the same generator draws): boxer_push
    # uniform in ±1 on all samples, the later tasks hold_controls, the arm
    # tasks' on the first PLAIN_K1_SAMPLES
    held = task != "boxer_push"

    def controls(g, shape):
        return hold_controls(task, cfg, g, shape) if held else torch.rand(shape, generator=g) * 2.0 - 1.0

    for name, fields in torch.load(path).items():
        s0 = SimState(**fields)
        g = torch.Generator().manual_seed(0)
        V = controls(g, (K, H, fr.nu))
        rows, Vb, mass, fric = fr.pack(broadcast_state(s0, K), pm, V)
        if task in SAMPLED:
            rows, Vb, mass, fric = (x[..., :PLAIN_K1_SAMPLES].contiguous()
                                    for x in (rows, Vb, mass, fric))
        t0 = time.perf_counter()
        out = {dt: rollout_plain(fr.ks, rows.to(dt), Vb.to(dt), mass.to(dt), fric.to(dt), H,
                                 fr.substeps, fr.dt_sub, fr.vis_body, fr.impulse_sweeps,
                                 fr.world_fidelity)[0]
               for dt in (torch.float32, torch.float64)}
        d = (out[torch.float32].double() - out[torch.float64]).abs()
        print(f"{name}: K1 float32 vs float64 at K={rows.shape[-1]}, H={H}: max "
              f"{d.max().item():.3e}, first "
              f"step {d[:, 0].max().item():.3e}, median over samples "
              f"{d.max(1).values.median().item():.3e} (costs up to "
              f"{out[torch.float64].abs().max().item():.3f}; {time.perf_counter() - t0:.0f} s)",
              flush=True)
        if task == "panda_pick_fast":
            continue
        r = {dt: fw.pack(s0).to(dt) for dt in (torch.float32, torch.float64)}
        ones_b, ones_g = torch.ones(ks.nbody), torch.ones(ks.ngeom)
        for _ in range(5):
            u = controls(g, (fr.nu,))
            tgt = b.cmd_map.apply(u[None], s0.q[None])[0]
            for dt in r:
                r[dt] = world_step_plain(ks, r[dt], tgt.to(dt), ones_b.to(dt), ones_g.to(dt),
                                         fw.substeps, fw.dt_sub, fw.impulse_sweeps)
        dd = (r[torch.float32].double() - r[torch.float64]).abs()
        root = dd[: 13 * A].reshape(A, 13)
        q = dd[13 * A: 13 * A + D].max().item() if D else 0.0
        print(f"{name}: K2 float32 vs float64 after 5 world steps: pose "
              f"{max(root[:, :7].max().item(), q):.3e}, vel "
              f"{max(root[:, 7:].max().item(), dd[13 * A + D: NS].max().item()):.3e}, lam "
              f"{dd[NS:].max().item() if ks.n_fc else 0.0:.3e}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", choices=sorted({*OBJECTIVES, *POINT_PATHS, "box_pair"}),
                    default="panda")
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default="profile_out")
    ap.add_argument("--drift", metavar="STATES", help="measure float32 drift on the CPU instead")
    args = ap.parse_args()
    if args.drift:
        drift(args.task, args.drift)
        return
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    if args.task == "box_pair":
        raise SystemExit("box_pair has no conf loop to profile (--drift only)")
    dev = torch.device("cuda")
    cfg, obj = setup(args.task)
    world = Simulation(cfg.isaacgym, cfg.actors, cfg.initial_actor_positions, device=dev)
    if getattr(cfg, "goal", None) is not None and "goal" in world.scene.actor_names:
        gp = world.get_actor_position_by_name("goal")[0].cpu().numpy().astype(np.float64)
        gp[: len(cfg.goal)] = cfg.goal
        world.set_actor_position_by_name("goal", gp)
    planner = MPPIisaacPlanner(cfg, obj, gait_prior(cfg) if args.task == "anymal" else None,
                               device=dev)

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
