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

    python scripts/profile_torch_step.py --task panda_pick --warmup 121 --sections

builds the kernels with their clock64() section counters (-DSECTION_CLOCKS,
into _build/sections/), runs the --warmup loop steps, then launches the
next step's K1 and K2 --steps times each on the inputs that step gave them
and prints the split by section (FK, contacts, velocity solves, the impulse
pass's inverse masses, warm start, sweeps and snap, cost; the velocity
solves also in five parts) in cycles per
sample and launch, with ptxas's registers and stack frame, and K1's time at
its block size and at one warp per block (CUDA events).

    python scripts/profile_torch_step.py --task boxer_push --drift STATES

runs on the CPU instead: how far the kernels' plain versions in float32
drift from the same in float64, at the task's shipped config, from each
world state in STATES (the files `chip_smoke.py` writes to
chiprun_out/<task>_states.pt, for panda_pick, boxer_push, the point-robot paths
point_robot, point_robot_obst1 and multi_pointbot, panda_effort,
panda_stick_push, omni_panda_pick, multi_jackal, albert, anymal,
panda_pick_fast and box_pair, the full box–box manifold scene of phase
17) — K1 with the inputs and the statistics chip_smoke.py holds the kernel
to (for all but boxer_push its hold controls, and for the paths of phases
10-16 its first PLAIN_K1_SAMPLES samples), and K2 over 5 world steps by row
group (not for panda_pick_fast, whose world step is panda_pick's).

    python scripts/profile_torch_step.py --task panda_pick --warmup 110 --steps 160 \
        --k2-holds 10 --out chiprun_out

runs the loop on the card for --warmup and then --steps steps (on past a
success), and from every 10th of the latter states holds K2 over 5 world
steps against its plain version in float32, beside the plain version's own
float32-vs-float64 drift from the same state (the hold's targets of
chip_smoke.py), by row group; the states go to
--out/<task>_k2_states.pt.
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


def hold_draw(task, cfg, g, shape):
    """The controls of chip_smoke.py's holds (the same generator draws):
    boxer_push uniform in ±1, panda_pick in ±0.3 (phase 6), the later tasks
    hold_controls."""
    if task == "panda_pick":
        return torch.rand(shape, generator=g) * 0.6 - 0.3
    if task == "boxer_push":
        return torch.rand(shape, generator=g) * 2.0 - 1.0
    return hold_controls(task, cfg, g, shape)


def hold_targets(task, cfg, built, s0, g, n):
    """n K2 targets of chip_smoke.py's holds from state s0, drawn from g on
    the CPU after the K1 controls: panda_pick's around s0.q with the
    fingers' targets kept (phase 6), the others the command map of
    hold_draw's controls."""
    out = []
    for _ in range(n):
        if task == "panda_pick":
            tgt = s0.q.cpu() + (torch.rand(s0.q.shape[-1], generator=g) * 0.4 - 0.2)
            tgt[7:9] = s0.dof_target[7:9].cpu()
        else:
            u = hold_draw(task, cfg, g, (built.cmd_map.nu,))
            tgt = built.cmd_map.apply(u[None], s0.q[None].cpu())[0]
        out.append(tgt.to(s0.q.device))
    return out


def k2_holds(args, cfg, world, step):
    """K2 against its plain version on the card, in float32 and float64,
    over 5 world steps from every --k2-holds-th state of --steps loop steps
    after --warmup (the loop runs on past a success), with the targets of
    chip_smoke.py's holds: by row group, the kernel's |d| from the plain
    float32 beside the plain float32's own |d| from float64. The states go
    to --out/<task>_k2_states.pt (`--drift` reads them)."""
    from chip_smoke import state_dict
    from mppiisaac_tpu_torch.ops.fused_rollout import world_step_plain

    fw, b = world._world_step, world.built
    ks = fw.ks
    A, D, NS, K, H = ks.nactor, ks.ndof, ks.n_state_rows, cfg.mppi.num_samples, cfg.mppi.horizon
    states = []
    for i in range(args.steps):
        if i % args.k2_holds == 0:
            states.append((f"step {args.warmup + i}", world.state.map(lambda x: x[0].clone())))
        step()
    os.makedirs(args.out, exist_ok=True)
    torch.save({name: state_dict(s0) for name, s0 in states},
               os.path.join(args.out, f"{args.task}_k2_states.pt"))
    ones_b, ones_g = torch.ones(ks.nbody, device="cuda"), torch.ones(ks.ngeom, device="cuda")
    tgts, r = [], []
    for _, s0 in states:
        g = torch.Generator().manual_seed(0)
        hold_draw(args.task, cfg, g, (K, H, ks.nu))
        tgts.append(hold_targets(args.task, cfg, b, s0, g, 5))
        rows = fw.pack(s0).contiguous()
        for tgt in tgts[-1]:
            rows = fw.step_rows(rows, tgt.contiguous(), ones_b, ones_g)
        r.append(rows)
    N = len(states)
    rp = {dt: torch.stack([fw.pack(s0) for _, s0 in states], 1).to(dt)
          for dt in (torch.float32, torch.float64)}
    for i in range(5):
        tgt = torch.stack([t[i] for t in tgts])
        for dt in rp:
            rp[dt] = world_step_plain(ks, rp[dt], tgt.to(dt), ones_b.to(dt).expand(N, -1),
                                      ones_g.to(dt).expand(N, -1), fw.substeps, fw.dt_sub,
                                      fw.impulse_sweeps)

    def groups(d):
        root = d[: 13 * A].reshape(A, 13)
        q = d[13 * A: 13 * A + D].max().item() if D else 0.0
        return (max(root[:, :7].max().item(), q),
                max(root[:, 7:].max().item(), d[13 * A + D: NS].max().item()),
                d[NS:].max().item() if ks.n_fc else 0.0)

    print(f"K2 over 5 world steps from {N} states of the {args.task} loop "
          f"(pose, vel, lam): kernel vs plain float32 | plain float32 vs float64")
    for j, (name, _) in enumerate(states):
        p32 = rp[torch.float32][:, j].double()
        dk = groups((r[j].double() - p32).abs())
        dd = groups((p32 - rp[torch.float64][:, j]).abs())
        print(f"  {name:9s} " + " ".join(f"{x:.3e}" for x in dk) + " | "
              + " ".join(f"{x:.3e}" for x in dd), flush=True)


def _bound_line(name, bounds):
    return f"{name}: 10x drift " + ", ".join(f"{k} {v:.3g}" for k, v in bounds.items())


def ablation_drift():
    """chip_smoke.py phase 20b's ablated plain versions in float32 against
    float64 from the held grasp (its ABLATE_BOUNDS)."""
    from chip_smoke import ABLATED, _groups, ablation_plain, drift_bounds

    torch.set_num_threads(os.cpu_count() or 1)
    p = {dt: ablation_plain(dt) for dt in (torch.float32, torch.float64)}
    for mask in (4, 1, 7, 8, 16):
        name, profile = ABLATED[mask]
        (c32, v32), _ = p[torch.float32]["k1"][mask]
        (c64, v64), _ = p[torch.float64]["k1"][mask]
        print(_bound_line(f"K1 {name} (mask {mask}) costs", drift_bounds((c32.double() - c64).abs())))
        if profile.get("zero_cost"):
            dv = (v32.double() - v64).abs().amax(2).T
            print(_bound_line(f"K1 {name} (mask {mask}) vis", drift_bounds(dv)))
    ks = _ks_of_pick()
    for mask in (8, 16):
        r32, _ = p[torch.float32]["k2"][mask]
        r64, _ = p[torch.float64]["k2"][mask]
        g = _groups(ks, (r32.double() - r64).abs())
        print(_bound_line(f"K2 {ABLATED[mask][0]} (mask {mask}) rows after 5 steps",
                          {k: max(10 * v, 1e-6) for k, v in g.items()}), flush=True)


def _ks_of_pick():
    from mppiisaac_tpu_torch.ops.fused_rollout import FusedWorldStep

    cfg = load_config("tasks/panda_pick")
    w = Simulation(cfg.isaacgym, cfg.actors, cfg.initial_actor_positions, device="cpu")
    return FusedWorldStep(w.built, w.engine, impulse_sweeps=cfg.isaacgym.fused_world_sweeps).ks


def bench_drift():
    """chip_smoke.py phase 17f's plain K1 in float32 against float64 on the
    bench twin's inputs (the initial state, V drawn as the solver draws it
    from its initial carry; the first BENCH_PLAIN_SAMPLES samples at H=30):
    its BENCH_BOUNDS."""
    from chip_smoke import BENCH_PLAIN_SAMPLES, drift_bounds
    from mppiisaac_tpu_torch import bench
    from mppiisaac_tpu_torch.ops.fused_rollout import rollout_plain

    torch.set_num_threads(os.cpu_count() or 1)
    cfg = bench.config()
    planner = MPPIisaacPlanner(cfg, PandaPickObjective(cfg), randomize=True, device="cpu")
    mppi, fr = planner.mppi, planner.mppi.fused
    _, d = mppi.draws(mppi.carry.key, 1)
    eps = mppi.noise(torch.as_tensor(d[0]), mppi.carry.sigma)
    V = torch.clamp(mppi.carry.U[None] + eps, mppi._u_min, mppi._u_max) * mppi.cfg.u_scale
    n = BENCH_PLAIN_SAMPLES
    part = [x[..., :n].contiguous() for x in fr.pack(planner.sim.state, planner._params_K, V)]
    c = {dt: rollout_plain(fr.ks, *(x.to(dt) for x in part), fr.H, fr.substeps, fr.dt_sub,
                           fr.vis_body, fr.impulse_sweeps, fr.world_fidelity)[0]
         for dt in (torch.float32, torch.float64)}
    print(_bound_line(f"bench K1 (K={fr.K}, H={fr.H}) costs of the first {n} samples",
                      drift_bounds((c[torch.float32].double() - c[torch.float64]).abs())),
          flush=True)


def first_touch(record, out):
    """The first post-step state of a panda_stick_push episode recorded by
    `python -m mppiisaac_tpu_torch.validate one panda_stick_push ...
    record=RECORD` at which a stick–block λ row carries an impulse (the
    touching state of chip_smoke.py phase 11) → `out`, as its fields."""
    from chip_smoke import pair_rows
    from mppiisaac_tpu_torch.physics.types import SIM_STATE_FIELDS

    cfg = load_config("tasks/panda_stick_push")
    w = Simulation(cfg.isaacgym, cfg.actors, cfg.initial_actor_positions, device="cpu")
    rows = pair_rows(w.scene, w.engine.tables, "panda", "panda_push_block", "cpu").numpy()
    with np.load(record) as d:
        lam = d["traj0.contact_lam"][:, 0, rows]
        hit = np.abs(lam).reshape(len(lam), -1).max(1) > 0
        if not hit.any():
            raise SystemExit(f"{record}: the stick never touched the block")
        i = int(np.argmax(hit))
        torch.save({f: torch.from_numpy(d[f"traj0.{f}"][i, 0].copy()) for f in SIM_STATE_FIELDS
                    if f"traj0.{f}" in d}, out)
    print(f"{record}: the stick touches the block after step {i} -> {out}", flush=True)


def drift(task, path):
    """float32 against float64 of the plain K1 and K2 from the saved states."""
    from mppiisaac_tpu_torch.ops.fused_rollout import (
        FusedWorldStep, rollout_plain, world_step_plain)
    from mppiisaac_tpu_torch.physics.types import SIM_STATE_FIELDS, ModelParams, SimState
    from mppiisaac_tpu_torch.runtime.sim import broadcast_state

    torch.set_num_threads(os.cpu_count() or 1)
    if task == "bench":
        return bench_drift()
    if task == "ablations":
        return ablation_drift()
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
    states = torch.load(path)
    if set(states) <= set(SIM_STATE_FIELDS):        # one state's fields (tests/data)
        states = {os.path.basename(path): states}
    for name, fields in states.items():
        s0 = SimState(**fields)
        g = torch.Generator().manual_seed(0)
        V = hold_draw(task, cfg, g, (K, H, fr.nu))
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
        for tgt in hold_targets(task, cfg, b, s0, g, 5):
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


# csrc/scene_tables.cuh SEC_*; the velocity solves are "free bodies and
# integration" and the five "solves: ..." parts
SECTIONS = ("fk", "contacts", "free bodies and integration", "impulse inverse masses",
            "warm start", "sweeps", "snap", "command map and cost", "solves: tree and RNEA",
            "solves: CRBA and drives", "solves: couple terms", "solves: Cholesky", "solves: psi")
SOLVES = (2, 8, 9, 10, 11, 12)


def sections(args, planner, world, step):
    """The clock64() split of K1 and K2 on one control step's inputs, and K1
    at one warp per block."""
    import ctypes

    from mppiisaac_tpu_torch.ops import native

    fr, fw = planner.mppi.fused, world._world_step
    seen = {}
    run1, run2 = fr.run, fw.step_rows
    fr.run = lambda *a: seen.setdefault("k1", a) and run1(*a)
    fw.step_rows = lambda *a, **kw: seen.setdefault("k2", (a, kw)) and run2(*a, **kw)
    step()
    fr.run, fw.step_rows = run1, run2
    lib = native.load_library()

    def k2():  # K2 as the step launched it, with its body rows
        a, kw = seen["k2"]
        return fw.step_rows(*a, **kw)

    out = (ctypes.c_ulonglong * (2 * len(SECTIONS)))()
    for kid, (name, fn, n_samples) in enumerate((
            ("K1", lambda: fr.run(*seen["k1"]), fr.K), ("K2", k2, 1))):
        fn()
        torch.cuda.synchronize()
        lib.read_sections(ctypes.cast(out, ctypes.c_void_p))
        for _ in range(args.steps):
            fn()
        lib.read_sections(ctypes.cast(out, ctypes.c_void_p))
        cyc = np.array(out[kid * len(SECTIONS):(kid + 1) * len(SECTIONS)], np.float64)
        per = cyc / (args.steps * n_samples)
        print(f"{name} sections ({args.task}, {args.steps} launches, cycles per sample and launch; "
              f"total {per.sum():.0f}):")
        for sec, c in zip(SECTIONS, per):
            print(f"  {sec:30s} {c:14.0f}  {c / max(per.sum(), 1):.4f}")
        sv = per[list(SOLVES)].sum()
        print(f"  {'velocity solves (all)':30s} {sv:14.0f}  {sv / max(per.sum(), 1):.4f}")
    from chip_smoke import cuda_time_ms

    k1 = cuda_time_ms(lambda: fr.run(*seen["k1"]))
    k2_ms = cuda_time_ms(k2)
    lib.set_rollout_threads(32)
    k1_32 = cuda_time_ms(lambda: fr.run(*seen["k1"]))
    lib.set_rollout_threads(0)
    print(f"K1 (section build, K={fr.K}): {k1:.3f} ms at the default block size, {k1_32:.3f} ms "
          f"at 32 threads per block; K2 {k2_ms:.3f} ms")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", choices=sorted({*OBJECTIVES, *POINT_PATHS, "box_pair", "bench",
                                             "ablations"}), default="panda")
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default="profile_out")
    ap.add_argument("--drift", metavar="STATES", help="measure float32 drift on the CPU instead")
    ap.add_argument("--sections", action="store_true",
                    help="the kernels' per-section cycle split instead of the profile")
    ap.add_argument("--k2-holds", type=int, metavar="EVERY",
                    help="K2 against plain float32 and float64 from every EVERY-th state")
    ap.add_argument("--first-touch", metavar="RECORD",
                    help="write the stick's first touching state of RECORD to --out")
    args = ap.parse_args()
    if args.first_touch:
        first_touch(args.first_touch, args.out)
        return
    if args.drift:
        drift(args.task, args.drift)
        return
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    if args.task == "box_pair":
        raise SystemExit("box_pair has no conf loop to profile (--drift only)")
    dev = torch.device("cuda")
    if args.sections:
        from mppiisaac_tpu_torch.ops import native

        native.VARIANT = "sections"
        _, _, ptxas = native.build()
        for line in ptxas.splitlines():
            if "registers" in line or "bytes stack frame" in line or "Compiling entry" in line:
                print("ptxas:", line.strip())
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
    if args.sections:
        sections(args, planner, world, step)
        return
    if args.k2_holds:
        k2_holds(args, cfg, world, step)
        return
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
