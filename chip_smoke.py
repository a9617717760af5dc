"""Chip smoke run of the PyTorch + CUDA port (mppiisaac_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. build the CUDA kernels from csrc/ (nvcc, sm_90a) and print the seconds
     and ptxas's register and stack-frame lines;
  2. panda reach: hold K1 (fused rollout) against its plain PyTorch version
     at the panda config (K=500, H=12) from the panda initial state with
     seeded random controls, and K2 (fused world step) against its plain
     version over 10 world steps;
  3. run the panda reach control loop (`run_task`, the user entry point) on
     the GPU until the end effector is within 0.1 m of the goal, within the
     conf's 200 steps;
  4. check the launch counters of that run: K1 once per command, K2 once per
     world step;
  5. panda_pick: run its control loop (`run_task`) at the shipped config
     (K=1000, H=12, 4 substeps, world fidelity, 1 sweep in K1, 16 in K2)
     until ‖block − goal‖ < 0.2 m, within 600 steps, and check its launch
     counters the same way;
  6. hold K1 and K2 against their plain versions at the pick config from two
     world states: the block settled on the table (20 world steps holding the
     arm still: the bp and bbc free-body impulses are live), and the state at
     the pick loop's success step (a held grasp: couple terms, Ψ, two-way
     sweeps, λ warm start and stiction snap are live); K2 over 5 world steps
     from each, λ rows included (bounds and their reasons at PICK_BOUNDS);
  7. time K1 and K2 on both paths against their plain versions (CUDA events;
     few repetitions of the plain versions, Python loops of small torch ops).
Prints the card's name and power limit, one JSON line describing the
kernels on each path, and as its last line `{"ok": true, "device": {...}}`.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# Tolerances. Each kernel is held against its float32 plain twin, which runs
# the same arithmetic in another evaluation order (FMA contraction, sums).
# Panda reach: on the CPU the twin in float32 and float64 differ by < 1e-6 in
# cost and state over the same runs, so these bounds leave two orders of
# magnitude.
COST_ATOL, COST_RTOL = 1e-4, 1e-4
STATE_ATOL, STATE_RTOL = 1e-4, 1e-4
# vis is rounded to bf16 like the TPU kernel's output: one bf16 ulp of a
# coordinate below 2 m is at most 7.8e-3, and the two versions may round a
# value that sits on a rounding boundary to neighbouring ulps
VIS_ATOL = 1e-2
# Panda pick (contacts, free body, couple contacts, impulse sweeps): the
# bounds below are 10× (or more) the drift of the float32 twin from the
# float64 twin, measured on the CPU at these settings and inputs (K=1000,
# H=12, 1 sweep in K1, 16 in K2), from the two states of phase 6:
# * settled block: K1 costs drift by 4.8e-5 at most (costs up to 48); K2
#   over 5 steps by 4.0e-6 in poses and joint angles, 1.6e-4 in velocities
#   and forces, 1.8e-8 in λ;
# * held grasp: the stiff couple contacts turn a float32 rounding into
#   ~1e-5 m of block motion in one substep and into centimetres over 12
#   steps, and their on/off switches (depth > 0, the stiction test, the
#   finger latch) flip for some samples. K1 costs drift by up to 0.11 at the
#   first step and 17.8 over the horizon (costs up to 27), with a median over
#   samples of 0.40; K2 over 5 steps by 1.3e-3 in poses, 6.7e-2 in velocities
#   and forces, 2.1e-6 in λ. So the held grasp holds K1 at its first step
#   and by the median over samples of each sample's largest difference.
PICK_BOUNDS = {
    "settled block": dict(k1_max=5e-4, pose=1e-4, vel=2e-3, lam=1e-6),
    "held grasp": dict(k1_first=1.2, k1_median=4.0, pose=1.5e-2, vel=0.7, lam=2.5e-5),
}
SEED = 0
PICK_MAX_STEPS = 600
SETTLE_STEPS = 20


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def within(name, got, ref, atol, rtol):
    err = (got.double() - ref.double()).abs()
    bound = atol + rtol * ref.double().abs()
    ok = bool(torch.isfinite(got).all()) and bool((err <= bound).all())
    rel = (err / ref.double().abs().clamp(min=1e-6)).max().item()
    print(f"  {name}: shape {tuple(got.shape)} max|d| {err.max().item():.3e} "
          f"max rel {rel:.3e} (atol {atol:g}, rtol {rtol:g}) {'ok' if ok else 'MISS'}", flush=True)
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err.max().item()


def cuda_time_ms(fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def main():
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: this smoke run needs a CUDA GPU")
        sys.exit(2)
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "mppiisaac_tpu_torch")):
        print("FAIL: mppiisaac_tpu_torch is not beside chip_smoke.py")
        sys.exit(2)
    sys.path.insert(0, root)
    if "jax" in sys.modules:
        fail("jax is imported")
    from mppiisaac_tpu_torch.ops import native
    from mppiisaac_tpu_torch.ops.fused_rollout import FusedRollout, FusedWorldStep
    from mppiisaac_tpu_torch.physics.types import ModelParams
    from mppiisaac_tpu_torch.runtime.loop import run_task
    from mppiisaac_tpu_torch.runtime.sim import Simulation, broadcast_state
    from mppiisaac_tpu_torch.tasks import panda_pick
    from mppiisaac_tpu_torch.tasks.panda_reach import PandaReachObjective, success_fn
    from mppiisaac_tpu_torch.utils.config_store import load_config

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    # ---- 1. build ----
    t0 = time.perf_counter()
    path, nvcc_s, ptxas = native.build()
    native.load_library()
    print(f"[1] build: nvcc {nvcc_s:.1f} s, build+load {time.perf_counter() - t0:.1f} s -> "
          f"{os.path.relpath(path, root)}")
    for line in ptxas.splitlines():
        if "registers" in line or "bytes stack frame" in line:
            print("    ptxas:", line.strip())

    # ---- 2. panda reach: kernels against their plain versions ----
    cfg = load_config("tasks/panda")
    K, H = cfg.mppi.num_samples, cfg.mppi.horizon
    obj = PandaReachObjective(cfg)
    world = Simulation(cfg.isaacgym, cfg.actors, cfg.initial_actor_positions, num_envs=1, device=dev)
    built = world.built
    fr = FusedRollout(built, world.engine, obj.kernel_cost(built), H, K,
                      vis_body=built.visualize_bodies[0], impulse_sweeps=cfg.mppi.rollout_sweeps)
    g = torch.Generator().manual_seed(SEED)
    V = (torch.rand(K, H, fr.nu, generator=g) * 4.0 - 2.0).to(dev)
    st_K = broadcast_state(world.state.map(lambda x: x[0]), K)
    params_K = ModelParams(torch.ones(K, built.scene.nbody, device=dev),
                           torch.ones(K, built.scene.ngeom, device=dev))
    k1_in = fr.pack(st_K, params_K, V)
    costs, vis = fr.run(*k1_in)
    torch.cuda.synchronize()
    costs_p, vis_p = fr.plain(*k1_in)
    print(f"[2] panda reach: K1 fused_rollout_kernel vs plain at K={K}, H={H}, nu={fr.nu}, "
          f"{fr.substeps} substeps, rows={fr.ks.n_rows}")
    k1_err = within("costs", costs, costs_p, COST_ATOL, COST_RTOL)
    within("vis", vis, vis_p, VIS_ATOL, 0.0)

    fw = FusedWorldStep(built, world.engine, impulse_sweeps=cfg.isaacgym.fused_world_sweeps)
    rows = fw.pack(world.state.map(lambda x: x[0])).contiguous()
    rows_p = rows.clone()
    ones_b = torch.ones(built.scene.nbody, device=dev)
    ones_g = torch.ones(built.scene.ngeom, device=dev)
    for i in range(10):
        tgt = (torch.rand(built.scene.ndof, generator=g) * 4.0 - 2.0).to(dev)
        rows = fw.step_rows(rows, tgt, ones_b, ones_g)
        rows_p = fw.plain(rows_p, tgt, ones_b, ones_g)
    torch.cuda.synchronize()
    print(f"    K2 fused_world_step_kernel vs plain over 10 world steps ({fw.substeps} substeps each)")
    k2_err = within("world rows", rows, rows_p, STATE_ATOL, STATE_RTOL)

    # ---- 3. + 4. the panda reach control loop, with the launch counters ----
    FusedRollout.launches = 0
    FusedWorldStep.launches = 0
    t0 = time.perf_counter()
    m = run_task(cfg, PandaReachObjective(cfg), success_fn=success_fn(), device=dev)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    n_k1, n_k2 = FusedRollout.launches, FusedWorldStep.launches
    print(f"[3] run_task panda K={K} H={H} on cuda: success_step {m.success_step}, "
          f"{m.steps} steps in {loop_s:.2f} s, median solver {np.median(m.solver_time) * 1e3:.3f} "
          f"ms/step, median control step {1e3 / float(np.median(m.fps)):.3f} ms, "
          f"finite {m.final_state_finite}")
    if m.success_step is None:
        fail("panda did not reach its goal within the conf's steps")
    if not m.final_state_finite:
        fail("non-finite world state")
    print(f"[4] launches in the loop: K1 {n_k1} (commands {m.steps}), K2 {n_k2} (world steps {m.steps})")
    if n_k1 != m.steps or n_k2 != m.steps or n_k1 == 0:
        fail("launch counters do not match the commands and world steps run")
    reach = dict(k1_in=k1_in, k2_in=(rows, tgt, ones_b, ones_g), fr=fr, fw=fw,
                 n_k1=n_k1, n_k2=n_k2, k1_err=k1_err, k2_err=k2_err)

    # ---- 5. the panda_pick control loop, with the launch counters ----
    pcfg = load_config("tasks/panda_pick")
    pcfg.n_steps = PICK_MAX_STEPS
    last = {}
    FusedRollout.launches = 0
    FusedWorldStep.launches = 0
    t0 = time.perf_counter()
    pm = run_task(pcfg, panda_pick.PandaPickObjective(pcfg), success_fn=panda_pick.success_fn(),
                  observer=lambda step, w, a: last.update(state=w.state), device=dev)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    p_k1, p_k2 = FusedRollout.launches, FusedWorldStep.launches
    print(f"[5] run_task panda_pick K={pcfg.mppi.num_samples} H={pcfg.mppi.horizon} on cuda: "
          f"success_step {pm.success_step} (the JAX package: steps 145-385 over 10 seeds), "
          f"{pm.steps} steps in {loop_s:.2f} s, median solver {np.median(pm.solver_time) * 1e3:.3f} "
          f"ms/step, median control step {1e3 / float(np.median(pm.fps)):.3f} ms, "
          f"finite {pm.final_state_finite}")
    if pm.success_step is None:
        fail(f"panda_pick did not bring the block within 0.2 m of the goal in {PICK_MAX_STEPS} steps")
    if not pm.final_state_finite:
        fail("non-finite world state")
    print(f"    launches in the loop: K1 {p_k1} (commands {pm.steps}), K2 {p_k2} (world steps {pm.steps})")
    if p_k1 != pm.steps or p_k2 != pm.steps or p_k1 == 0:
        fail("launch counters do not match the commands and world steps run")

    # ---- 6. pick: kernels against their plain versions from two states ----
    pworld = Simulation(pcfg.isaacgym, pcfg.actors, pcfg.initial_actor_positions, num_envs=1, device=dev)
    pb = pworld.built
    pfw = FusedWorldStep(pb, pworld.engine, impulse_sweeps=pcfg.isaacgym.fused_world_sweeps)
    pones_b = torch.ones(pb.scene.nbody, device=dev)
    pones_g = torch.ones(pb.scene.ngeom, device=dev)
    pparams = ModelParams(pones_b, pones_g)
    settled = pworld.state.map(lambda x: x[0])
    hold = settled.q.clone()
    for _ in range(SETTLE_STEPS):
        settled = pfw.step(settled.replace(dof_target=hold), pparams)
    held = last["state"].map(lambda x: x[0])
    PK, PH = pcfg.mppi.num_samples, pcfg.mppi.horizon
    pfr = FusedRollout(pb, pworld.engine, panda_pick.PandaPickObjective(pcfg).kernel_cost(pb), PH, PK,
                       vis_body=pb.visualize_bodies[0], impulse_sweeps=pcfg.mppi.rollout_sweeps)
    pparams_K = ModelParams(torch.ones(PK, pb.scene.nbody, device=dev),
                            torch.ones(PK, pb.scene.ngeom, device=dev))
    print(f"[6] panda_pick: K1 vs plain at K={PK}, H={PH}, nu={pfr.nu}, {pfr.substeps} substeps, "
          f"{pfr.impulse_sweeps} sweep(s), rows={pfr.ks.n_rows}; K2 vs plain over 5 world steps, "
          f"{pfw.impulse_sweeps} sweeps")
    pick_err = {}
    for name, s0 in (("settled block", settled), ("held grasp", held)):
        bound = PICK_BOUNDS[name]
        gp = torch.Generator().manual_seed(SEED)
        PV = (torch.rand(PK, PH, pfr.nu, generator=gp) * 0.6 - 0.3).to(dev)
        k1p_in = pfr.pack(broadcast_state(s0, PK), pparams_K, PV)
        c, v = pfr.run(*k1p_in)
        torch.cuda.synchronize()
        cp, vp = pfr.plain(*k1p_in)
        if not bool(torch.isfinite(c).all()):
            fail(f"{name}: K1 costs are not finite")
        d = (c.double() - cp.double()).abs()
        err = dict(max=d.max().item(), first=d[:, 0].max().item(),
                   median=d.max(1).values.median().item())
        checks = [(k, err[k[3:]], b) for k, b in bound.items() if k.startswith("k1_")]
        print(f"  {name}: K1 costs {tuple(c.shape)} max|d| {err['max']:.3e}, first step "
              f"{err['first']:.3e}, median over samples {err['median']:.3e} (bounds "
              f"{', '.join(f'{k[3:]} {b:g}' for k, _, b in checks)})", flush=True)
        if any(e > b for _, e, b in checks):
            fail(f"{name}: K1 disagrees with its plain version")
        within(f"{name}: vis", v, vp, VIS_ATOL, 0.0)
        r = pfw.pack(s0).contiguous()
        rp = r.clone()
        for i in range(5):
            ptgt = s0.q + (torch.rand(pb.scene.ndof, generator=gp) * 0.4 - 0.2).to(dev)
            ptgt[7:9] = s0.dof_target[7:9]
            r = pfw.step_rows(r, ptgt, pones_b, pones_g)
            rp = pfw.plain(rp, ptgt, pones_b, pones_g)
        torch.cuda.synchronize()
        ks = pfw.ks
        A, D, NS = ks.nactor, ks.ndof, ks.n_state_rows
        dd = (r.double() - rp.double()).abs()
        root = dd[: 13 * A].reshape(A, 13)
        groups = dict(pose=max(root[:, :7].max().item(), dd[13 * A: 13 * A + D].max().item()),
                      vel=max(root[:, 7:].max().item(), dd[13 * A + D: NS].max().item()),
                      lam=dd[NS:].max().item())
        print(f"  {name}: K2 rows after 5 steps: max|d| " + ", ".join(
            f"{k} {e:.3e} (bound {bound[k]:g})" for k, e in groups.items()), flush=True)
        if not bool(torch.isfinite(r).all()) or any(e > bound[k] for k, e in groups.items()):
            fail(f"{name}: K2 disagrees with its plain version")
        if float(rp[NS:].abs().max()) == 0.0:
            fail(f"{name}: no λ row carried a contact impulse")
        pick_err[name] = (err, max(groups.values()))

    # ---- 7. timing ----
    times = {}
    for key, f_, k1_in_, k2_in_, k1_reps in (
            ("reach", reach["fr"], reach["k1_in"], reach["k2_in"], 5),
            ("pick", pfr, k1p_in, (r, ptgt, pones_b, pones_g), 2)):
        fwx = reach["fw"] if key == "reach" else pfw
        times[key] = (cuda_time_ms(lambda: f_.run(*k1_in_)),
                      cuda_time_ms(lambda: f_.plain(*k1_in_), reps=k1_reps, warmup=1),
                      cuda_time_ms(lambda: fwx.step_rows(*k2_in_)),
                      cuda_time_ms(lambda: fwx.plain(*k2_in_), reps=5, warmup=1))
        print(f"[7] {key}: K1 {times[key][0]:.3f} ms vs plain {times[key][1]:.3f} ms; "
              f"K2 {times[key][2]:.3f} ms vs plain {times[key][3]:.3f} ms (medians)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip()
          else f"nvidia-smi unavailable (rc {smi.returncode})")
    src = "mppiisaac_tpu_torch/csrc/fused_rollout.cu"
    entries = []
    for key, n1, n2, e1, e2 in (("panda_reach", reach["n_k1"], reach["n_k2"], reach["k1_err"],
                                 reach["k2_err"]),
                                ("panda_pick", p_k1, p_k2, pick_err["settled block"][0]["max"],
                                 pick_err["settled block"][1])):
        t = times["reach" if key == "panda_reach" else "pick"]
        entries += [
            {"name": "fused_rollout_kernel", "path": key, "route": "cuda", "source": src,
             "replaces": "mppiisaac_tpu/ops/pallas/fused_rollout.py:367",
             "launches": n1, "max_abs_err": e1, "ms": t[0], "plain_ms": t[1]},
            {"name": "fused_world_step_kernel", "path": key, "route": "cuda", "source": src,
             "replaces": "mppiisaac_tpu/ops/pallas/fused_rollout.py:533",
             "launches": n2, "max_abs_err": e2, "ms": t[2], "plain_ms": t[3]},
        ]
        if key == "panda_pick":
            held_k1, held_k2 = pick_err["held grasp"]
            entries[-2].update(held_grasp_first_step_max_abs_err=held_k1["first"],
                               held_grasp_median_max_abs_err=held_k1["median"],
                               held_grasp_max_abs_err=held_k1["max"])
            entries[-1].update(held_grasp_max_abs_err=held_k2)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
