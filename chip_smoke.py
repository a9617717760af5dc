"""Chip smoke run of the PyTorch + CUDA port (mppiisaac_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. build the CUDA kernels from csrc/ (nvcc, sm_90a) and print the seconds,
     ptxas's register and stack-frame lines, and each kernel's launch
     geometry at every timed path's conf: one warp per sample, W warps per
     block, the blocks at the path's K, the shared memory per block (the
     scene tables and W regions of one sample's state and temporaries);
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
     both states go to chiprun_out/panda_pick_states.pt;
  7. the mobile-robot loops (`run_task`) at their shipped configs, each to
     its goal within its conf's steps, with the launch counters checked:
     boxer_push (K=400, H=12: a floating-base boxer with stiction, couple
     and cc contacts) and heijn_push to ‖block − goal‖ < 0.2 m, boxer_reach
     and heijn_reach to ‖base − goal‖ < 0.15 m; the boxer_push loop keeps
     the world state of the first step at which the boxer touches the block;
  8. hold K1 and K2 against their plain versions at the boxer_push config
     (K=400, H=12, 2 sweeps in K1, 16 in K2) from two world states: the
     initial state (the boxer resting on its wheels: the floating base and
     the stiction blocks are live) and the touching state of phase 7 (couple
     blocks on a floating actor, cc and the two-way sweeps live); K2 over 5
     world steps from each, λ rows included (bounds at BOXER_BOUNDS); both
     states go to chiprun_out/boxer_push_states.pt;
  9. the point-robot loops (`run_task` through each task's own objective and
     success test) at their shipped configs, with the launch counters
     checked: point_robot (K=100, H=20) to within 0.1 m of its goal in 100
     steps, alone and with the sphere paper_obst1 as its obstacle (the scene
     the JAX package's benchmark runner builds), and multi_pointbot (K=200,
     H=20) both robots within 0.2 m of their goals in 200; each then holds
     K1 (all samples) and K2 against their plain versions from the initial
     state and a state of its loop: point_robot's after 20 steps, the others'
     at the step where the robot is closest to the obstacle or to the other
     robot (POINT_BOUNDS); the states go to chiprun_out/<path>_states.pt;
 10. panda_effort (K=500, H=8, simple mode, 7 effort-driven joints) to within
     0.1 m of its goal in 500 steps, launch counters checked; then K1 and K2
     against their plain versions from the initial state and the loop's
     state after 20 steps (bounds at EFFORT_BOUNDS);
 11. panda_stick_push (K=1000, H=12) for 200 steps, launch counters checked:
     fails unless a stick–block λ row carried an impulse, and prints ‖block −
     goal‖ at the start and the end; K1 and K2 against their plain versions
     from the initial state and the first touching state (STICK_BOUNDS; at
     the touching state a K1 bound is 10× the plain K1's own
     float32-vs-float64 drift there where that is larger: touch_bounds);
 12. omni_panda_pick (K=750, H=6, 8 sweeps in K1, effort drives with the
     finger motor) for 150 steps, launch counters checked: fails on a
     non-finite state or if the finger dofs never move; K1 and K2 against
     their plain versions from the initial state and the loop's last state
     (OMNI_BOUNDS). The states of phases 10-12 go to
     chiprun_out/<task>_states.pt;
 13. multi_jackal (K=300, H=12, two mesh-fitted floating jackals) until both
     are within 0.25 m of their goals, within 400 steps (twice the conf's:
     see MESH_LOOPS); 14. albert (K=500,
     H=8, a mesh-fitted diff-drive base with a 7-dof arm: TASK_ALBERT) until
     its end effector is within 0.15 m of the goal, within 500 steps; each
     with the launch counters checked, then K1 and K2 against their plain
     versions from the initial state (resting on the wheels) and the loop's
     state after MOTION_STEP steps (MESH_BOUNDS);
 15. anymal at its shipped config (K=400, H=12, dt 0.1, TASK_ANYMAL, the
     gait tape prior with prior_blend 0.5) for ANYMAL_STEPS steps from its
     drop start: fails on a non-finite state, on launch counters that do not
     match, or if the prior's tape was not injected into every command;
     prints ‖base_xy − goal_xy‖ at the start and the end and the success
     step, beside the JAX package's; then the same with
     `mppi.use_priors=false mppi.seed_val=0` (no tape injected). Neither
     fails on success. K1 and K2 against their plain versions from the
     prior run's state after landing (step LANDED_STEP) and its last state
     (ANYMAL_BOUNDS);
 16. panda_pick at fast fidelity with the reduced manifold
     (`mppi.rollout_fidelity=fast mppi.rollout_manifold=reduced`: no λ rows
     in K1, its own 8-sample box–box tables) for 50 loop steps, launch
     counters checked; then K1 against its plain version from phase 6's
     settled block and held grasp (FAST_PICK_BOUNDS; K2 is the pick world's);
 17. the full box–box manifold (bbA/bbB, which no shipped table emits): two
     free boxes, the top one pressed onto the other and sliding across it,
     on tables from physics/contact.full_box_manifold; BOX_STEPS steps of the
     MPPI solver with K1 (K=256, H=12) and K2, launch counters checked and
     the bb candidates' λ rows live; K1 and K2 against their plain versions
     from the sliding state (BOX_BOUNDS). The states of phases 13-17 go to
     chiprun_out/<path>_states.pt;
 18. time K1 and K2 on the reach, pick, boxer_push, panda_stick_push,
     omni_panda_pick, multi_jackal, albert, anymal, fast-pick and box-pair
     paths against their plain versions (CUDA events). To keep the run
     short, the plain K1 of phases 10-16 runs on the first PLAIN_K1_SAMPLES
     samples of the same packed inputs (samples are independent: the
     kernel's first costs are held against them); each path's plain K1 runs
     once over its hold states' samples side by side, and its plain K2
     steps those states as one batch (hold_k1s, hold_k2s); and the plain
     versions of every path but reach are timed once, in their holds
     (Python loops of small torch ops, seconds each); each path's phases
     print their seconds. The earlier paths keep their depth. Each kernel
     entry also gives its launch geometry (warps_per_block, smem_bytes);
     each path's line before them prints how many times faster both kernels
     are than with one thread per sample (EARLIER_MS, PR 5's times).
Each kernel's bound — the least time the card could take for the same work —
is the larger of its bytes (inputs read once, outputs written once) over
3.35 TB/s and its float32 operations over 67 TFLOP/s; the operations are
counted on the plain version's first substep from the same inputs (one per
element of each arithmetic op, 2mnk per matrix product; the work of contact
blocks scaled by the share of (sample, block) pairs whose gate is on, which
is what the kernel computes), times the substeps and steps.
Prints the card's name and power limit, one JSON line describing the
kernels on each path, and as its last line `{"ok": true, "device": {...}}`.
"""
import dataclasses
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
#   The vis body's path in the held grasp parts the same way and is held the
#   same way (hold_k1s). (Drift measured at the grasp of the loop's step 144,
#   before the solver drew the JAX package's noise; the loop now succeeds at
#   step 197, where kernel and plain version differ by less.)
PICK_BOUNDS = {
    "settled block": dict(k1_max=5e-4, pose=1e-4, vel=2e-3, lam=1e-6),
    "held grasp": dict(k1_first=1.2, k1_median=4.0, pose=1.5e-2, vel=0.7, lam=2.5e-5),
}
# boxer_push (K=400, H=12, 2 sweeps in K1, 16 in K2): 10× (or more) the drift
# of the float32 twin from the float64 twin on the CPU from the two states of
# phase 8 (`scripts/profile_torch_step.py --task boxer_push --drift`):
# * initial: the boxer, the block and both spheres start at exactly zero
#   depth on the ground, so float32 and float64 disagree on which contacts
#   are active; the spheres' lateral contact forces, weighted 100 in the push
#   cost, make that 0.145 of cost in every sample from the first step (costs
#   up to 4.1), and K2 over 5 steps drifts by 1.3e-3 in poses, 0.55 in
#   velocities (the settling wheels), 3.3e-3 in λ. Held by the maximum.
# * touching (the first step of the loop at which a boxer–block contact
#   carries an impulse): a couple contact on the floating base, sensitive as
#   pick's held grasp: K1 drifts by 2.8e-3 at the first step, 5.7e-3 as the
#   median over samples and 3.5e-2 at most (costs up to 3.5); K2 by 2.2e-6 in
#   poses, 1.3e-3 in velocities, 2.8e-5 in λ. Held at the first step and by
#   the median, as the grasp is.
BOXER_BOUNDS = {
    "initial": dict(k1_max=1.5, pose=1.5e-2, vel=6.0, lam=3.5e-2),
    "touching": dict(k1_first=3e-2, k1_median=6e-2, pose=2.5e-5, vel=1.5e-2, lam=3e-4),
}
# panda_effort, panda_stick_push and omni_panda_pick (phases 10-12): 10× (or
# more) the drift of the float32 twin from the float64 twin on the CPU, from
# the same states with the same inputs (`scripts/profile_torch_step.py
# --task <task> --drift chiprun_out/<task>_states.pt`, K1 on the first
# PLAIN_K1_SAMPLES samples):
# * panda_effort (no contact in reach; initial and step 20): K1 costs drift
#   by 9.7e-7 at most (costs up to 1.7); K2 over 5 steps by 1.5e-7 in poses,
#   6.7e-7 in velocities (no λ rows);
# * panda_stick_push initial: K1 4.7e-5 (costs up to 64); K2 1.5e-6 / 2.2e-5
#   / 3.0e-7 in λ. Touching (the loop's first step at which a stick–block λ
#   row carries an impulse): the stick pressing the block turns roundings
#   into switched contacts, as pick's grasp does: K1 1.4e-4 at the first
#   step, 2.8e-4 as the median over samples, 0.39 at most (costs up to 38);
#   K2 1.6e-6 / 1.4e-4 / 1.4e-8. Held at the first step and by the median;
# * omni_panda_pick initial: the block and the base start at zero depth, so
#   K2's velocities drift by 1.6e-3 (poses 8.4e-7, λ 1.3e-6), K1 by 2.6e-4
#   (costs up to 36); its last state (step 150): K1 2.5e-4, K2 3.8e-7 /
#   2.7e-4 / 1.2e-7 — no sensitive contact there, so held by the maximum.
# point_robot, point_robot_obst1 and multi_pointbot (phase 9): 10× (or more)
# the same drift (`--task <path> --drift chiprun_out/<path>_states.pt`, K1 on
# all samples; the floors where it is 0: 1e-6), from the two states of each:
# * point_robot (one bp block, nothing swept): initial K1 3.3e-7 (costs up to
#   3.2), K2 over 5 steps 2.1e-8 in poses, 1.9e-7 in velocities; step 20 K1
#   8.2e-7, K2 5.4e-8 / 2.3e-7;
# * point_robot_obst1 initial: the obstacle starts at zero depth on the
#   ground, so K2 drifts by 2.3e-5 / 7.7e-3 / 4.8e-5 in λ (K1 6.8e-7, costs
#   up to 3.2); closest (the robot pushing the obstacle, step 16 of the
#   loop): K1 4.6e-4 at most (costs up to 2.2), 2.1e-7 at the first step,
#   1.2e-6 as the median; K2 1.0e-5 / 2.0e-4 / 7.8e-7. Held by the maximum;
# * multi_pointbot (the robots' xy are dof coordinates, both 0 at the start,
#   so the separation term is on in both states; nothing swept): initial K1
#   9.9e-7 (costs up to 5.5), K2 1.4e-8 / 7.1e-8; closest (step 0) K1
#   8.6e-7, K2 2.0e-8 / 9.0e-8.
POINT_BOUNDS = {
    "point_robot": {"initial": dict(k1_max=5e-6, pose=5e-7, vel=2e-6, lam=1e-6),
                    "step 20": dict(k1_max=1e-5, pose=6e-7, vel=2.5e-6, lam=1e-6)},
    "point_robot_obst1": {"initial": dict(k1_max=1e-5, pose=2.5e-4, vel=8e-2, lam=5e-4),
                          "closest": dict(k1_max=5e-3, pose=1.1e-4, vel=2e-3, lam=8e-6)},
    "multi_pointbot": {"initial": dict(k1_max=1e-5, pose=2e-7, vel=1e-6, lam=1e-6),
                       "closest": dict(k1_max=1e-5, pose=2e-7, vel=1e-6, lam=1e-6)},
}
EFFORT_BOUNDS = {
    "initial": dict(k1_max=1e-5, pose=2e-6, vel=1e-5, lam=1e-6),
    "step 20": dict(k1_max=1e-5, pose=2e-6, vel=1e-5, lam=1e-6),
}
STICK_BOUNDS = {
    "initial": dict(k1_max=5e-4, pose=1.5e-5, vel=2.5e-4, lam=3e-6),
    "touching": dict(k1_first=1.5e-3, k1_median=3e-3, pose=2e-5, vel=1.5e-3, lam=1.5e-7),
}
OMNI_BOUNDS = {
    "initial": dict(k1_max=3e-3, pose=1e-5, vel=1.6e-2, lam=1.5e-5),
    "last": dict(k1_max=3e-3, pose=4e-6, vel=3e-3, lam=1.5e-6),
}
# multi_jackal, albert, anymal, fast-fidelity pick and the box pair (phases
# 13-17): 10× the same drift (`scripts/profile_torch_step.py --task <path>
# --drift chiprun_out/<path>_states.pt`; K1 on the first PLAIN_K1_SAMPLES
# samples but for the box pair), rounded up:
# * multi_jackal initial (both jackals resting on their mesh-fitted wheels,
#   which start at zero depth): K1 3.2e-2 at most (costs up to 4.9), 8.1e-7
#   at the first step, 5.1e-5 as the median — the wheels' contacts switch
#   for some samples, as in motion, so it is held at the first step and by
#   the median (a vis body's path missed VIS_ATOL by 0.0186 in 2 of 4608
#   coordinates on the card from other controls); K2 1.6e-6 / 1.8e-2 /
#   2.9e-4 in λ. In motion (step MOTION_STEP of the loop): K1 0.99 at most (costs up
#   to 6.7), 5.2e-5 at the first step, 4.6e-4 as the median — switched
#   wheel contacts, held at the first step and by the median; K2 2.2e-5 /
#   3.1e-2 / 2.9e-5;
# * albert initial: K1 8.8e-7 (costs up to 2.3); K2 3.4e-7 / 1.6e-4 /
#   7.4e-7. In motion: K1 5.3e-7; K2 8.1e-7 / 2.3e-4 / 2.8e-6;
# * anymal landed (step LANDED_STEP of the prior run) and last (its step
#   ANYMAL_STEPS): K1 up to 1.6 and 2.8 (costs up to 15), 5.9e-5 and 9.0e-6
#   at the first step, 3.4e-3 and 3.3e-3 as the median — twelve feet and
#   knees on and off the ground: held at the first step and by the median;
#   K2 over 5 steps 1.2e-4 / 5.1 / 3.0e-2 after landing (a leg's joint
#   speed parts after a switched foot contact) and 3.1e-6 / 8.5e-2 / 1.3e-4
#   at the last state;
# * pick at fast fidelity: settled block K1 3.1e-5 (costs up to 47); held
#   grasp 0.22 at most, 9.8e-6 at the first step, 3.7e-4 as the median
#   (held as the world-fidelity grasp is);
# * the box pair, sliding: K1 1.4e-4 (all 256 samples, costs up to 8.8);
#   K2 5.6e-7 / 4.8e-5 / 7.0e-7.
MESH_BOUNDS = {
    "multi_jackal": {"initial": dict(k1_first=8.1e-6, k1_median=5.1e-4, pose=1.6e-5, vel=0.19,
                                     lam=2.9e-3),
                     "in motion": dict(k1_first=5.2e-4, k1_median=4.6e-3, pose=2.2e-4, vel=0.32,
                                       lam=2.9e-4)},
    "albert": {"initial": dict(k1_max=9e-6, pose=3.4e-6, vel=1.6e-3, lam=7.4e-6),
               "in motion": dict(k1_max=6e-6, pose=8.2e-6, vel=2.4e-3, lam=2.9e-5)},
}
ANYMAL_BOUNDS = {
    "landed": dict(k1_first=6e-4, k1_median=3.4e-2, pose=1.2e-3, vel=51.0, lam=0.3),
    "last": dict(k1_first=9e-5, k1_median=3.3e-2, pose=3.1e-5, vel=0.85, lam=1.3e-3),
}
FAST_PICK_BOUNDS = {
    "settled block": dict(k1_max=3.1e-4),
    "held grasp": dict(k1_first=9.8e-5, k1_median=3.7e-3),
}
BOX_BOUNDS = {"sliding": dict(k1_max=1.5e-3, pose=5.6e-6, vel=4.8e-4, lam=7e-6)}
PLAIN_K1_SAMPLES = 128
# the holds' controls: uniform in ±HOLD_AMP·u_max for each control
HOLD_AMP = {"panda_effort": 0.3, "panda_stick_push": 1.0, "omni_panda_pick": 0.3,
            "point_robot": 1.0, "point_robot_obst1": 1.0, "multi_pointbot": 1.0,
            "multi_jackal": 1.0, "albert": 1.0, "anymal": 0.5, "panda_pick_fast": 1.0,
            "box_pair": 1.0}
FAST_OVERRIDES = ["mppi.rollout_fidelity=fast", "mppi.rollout_manifold=reduced"]
MOTION_STEP = 40        # phases 13-14: the hold state in motion, after this many steps
ANYMAL_STEPS = 200
LANDED_STEP = 15        # anymal drops from 1.2 m and lands near step 5 (dt 0.1)
FAST_PICK_STEPS = 50
BOX_STEPS = 20
# phase 17: two free boxes in the air, the top one (under gravity) 5 mm into
# the other (gravity off), and a point robot (collision off) for controls
BOX_PAIR = [
    dict(type="box", name="base_box", size=[0.4, 0.3, 0.2], mass=2.0, init_pos=[0.0, 0.0, 1.0],
         friction=0.8, gravity=False),
    dict(type="box", name="top_box", size=[0.2, 0.2, 0.2], mass=1.0, init_pos=[0.05, 0.0, 1.195],
         friction=0.8),
    dict(type="robot", name="point_robot", urdf_file="point_robot.urdf", fixed=True,
         collision=False, init_pos=[2.0, 2.0, 0.0]),
]
# K1 and K2 ms of each timed path with one thread per sample (PERF.md §6,
# the last call before the warp-per-sample kernels; NVIDIA H100 80GB HBM3,
# 700 W)
EARLIER_MS = {"panda_reach": (4.135, 0.395), "panda_pick": (58.148, 14.694),
              "boxer_push": (37.004, 9.306), "panda_stick_push": (32.954, 5.769),
              "omni_panda_pick": (40.224, 9.614), "multi_jackal": (47.514, 8.103),
              "albert": (47.831, 13.111), "anymal": (226.616, 33.143),
              "panda_pick_fast": (35.808, 14.510), "box_pair": (15.496, 5.699)}
# the timed paths' confs (phase 1's geometry table)
GEOMETRY_TASKS = ("panda", "panda_pick", "boxer_push", "panda_stick_push", "omni_panda_pick",
                  "multi_jackal", "albert", "anymal")

SEED = 0
PICK_MAX_STEPS = 600
SETTLE_STEPS = 20
# the mobile loops: (task, module, robot, the JAX package's success step)
MOBILE_LOOPS = (("boxer_push", "mobile_push", "boxer", "67-71 over 4 seeds"),
                ("heijn_push", "mobile_push", "heijn", "97"),
                ("boxer_reach", "mobile_reach", "boxer", "252"),
                ("heijn_reach", "mobile_reach", "heijn", "101"))
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12      # H100 SXM: float32 outside the tensor cores, HBM3
_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "neg", "sqrt", "rsqrt", "reciprocal", "clamp",
    "clamp_min", "clamp_max", "maximum", "minimum", "abs", "sin", "cos", "atan2", "asin", "where",
    "gt", "lt", "ge", "le", "eq", "ne", "pow", "exp", "sign", "addcmul", "logical_and",
    "logical_or", "logical_not", "bitwise_and", "bitwise_or", "bitwise_not",
}
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "prod"}


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


class OpCount:
    """Float32 operations of the plain version: one per output element of
    each arithmetic op, one per input element of a reduction, 2mnk per
    matrix product. Contact-block work (contacts and the impulse pass) is
    counted apart and scaled by the share of (sample, block) pairs whose
    gate is on: the plain version evaluates every block and masks the
    separated ones, the kernel skips them."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                name = func.__name__.split(".")[0].rstrip("_")
                n = 0
                if name in _ELEMENTWISE:
                    n = out.numel()
                elif name in _REDUCE:
                    n = args[0].numel()
                elif name in ("mm", "bmm"):
                    n = 2 * args[0].numel() * args[1].shape[-1]
                counter.ops[counter.label] += n
                return out

        self.mode = Mode()
        self.ops = {"block": 0, "rest": 0}
        self.label = "rest"
        self.gates = [0, 0]

    def __enter__(self):
        from mppiisaac_tpu_torch.ops import fused_contacts, fused_physics

        self._saved = [(fused_physics, "contacts"), (fused_physics, "impulse_pass"),
                       (fused_contacts, "block_gate")]
        self._saved = [(m, n, getattr(m, n)) for m, n in self._saved]

        def labelled(fn):
            def run(*a, **k):
                self.label = "block"
                try:
                    return fn(*a, **k)
                finally:
                    self.label = "rest"
            return run

        gate = fused_contacts.block_gate

        def counted_gate(ks, bi, pos, quat):
            live = gate(ks, bi, pos, quat)
            S = int(ks.blk_S[bi])
            self.gates[0] += S * int(live.sum())
            self.gates[1] += S * live.numel()
            return live

        fused_physics.contacts = labelled(fused_physics.contacts)
        fused_physics.impulse_pass = labelled(fused_physics.impulse_pass)
        fused_contacts.block_gate = counted_gate
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)
        for m, n, fn in self._saved:
            setattr(m, n, fn)

    @property
    def live_share(self):
        return self.gates[0] / max(self.gates[1], 1)

    @property
    def flops(self):
        return self.ops["rest"] + self.ops["block"] * self.live_share


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def k1_bound(fr, k1_in):
    """(bound ms, bound_by, flops, bytes, live share) of K1 on these inputs."""
    from mppiisaac_tpu_torch.ops import fused_physics as fp

    rows, V, mass, fric = k1_in
    with torch.no_grad(), OpCount() as c:
        st = fp.rows_to_state(fr.ks, rows)
        tgt = fp.command_targets(fr.ks, V[0].T.float(), st["q"])
        st = fp.substep(fr.ks, st, tgt, mass.T, fric.T, fr.dt_sub, fr.impulse_sweeps,
                        fr.world_fidelity)
        sub = c.flops
        pos, quat, _, _, _ = fp.fk(fr.ks, st)
        fp.task_cost(fr.ks, st, pos, quat)
    flops = sub * fr.substeps * fr.H + (c.flops - sub) * fr.H
    nbytes = _nbytes(rows, V, mass, fric) + len(fr._tables._bytes) + fr.K * fr.H * 4 * 4
    return _bound(flops, nbytes) + (c.live_share,)


def k2_bound(fw, k2_in):
    """(bound ms, bound_by, flops, bytes, live share) of K2 on these inputs."""
    from mppiisaac_tpu_torch.ops import fused_physics as fp

    rows, tgt, mass, fric = k2_in
    with torch.no_grad(), OpCount() as c:
        st = fp.rows_to_state(fw.ks, rows[:, None])
        fp.substep(fw.ks, st, tgt[None], mass[None], fric[None], fw.dt_sub, fw.impulse_sweeps)
    flops = c.flops * fw.substeps
    nbytes = 2 * _nbytes(rows) + _nbytes(tgt, mass, fric) + len(fw._tables._bytes)
    return _bound(flops, nbytes) + (c.live_share,)


def _bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def hold_controls(task, cfg, g, shape):
    """The holds' controls of phases 9-12: uniform in ±HOLD_AMP·u_max, drawn
    from g on the CPU (scripts/profile_torch_step.py --drift draws the same)."""
    amp = HOLD_AMP[task] * torch.as_tensor(cfg.mppi.u_max, dtype=torch.float32)
    return (torch.rand(shape, generator=g) * 2.0 - 1.0) * amp


class Timer:
    """Milliseconds of the enclosed GPU work (CUDA events)."""

    def __enter__(self):
        self.a = torch.cuda.Event(enable_timing=True)
        self.b = torch.cuda.Event(enable_timing=True)
        self.a.record()
        return self

    def __exit__(self, *exc):
        self.b.record()
        self.b.synchronize()
        self.ms = self.a.elapsed_time(self.b)


def hold_k2s(fw, cases, n):
    """K2 against its plain version over n world steps from each case's
    state: cases [(name, s0, tgt_of, bound)]. The kernel steps each state on
    its own, as the world does; the plain version steps all of them side by
    side, one env per column (envs are independent). Max |d| by row group
    (pose, vel, lam), checked against each `bound`; where the scene has λ
    rows, the plain version must leave an impulse in them after one of the
    steps at least. → {name: (the largest group's |d|, the last step's
    kernel inputs, the plain version's ms per step for all the states)}."""
    from mppiisaac_tpu_torch.ops.fused_rollout import world_step_plain

    ks = fw.ks
    dev = cases[0][1].q.device
    ones_b = torch.ones(ks.nbody, device=dev)
    ones_g = torch.ones(ks.ngeom, device=dev)
    r = [fw.pack(s0).contiguous() for _, s0, _, _ in cases]
    rp = torch.stack(r, 1)
    N = len(cases)
    NS = ks.n_state_rows
    lam = torch.zeros(N, device=dev)  # the largest λ after each step, per state
    plain_ms = 0.0
    for i in range(n):
        tgt = [tgt_of(i) for _, _, tgt_of, _ in cases]
        r = [fw.step_rows(rc, tc, ones_b, ones_g) for rc, tc in zip(r, tgt)]
        with Timer() as t:
            rp = world_step_plain(ks, rp, torch.stack(tgt), ones_b.expand(N, -1),
                                  ones_g.expand(N, -1), fw.substeps, fw.dt_sub, fw.impulse_sweeps)
        plain_ms += t.ms / n
        lam = torch.maximum(lam, rp[NS:].abs().amax(0)) if ks.n_fc else lam
    torch.cuda.synchronize()
    A, D = ks.nactor, ks.ndof
    out = {}
    for j, (name, _, _, bound) in enumerate(cases):
        dd = (r[j].double() - rp[:, j].double()).abs()
        root = dd[: 13 * A].reshape(A, 13)
        q = dd[13 * A: 13 * A + D].max().item() if D else 0.0
        groups = dict(pose=max(root[:, :7].max().item(), q),
                      vel=max(root[:, 7:].max().item(), dd[13 * A + D: NS].max().item()),
                      lam=dd[NS:].max().item() if ks.n_fc else 0.0)
        print(f"  {name}: K2 rows after {n} steps: max|d| " + ", ".join(
            f"{k} {e:.3e} (bound {bound[k]:g})" for k, e in groups.items()), flush=True)
        if not bool(torch.isfinite(r[j]).all()) or any(e > bound[k] for k, e in groups.items()):
            fail(f"{name}: K2 disagrees with its plain version")
        # the λ rows took part: an impulse after one of the steps at least
        if ks.n_fc and float(lam[j]) == 0.0:
            fail(f"{name}: no λ row carried a contact impulse")
        out[name] = (max(groups.values()), (r[j], tgt[j], ones_b, ones_g), plain_ms)
    return out


def hold_k1s(fr, cases, n_plain=None):
    """K1 against its plain version from each case's inputs: cases [(name,
    k1_in, bound)]. The kernel runs on each case's packed inputs (the main
    path's shapes); the plain version runs once, on the cases' samples side
    by side (the first n_plain of each, or all; samples are independent),
    and each case's kernel samples are held against theirs: max, first-step
    and median-over-samples cost differences, checked against the k1_*
    entries of its bound. → {name: errors, with "plain_ms" the one plain
    call's}."""
    from mppiisaac_tpu_torch.ops.fused_rollout import rollout_plain

    outs = [fr.run(*k1_in) for _, k1_in, _ in cases]
    torch.cuda.synchronize()
    n = n_plain or fr.K
    cat = [torch.cat([k1_in[i][..., :n] for _, k1_in, _ in cases], -1).contiguous()
           for i in range(4)]
    with Timer() as t:
        cp_all, vp_all = rollout_plain(fr.ks, cat[0], cat[1].float(), cat[2], cat[3], fr.H,
                                       fr.substeps, fr.dt_sub, fr.vis_body, fr.impulse_sweeps,
                                       fr.world_fidelity)
    errs = {}
    for j, ((name, _, bound), (c, v)) in enumerate(zip(cases, outs)):
        c, v = c[:n], v[:, :n]
        cp, vp = cp_all[j * n:(j + 1) * n], vp_all[:, j * n:(j + 1) * n]
        if not bool(torch.isfinite(c).all()):
            fail(f"{name}: K1 costs are not finite")
        d = (c.double() - cp.double()).abs()
        err = dict(max=d.max().item(), first=d[:, 0].max().item(),
                   median=d.max(1).values.median().item(), plain_ms=t.ms)
        checks = [(k, err[k[3:]], b) for k, b in bound.items() if k.startswith("k1_")]
        print(f"  {name}: K1 costs {tuple(c.shape)} max|d| {err['max']:.3e}, first step "
              f"{err['first']:.3e}, median over samples {err['median']:.3e} (bounds "
              f"{', '.join(f'{k[3:]} {b:g}' for k, _, b in checks)})", flush=True)
        if any(e > b for _, e, b in checks):
            fail(f"{name}: K1 disagrees with its plain version")
        errs[name] = err
        if "k1_first" not in bound:
            within(f"{name}: vis", v, vp, VIS_ATOL, 0.0)
            continue
        # a sensitive state: the vis body's path (H, K, 3) parts as the costs
        # do, so it is held the same way, at the first step and by the median
        # over samples of each sample's largest difference
        dv = (v.double() - vp.double()).abs()
        vis_first, vis_median = dv[0].max().item(), dv.amax(dim=(0, 2)).median().item()
        print(f"  {name}: vis {tuple(v.shape)} max|d| {dv.max().item():.3e}, first step "
              f"{vis_first:.3e}, median over samples {vis_median:.3e} (bound {VIS_ATOL:g})",
              flush=True)
        if not bool(torch.isfinite(v).all()) or max(vis_first, vis_median) > VIS_ATOL:
            fail(f"{name}: vis disagrees with its plain version")
    print(f"    the plain K1 ran once on {len(cases)} × {n} samples: {t.ms / 1e3:.1f} s", flush=True)
    return errs


def state_dict(st):
    return {f.name: (None if getattr(st, f.name) is None else getattr(st, f.name).cpu())
            for f in dataclasses.fields(st)}


def earlier_paths(dev, root):
    """Phases 2-8: panda reach, panda_pick and the mobile robots. → (pick's
    hold states and world-step hold, the timed paths' records (see
    timed_path))."""
    from mppiisaac_tpu_torch.ops.fused_rollout import FusedRollout, FusedWorldStep
    from mppiisaac_tpu_torch.physics.types import ModelParams
    from mppiisaac_tpu_torch.runtime.loop import run_task
    from mppiisaac_tpu_torch.runtime.sim import Simulation, broadcast_state
    from mppiisaac_tpu_torch.tasks import panda_pick
    from mppiisaac_tpu_torch.tasks.panda_reach import PandaReachObjective, success_fn
    from mppiisaac_tpu_torch.utils.config_store import load_config

    t_phase = time.perf_counter()
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

    print(f"    phases 2-4: {time.perf_counter() - t_phase:.1f} s", flush=True)
    t_phase = time.perf_counter()

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
    torch.save({"settled block": state_dict(settled), "held grasp": state_dict(held)},
               os.path.join(root, "chiprun_out", "panda_pick_states.pt"))
    k1_cases, k2_cases = [], []
    for name, s0 in (("settled block", settled), ("held grasp", held)):
        gp = torch.Generator().manual_seed(SEED)
        PV = (torch.rand(PK, PH, pfr.nu, generator=gp) * 0.6 - 0.3).to(dev)
        k1p_in = pfr.pack(broadcast_state(s0, PK), pparams_K, PV)
        k1_cases.append((name, k1p_in, PICK_BOUNDS[name]))

        def pick_tgt(i, s0=s0, gp=gp):
            t = s0.q + (torch.rand(pb.scene.ndof, generator=gp) * 0.4 - 0.2).to(dev)
            t[7:9] = s0.dof_target[7:9]
            return t

        k2_cases.append((name, s0, pick_tgt, PICK_BOUNDS[name]))
    # (each state's K2 targets draw from its generator after its K1 controls)
    e1s, e2s = hold_k1s(pfr, k1_cases), hold_k2s(pfw, k2_cases, 5)
    pick_err = {name: (e1s[name], e2s[name][0]) for name, _, _ in k1_cases}
    _, k2p_in, k2p_plain = e2s["held grasp"]

    print(f"    phases 5-6: {time.perf_counter() - t_phase:.1f} s", flush=True)
    t_phase = time.perf_counter()

    # ---- 7. the mobile-robot loops, with the launch counters ----
    from mppiisaac_tpu_torch.tasks import mobile_push, mobile_reach

    mobile = {}
    for task, mod, robot, jax_step in MOBILE_LOOPS:
        mcfg = load_config(f"tasks/{task}")
        if mod == "mobile_push":
            obj = mobile_push.MobilePushObjective(mcfg, robot, mobile_push.EE_LINK[robot])
            succ = mobile_push.success_fn(obj.goal)
        else:
            obj = mobile_reach.MobileReachObjective(mcfg, robot)
            succ = mobile_reach.success_fn(robot, obj.goal)
        seen = {}

        def observer(step, w, a, seen=seen):
            # the first step at which a boxer–block couple row carries an impulse
            if "rows" not in seen:
                seen["rows"] = pair_rows(w.scene, w.engine.tables, "boxer", "block", dev)
            if "touch" not in seen and float(w.state.contact_lam[0, seen["rows"]].abs().max()) > 0:
                seen["touch"], seen["touch_step"] = w.state, step
            seen["last"] = w.state

        FusedRollout.launches = 0
        FusedWorldStep.launches = 0
        t0 = time.perf_counter()
        mm = run_task(mcfg, obj, success_fn=succ, device=dev,
                      observer=observer if task == "boxer_push" else None)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        n1, n2 = FusedRollout.launches, FusedWorldStep.launches
        print(f"[7] run_task {task} K={mcfg.mppi.num_samples} H={mcfg.mppi.horizon} on cuda: "
              f"success_step {mm.success_step} (the JAX package: {jax_step}), {mm.steps} steps "
              f"(conf n_steps {mcfg.n_steps}) in {loop_s:.2f} s, median solver "
              f"{np.median(mm.solver_time) * 1e3:.3f} ms/step, median control step "
              f"{1e3 / float(np.median(mm.fps)):.3f} ms, finite {mm.final_state_finite}; "
              f"launches K1 {n1}, K2 {n2}", flush=True)
        if mm.success_step is None:
            fail(f"{task} did not reach its goal within the conf's {mcfg.n_steps} steps")
        if not mm.final_state_finite:
            fail("non-finite world state")
        if n1 != mm.steps or n2 != mm.steps or n1 == 0:
            fail("launch counters do not match the commands and world steps run")
        mobile[task] = dict(m=mm, n1=n1, n2=n2)
        if task == "boxer_push":
            touch = seen.get("touch", seen["last"])
            print(f"    boxer touches the block at step {seen.get('touch_step')}", flush=True)

    # ---- 8. boxer_push: kernels against their plain versions from two states ----
    bcfg = load_config("tasks/boxer_push")
    bworld = Simulation(bcfg.isaacgym, bcfg.actors, bcfg.initial_actor_positions, num_envs=1,
                        device=dev)
    bb = bworld.built
    bobj = mobile_push.MobilePushObjective(bcfg, "boxer", "ee_link")
    BK, BH = bcfg.mppi.num_samples, bcfg.mppi.horizon
    bfr = FusedRollout(bb, bworld.engine, bobj.kernel_cost(bb), BH, BK,
                       vis_body=bb.visualize_bodies[0], impulse_sweeps=bcfg.mppi.rollout_sweeps)
    bfw = FusedWorldStep(bb, bworld.engine, impulse_sweeps=bcfg.isaacgym.fused_world_sweeps)
    bparams_K = ModelParams(torch.ones(BK, bb.scene.nbody, device=dev),
                            torch.ones(BK, bb.scene.ngeom, device=dev))
    print(f"[8] boxer_push: K1 vs plain at K={BK}, H={BH}, nu={bfr.nu}, {bfr.substeps} substeps, "
          f"{bfr.impulse_sweeps} sweeps, {bfr.ks.nblk} pair blocks, {bfr.ks.n_fc} candidates, "
          f"rows={bfr.ks.n_rows}; K2 vs plain over 5 world steps, {bfw.impulse_sweeps} sweeps "
          f"(bounds and their reasons at BOXER_BOUNDS)")
    initial = bworld.state.map(lambda x: x[0])
    states = {"initial": initial, "touching": touch.map(lambda x: x[0])}
    os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
    torch.save({k: state_dict(v) for k, v in states.items()},
               os.path.join(root, "chiprun_out", "boxer_push_states.pt"))
    k1_cases, k2_cases = [], []
    for name, s0 in states.items():
        gb = torch.Generator().manual_seed(SEED)
        BV = (torch.rand(BK, BH, bfr.nu, generator=gb) * 2.0 - 1.0).to(dev)
        k1b_in = bfr.pack(broadcast_state(s0, BK), bparams_K, BV)
        k1_cases.append((name, k1b_in, BOXER_BOUNDS[name]))

        def boxer_tgt(i, s0=s0, gb=gb):
            u = (torch.rand(bfr.nu, generator=gb) * 2.0 - 1.0).to(dev)
            return bb.cmd_map.apply(u[None], s0.q[None])[0].contiguous()

        k2_cases.append((name, s0, boxer_tgt, BOXER_BOUNDS[name]))
    e1s, e2s = hold_k1s(bfr, k1_cases), hold_k2s(bfw, k2_cases, 5)
    boxer_err = {name: (e1s[name], e2s[name][0]) for name, _, _ in k1_cases}
    _, k2b_in, k2b_plain = e2s["touching"]

    print(f"    phases 7-8: {time.perf_counter() - t_phase:.1f} s", flush=True)
    held_k1, held_k2 = pick_err["held grasp"]
    t_k1, t_k2 = boxer_err["touching"]
    pick = dict(states={"settled block": settled, "held grasp": held}, fw=pfw, k2_in=k2p_in,
                k2_err=pick_err["settled block"][1], k2_plain=k2p_plain)
    return pick, [
        timed_path("panda_reach", reach["fr"], reach["fw"], reach["k1_in"], reach["k2_in"],
                   reach["n_k1"], reach["n_k2"], reach["k1_err"], reach["k2_err"]),
        timed_path("panda_pick", pfr, pfw, k1p_in, k2p_in, p_k1, p_k2,
                   pick_err["settled block"][0]["max"], pick_err["settled block"][1],
                   plain=(held_k1["plain_ms"], k2p_plain),
                   k1_extra=dict(held_grasp_first_step_max_abs_err=held_k1["first"],
                                 held_grasp_median_max_abs_err=held_k1["median"],
                                 held_grasp_max_abs_err=held_k1["max"]),
                   k2_extra=dict(held_grasp_max_abs_err=held_k2)),
        timed_path("boxer_push", bfr, bfw, k1b_in, k2b_in, mobile["boxer_push"]["n1"],
                   mobile["boxer_push"]["n2"], boxer_err["initial"][0]["max"],
                   boxer_err["initial"][1], plain=(boxer_err["touching"][0]["plain_ms"], k2b_plain),
                   k1_extra=dict(touching_first_step_max_abs_err=t_k1["first"],
                                 touching_median_max_abs_err=t_k1["median"],
                                 touching_max_abs_err=t_k1["max"]),
                   k2_extra=dict(touching_max_abs_err=t_k2)),
    ]


def timed_path(key, fr, fw, k1_in, k2_in, n1, n2, e1, e2, plain=None, k1_extra=None,
               k2_extra=None):
    """A path whose kernels phase 18 times: its wrappers, the inputs to time
    them on, the launches of its loop, the kernels' largest differences from
    their plain versions, and the plain versions' ms where its holds timed
    them (else phase 18 does)."""
    return dict(key=key, fr=fr, fw=fw, k1_in=k1_in, k2_in=k2_in, n1=n1, n2=n2, e1=e1, e2=e2,
                plain=plain, k1_extra=k1_extra or {}, k2_extra=k2_extra or {})


# phase 9: (the conf's task, the JAX package's success step, the second hold
# state)
POINT_PATHS = {
    "point_robot": ("point_robot", "41", "step 20"),
    "point_robot_obst1": ("point_robot", "no recorded step", "closest"),
    "multi_pointbot": ("multi_pointbot", "no recorded step", "closest"),
}


def point_config(key):
    """The conf, objective and success test of a phase-9 path.
    point_robot_obst1 is point_robot with the sphere `paper_obst1` (actor
    `obst1`) added as its obstacle, as the JAX package's benchmark runner
    builds it."""
    from mppiisaac_tpu_torch.tasks import multi_robot, point_robot
    from mppiisaac_tpu_torch.utils.config_store import load_config

    cfg = load_config(f"tasks/{POINT_PATHS[key][0]}")
    if key == "multi_pointbot":
        obj = multi_robot.MultiPointbotObjective(cfg)
        return cfg, obj, multi_robot.success_fn(key, obj)
    obstacles = []
    if key == "point_robot_obst1":
        cfg.actors = list(cfg.actors) + ["paper_obst1"]
        obstacles = ["obst1"]
    obj = point_robot.PointRobotObjective(cfg, obstacles)
    return cfg, obj, point_robot.success_fn(obj.nav_goal)


def rollout_for(cfg, obj, built, engine, K=None):
    """K1's wrapper with the conf's rollout settings (K, H, sweeps, fidelity,
    manifold), as the planner builds it."""
    from mppiisaac_tpu_torch.ops.fused_rollout import FusedRollout

    return FusedRollout(built, engine, obj.kernel_cost(built), cfg.mppi.horizon,
                        K or cfg.mppi.num_samples,
                        vis_body=built.visualize_bodies[0] if built.visualize_bodies else None,
                        impulse_sweeps=cfg.mppi.rollout_sweeps,
                        world_fidelity=cfg.mppi.rollout_fidelity != "fast",
                        manifold=cfg.mppi.rollout_manifold)


def describe(fr, fw=None, n_plain=None):
    print(f"    K1 vs plain at K={fr.K}" + (f" (plain on the first {n_plain})" if n_plain else "")
          + f", H={fr.H}, nu={fr.nu}, {fr.substeps} substeps, {fr.impulse_sweeps} sweep(s), "
          f"{'world' if fr.world_fidelity else 'fast'} fidelity, {fr.ks.nblk} pair blocks, "
          f"{fr.ks.n_fc} candidates, rows={fr.n_rows}"
          + (f"; K2 vs plain over 5 world steps, {fw.impulse_sweeps} sweeps" if fw else ""),
          flush=True)


def hold_states(key, cfg, obj, dev, root, named, bounds, n_plain=None):
    """K1 and K2 of the scene of `cfg` against their plain versions, with the
    hold controls of `key`, from each (name, state) of `named` (None: the
    conf's initial state); the states are first saved to
    chiprun_out/<key>_states.pt. → (fr, fw, the last state's K1 and K2
    inputs, {state: (K1 errors, K2 error, K2 plain ms)})."""
    from mppiisaac_tpu_torch.ops.fused_rollout import FusedWorldStep
    from mppiisaac_tpu_torch.physics.types import ModelParams
    from mppiisaac_tpu_torch.runtime.sim import Simulation, broadcast_state

    world = Simulation(cfg.isaacgym, cfg.actors, cfg.initial_actor_positions, num_envs=1, device=dev)
    b = world.built
    K, H = cfg.mppi.num_samples, cfg.mppi.horizon
    fr = rollout_for(cfg, obj, b, world.engine)
    fw = FusedWorldStep(b, world.engine, impulse_sweeps=cfg.isaacgym.fused_world_sweeps)
    params_K = ModelParams(torch.ones(K, b.scene.nbody, device=dev),
                           torch.ones(K, b.scene.ngeom, device=dev))
    describe(fr, fw, n_plain)
    states = {name: (world.state if st is None else st).map(lambda x: x[0])
              for name, st in named}
    os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
    torch.save({k: state_dict(v) for k, v in states.items()},
               os.path.join(root, "chiprun_out", f"{key}_states.pt"))
    k1_cases, k2_cases = [], []
    for name, s0 in states.items():
        g = torch.Generator().manual_seed(SEED)
        V = hold_controls(key, cfg, g, (K, H, fr.nu)).to(dev)
        k1_in = fr.pack(broadcast_state(s0, K), params_K, V)
        k1_cases.append((f"{key} {name}", k1_in, bounds[name]))

        def tgt_of(i, s0=s0, g=g):
            u = hold_controls(key, cfg, g, (fr.nu,)).to(dev)
            return b.cmd_map.apply(u[None], s0.q[None])[0].contiguous()

        k2_cases.append((f"{key} {name}", s0, tgt_of, bounds[name]))
    e1s, e2s = hold_k1s(fr, k1_cases, n_plain), hold_k2s(fw, k2_cases, 5)
    errs = {name: (e1s[f"{key} {name}"], *e2s[f"{key} {name}"][::2]) for name in states}
    k2_in = e2s[k2_cases[-1][0]][1]
    return fr, fw, k1_in, k2_in, errs


def point_paths(dev, root):
    """Phase 9: each point-robot path to its goal with its launch counters,
    then K1 and K2 against their plain versions from two states."""
    from mppiisaac_tpu_torch.ops.fused_rollout import FusedRollout, FusedWorldStep
    from mppiisaac_tpu_torch.runtime.loop import run_task

    for key, (task, jax_step, second) in POINT_PATHS.items():
        t0 = time.perf_counter()
        cfg, obj, succ = point_config(key)
        seen = {"d": float("inf")}

        def observer(step, w, a, seen=seen, key=key):
            # point_robot: the state after 20 steps; the others: the step at
            # which the robot is closest to the obstacle or to the other robot
            st = w.state
            if key == "point_robot" and step == 19:
                seen["step 20"] = st
            elif key != "point_robot":
                if key == "multi_pointbot":
                    other = st.q[0, w.scene.dof_offset[1]: w.scene.dof_offset[1] + 2]
                else:
                    other = st.root_pos[0, w.scene.actor_index("obst1"), :2]
                d = float((st.q[0, 0:2] - other).norm())
                if d < seen["d"]:
                    seen["d"], seen["closest"], seen["step"] = d, st, step
            seen["last"] = st

        FusedRollout.launches = 0
        FusedWorldStep.launches = 0
        m = run_task(cfg, obj, success_fn=succ, observer=observer, device=dev)
        torch.cuda.synchronize()
        n1, n2 = FusedRollout.launches, FusedWorldStep.launches
        print(f"[9] run_task {key} K={cfg.mppi.num_samples} H={cfg.mppi.horizon} on cuda: "
              f"success_step {m.success_step} (the JAX package: {jax_step}), {m.steps} steps (conf "
              f"n_steps {cfg.n_steps}), median control step {1e3 / float(np.median(m.fps)):.3f} ms, "
              f"finite {m.final_state_finite}; launches K1 {n1}, K2 {n2}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if m.success_step is None:
            fail(f"{key} did not reach its goal within the conf's {cfg.n_steps} steps")
        if not m.final_state_finite:
            fail("non-finite world state")
        if n1 != m.steps or n2 != m.steps or n1 == 0:
            fail("launch counters do not match the commands and world steps run")
        if second == "closest":
            what = ("the other robot (in dof coordinates, as the cost reads them)"
                    if key == "multi_pointbot" else "the obstacle")
            print(f"    closest at step {seen['step']}: {seen['d']:.4f} m between the robot and "
                  f"{what}", flush=True)
        t0 = time.perf_counter()
        # (a loop that ends before step 20 holds its last state instead)
        hold_states(key, cfg, obj, dev, root,
                    [("initial", None), (second, seen.get(second, seen["last"]))], POINT_BOUNDS[key])
        print(f"    holds: {time.perf_counter() - t0:.1f} s", flush=True)


# phases 10-12: (task, loop steps, the JAX package's result there, the second
# hold state, its bounds)
ARM_PATHS = {
    "panda_effort": (500, "success at step 328", "step 20", EFFORT_BOUNDS),
    "panda_stick_push": (200, "its 0.4 m gate at step 1511 with seed 1; parks at seed 0",
                         "touching", STICK_BOUNDS),
    "omni_panda_pick": (150, "0 of 5 seeds succeed", "last", OMNI_BOUNDS),
}


def pair_rows(scene, tables, actor_a, actor_b, dev):
    """contact_lam rows of the swept candidates between two actors' bodies."""
    from mppiisaac_tpu_torch.ops.fused_physics import swept_blocks

    def bodies(name):
        ai = scene.actor_index(name)
        return range(scene.body_offset[ai], scene.body_offset[ai] + scene.actors[ai].nbody)

    ba, bb = bodies(actor_a), bodies(actor_b)
    return torch.as_tensor([r for b in swept_blocks(scene, tables)
                            if (b["ba"] in ba and b["bb"] in bb) or (b["bb"] in ba and b["ba"] in bb)
                            for r in b["rows"]], device=dev)


def arm_path(task, dev, root):
    """Phases 10-12: one loop of `task` with its launch counters, then K1 and
    K2 against their plain versions from two states. → its timed path."""
    from mppiisaac_tpu_torch.ops.fused_rollout import FusedRollout, FusedWorldStep
    from mppiisaac_tpu_torch.runtime.loop import run_task
    from mppiisaac_tpu_torch.tasks import omni_panda_pick, panda_reach, panda_stick_push
    from mppiisaac_tpu_torch.utils.config_store import load_config

    phase = {"panda_effort": 10, "panda_stick_push": 11, "omni_panda_pick": 12}[task]
    n_steps, jax_result, second, bounds = ARM_PATHS[task]
    t0 = time.perf_counter()
    cfg = load_config(f"tasks/{task}")
    if task == "panda_effort":
        obj = panda_reach.PandaReachObjective(cfg, "panda_link7")
        succ = panda_reach.success_fn("panda_link7")
    elif task == "panda_stick_push":
        obj = panda_stick_push.PandaStickPushObjective(cfg)
        succ = panda_stick_push.success_fn()
    else:
        obj = omni_panda_pick.OmniPandaPickObjective(cfg)
        succ = omni_panda_pick.success_fn()
    seen = {"finger_move": 0.0}

    def observer(step, w, a):
        st = w.state
        if step == 0:
            seen["first"] = st
            if task == "panda_stick_push":
                seen["rows"] = pair_rows(w.scene, w.engine.tables, "panda", "panda_push_block", dev)
                seen["ai"] = (w.scene.actor_index("panda_push_block"), w.scene.actor_index("goal"))
                seen["block0"] = st.root_pos[0, seen["ai"][0]].clone()
        if task == "panda_effort" and step == 19:
            seen["step 20"] = st
        if task == "panda_stick_push" and "touching" not in seen \
                and float(st.contact_lam[0, seen["rows"]].abs().max()) > 0:
            seen["touching"], seen["touch_step"] = st, step
        if task == "omni_panda_pick":
            d0 = w.scene.dof_offset[w.scene.actor_index("omnipanda")]
            fq = st.q[0, d0 + 10: d0 + 12]
            seen.setdefault("finger_q0", fq.clone())
            seen["finger_move"] = max(seen["finger_move"], float((fq - seen["finger_q0"]).abs().max()))
        seen["last"] = st

    FusedRollout.launches = 0
    FusedWorldStep.launches = 0
    m = run_task(cfg, obj, n_steps=n_steps, success_fn=succ, observer=observer, device=dev)
    torch.cuda.synchronize()
    n1, n2 = FusedRollout.launches, FusedWorldStep.launches
    print(f"[{phase}] run_task {task} K={cfg.mppi.num_samples} H={cfg.mppi.horizon} "
          f"({cfg.mppi.mppi_mode} mode, {cfg.mppi.rollout_sweeps} sweep(s) in K1) on cuda: "
          f"success_step {m.success_step} (the JAX package: {jax_result}), {m.steps} steps of "
          f"{n_steps}, median solver {np.median(m.solver_time) * 1e3:.3f} ms/step, median "
          f"control step {1e3 / float(np.median(m.fps)):.3f} ms, finite {m.final_state_finite}; "
          f"launches K1 {n1}, K2 {n2}; {time.perf_counter() - t0:.1f} s", flush=True)
    if not m.final_state_finite:
        fail("non-finite world state")
    if n1 != m.steps or n2 != m.steps or n1 == 0:
        fail("launch counters do not match the commands and world steps run")
    if task == "panda_effort" and m.success_step is None:
        fail(f"panda_effort did not reach its goal within {n_steps} steps")
    if task == "panda_stick_push":
        block0, block1 = seen["block0"], seen["last"].root_pos[0, seen["ai"][0]]
        goal = seen["last"].root_pos[0, seen["ai"][1]]
        print(f"    the stick touches the block at step {seen.get('touch_step')}; ‖block − goal‖ "
              f"{float((block0 - goal).norm()):.4f} m at the start, "
              f"{float((block1 - goal).norm()):.4f} m after {m.steps} steps; the block moved "
              f"{float((block1 - block0).norm()):.4f} m", flush=True)
        if "touching" not in seen:
            fail("the stick never touched the block (no stick–block λ row carried an impulse)")
        bounds = dict(bounds, touching=touch_bounds(task, cfg, obj, dev, seen["touching"],
                                                    bounds["touching"]))
    if task == "omni_panda_pick":
        print(f"    the finger dofs moved by up to {seen['finger_move']:.4f} m", flush=True)
        if seen["finger_move"] < 1e-3:
            fail("omni_panda_pick's finger dofs never moved")

    # (a loop that ends before step 20 holds its last state instead)
    return held_path(task, cfg, obj, dev, root,
                     [("initial", None), (second, seen.get(second, seen["last"]))], bounds, n1, n2)


def touch_bounds(key, cfg, obj, dev, st, bound):
    """The K1 bounds at the stick's first touching state st: STICK_BOUNDS
    are 10× the plain K1's own float32-vs-float64 drift at the touching state
    they were measured at; here that drift is measured again, on the card, on
    the hold's inputs (its first PLAIN_K1_SAMPLES samples), and where it is
    more than a tenth of a bound (the first touch of another trajectory can
    be a harder impact, whose every float32 rounding switches contacts) that
    bound becomes 10× the state's own drift. The K2 bounds stay. The device
    code itself is held at such a state under STICK_BOUNDS on the CPU
    (tests/test_torch_device_emu.py)."""
    from mppiisaac_tpu_torch.ops.fused_rollout import rollout_plain
    from mppiisaac_tpu_torch.physics.types import ModelParams
    from mppiisaac_tpu_torch.runtime.sim import Simulation, broadcast_state

    world = Simulation(cfg.isaacgym, cfg.actors, cfg.initial_actor_positions, num_envs=1, device=dev)
    b = world.built
    K, H, n = cfg.mppi.num_samples, cfg.mppi.horizon, PLAIN_K1_SAMPLES
    fr = rollout_for(cfg, obj, b, world.engine)
    params_K = ModelParams(torch.ones(K, b.scene.nbody, device=dev),
                           torch.ones(K, b.scene.ngeom, device=dev))
    V = hold_controls(key, cfg, torch.Generator().manual_seed(SEED), (K, H, fr.nu)).to(dev)
    k1_in = [x[..., :n].contiguous()
             for x in fr.pack(broadcast_state(st.map(lambda x: x[0]), K), params_K, V)]
    c = [rollout_plain(fr.ks, *(x.to(dt) for x in k1_in), fr.H, fr.substeps, fr.dt_sub,
                       fr.vis_body, fr.impulse_sweeps, fr.world_fidelity)[0]
         for dt in (torch.float32, torch.float64)]
    d = (c[0].double() - c[1]).abs()
    drift = dict(k1_first=d[:, 0].max().item(), k1_median=d.max(1).values.median().item())
    out = dict(bound, **{k: max(bound[k], 10.0 * v) for k, v in drift.items()})
    print("    the touching state's own float32-vs-float64 drift (plain K1): " + ", ".join(
        f"{k} {v:.3e} ({v / bound[k]:.3f} of STICK_BOUNDS; bound {out[k]:g})"
        for k, v in drift.items()), flush=True)
    return out


def held_path(key, cfg, obj, dev, root, named, bounds, n1, n2):
    """The holds of a loop's path from its two named states (hold_states,
    the plain K1 on PLAIN_K1_SAMPLES samples) → its timed path: the first
    state's errors as max_abs_err, the second's beside them."""
    t0 = time.perf_counter()
    fr, fw, k1_in, k2_in, errs = hold_states(key, cfg, obj, dev, root, named, bounds,
                                             n_plain=PLAIN_K1_SAMPLES)
    print(f"    holds: {time.perf_counter() - t0:.1f} s", flush=True)
    first, second = (name for name, _ in named)
    tag = second.replace(" ", "_")
    e1, e2, k2_plain = errs[second]
    return timed_path(key, fr, fw, k1_in, k2_in, n1, n2, errs[first][0]["max"],
                      errs[first][1], plain=(e1["plain_ms"], k2_plain),
                      k1_extra={f"{tag}_first_step_max_abs_err": e1["first"],
                                f"{tag}_median_max_abs_err": e1["median"],
                                f"{tag}_max_abs_err": e1["max"],
                                "plain_samples": PLAIN_K1_SAMPLES},
                      k2_extra={f"{tag}_max_abs_err": e2})


# phases 13-14: (phase, the JAX package's success step, the loop's steps).
# multi_jackal runs twice its conf's 200 steps: the port's loop reaches both
# goals at step 276 with the conf seed (239 with seed 0, none in 400 with
# seed 1), where the JAX package's reached them at 147; albert runs its
# conf's 500
MESH_LOOPS = {"multi_jackal": (13, "147", 400), "albert": (14, "372", 500)}


def counted_loop(label, cfg, obj, dev, prior=None, **kw):
    """One run_task loop with the launch counters (and the tape injections)
    set to 0 just before it. → (metrics, K1 launches, K2 launches, tapes)."""
    from mppiisaac_tpu_torch.mppi.solver import MPPIPlanner
    from mppiisaac_tpu_torch.ops.fused_rollout import FusedRollout, FusedWorldStep
    from mppiisaac_tpu_torch.runtime.loop import run_task

    FusedRollout.launches = 0
    FusedWorldStep.launches = 0
    MPPIPlanner.tape_injections = 0
    t0 = time.perf_counter()
    m = run_task(cfg, obj, prior=prior, device=dev, **kw)
    torch.cuda.synchronize()
    n1, n2, tapes = FusedRollout.launches, FusedWorldStep.launches, MPPIPlanner.tape_injections
    print(f"{label} K={cfg.mppi.num_samples} H={cfg.mppi.horizon} on cuda: success_step "
          f"{m.success_step}, {m.steps} steps, median solver {np.median(m.solver_time) * 1e3:.3f} "
          f"ms/step, median control step {1e3 / float(np.median(m.fps)):.3f} ms, finite "
          f"{m.final_state_finite}; launches K1 {n1}, K2 {n2}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    if not m.final_state_finite:
        fail("non-finite world state")
    if n1 != m.steps or n2 != m.steps or n1 == 0:
        fail("launch counters do not match the commands and world steps run")
    return m, n1, n2, tapes


def mesh_path(task, dev, root):
    """Phases 13-14: the multi_jackal or albert loop to its goal, then K1
    and K2 against their plain versions from the initial state and the
    state in motion. → its timed path."""
    from mppiisaac_tpu_torch.tasks import albert, multi_robot
    from mppiisaac_tpu_torch.utils.config_store import load_config

    phase, jax_step, n_steps = MESH_LOOPS[task]
    cfg = load_config(f"tasks/{task}")
    if task == "albert":
        obj, succ = albert.AlbertObjective(cfg), albert.success_fn()

        def dists(w):
            v = w.view
            return [float((v.link_position(albert.EE_LINK, "albert")[0]
                           - v.actor_position("goal")[0]).norm())]
    else:
        obj = multi_robot.MultiJackalObjective(cfg)
        succ = multi_robot.success_fn(task, obj)

        def dists(w):
            rp = w.state.root_pos[0].cpu()
            return [float((rp[i, :2] - torch.as_tensor(g)).norm())
                    for i, g in zip(obj.robot_actor_indices(w.scene), obj.goals)]
    seen = {}

    def observer(step, w, a):
        if step == MOTION_STEP - 1:
            seen["in motion"] = w.state
        if step % 50 == 0:
            seen.setdefault("trace", []).append((step, dists(w)))
        seen["last"] = w.state
        seen["d"] = dists(w)

    m, n1, n2, _ = counted_loop(f"[{phase}] run_task {task} (the JAX package: success at step "
                                f"{jax_step})", cfg, obj, dev, n_steps=n_steps, success_fn=succ,
                                observer=observer)
    print("    distance to the goal (m) by step: " + ", ".join(
        f"{k}: {'/'.join(f'{x:.3f}' for x in d)}" for k, d in seen["trace"] + [(m.steps, seen["d"])]),
        flush=True)
    if m.success_step is None:
        fail(f"{task} did not reach its goal within {n_steps} steps")
    return held_path(task, cfg, obj, dev, root,
                     [("initial", None), ("in motion", seen.get("in motion", seen["last"]))],
                     MESH_BOUNDS[task], n1, n2)


def anymal_path(dev, root):
    """Phase 15: anymal with the gait tape prior, then without it at seed 0,
    each for ANYMAL_STEPS steps; then the holds from the prior run's landed
    and last states. → its timed path."""
    from mppiisaac_tpu_torch.tasks import anymal
    from mppiisaac_tpu_torch.utils.config_store import load_config

    runs = (("tape prior", [], "no success bar at the shipped config (4 of 5 seeds with the "
             "prior on an older physics)"),
            ("no prior, seed 0", ["mppi.use_priors=false", "mppi.seed_val=0"],
             "success at step 80 with seed 0 (3 of 5 seeds)"))
    kept = {}
    for name, overrides, jax_bar in runs:
        cfg = load_config("tasks/anymal", overrides)
        obj, prior = anymal.AnymalObjective(cfg), anymal.gait_prior(cfg)
        seen = {}

        def observer(step, w, a, seen=seen):
            v = w.view
            d = float((v.link_position("base", "anymal")[0, :2]
                       - v.actor_position("goal")[0, :2]).norm())
            seen.setdefault("d0", d)
            seen["d"] = d
            if step == LANDED_STEP - 1:
                seen["landed"] = w.state
            seen["last"] = w.state

        m, n1, n2, tapes = counted_loop(f"[15] run_task anymal, {name}", cfg, obj, dev, prior=prior,
                                        n_steps=ANYMAL_STEPS, success_fn=anymal.success_fn(),
                                        observer=observer)
        print(f"    ‖base_xy − goal_xy‖ {seen['d0']:.4f} m after the first step, {seen['d']:.4f} m "
              f"after {m.steps}; success step {m.success_step} (the JAX package: {jax_bar}); "
              f"tapes injected {tapes}", flush=True)
        if tapes != (m.steps if prior is not None else 0):
            fail(f"anymal ({name}): the prior's tape went into {tapes} of {m.steps} commands")
        if prior is not None:
            kept = dict(cfg=cfg, obj=obj, seen=seen, n1=n1, n2=n2)
    seen = kept["seen"]
    return held_path("anymal", kept["cfg"], kept["obj"], dev, root,
                     [("landed", seen.get("landed", seen["last"])), ("last", seen["last"])],
                     ANYMAL_BOUNDS, kept["n1"], kept["n2"])


def fast_pick_path(dev, root, pick):
    """Phase 16: panda_pick at fast fidelity with the reduced manifold for
    FAST_PICK_STEPS loop steps, then K1 against its plain version from
    phase 6's settled block and held grasp. → its timed path (K2 is the pick
    world's, timed on phase 6's inputs)."""
    from mppiisaac_tpu_torch.physics.types import ModelParams
    from mppiisaac_tpu_torch.runtime.sim import Simulation, broadcast_state
    from mppiisaac_tpu_torch.tasks import panda_pick
    from mppiisaac_tpu_torch.utils.config_store import load_config

    cfg = load_config("tasks/panda_pick", FAST_OVERRIDES)
    obj = panda_pick.PandaPickObjective(cfg)
    m, n1, n2, _ = counted_loop("[16] run_task panda_pick, fast fidelity + reduced manifold", cfg,
                                obj, dev, n_steps=FAST_PICK_STEPS,
                                success_fn=panda_pick.success_fn())
    world = Simulation(cfg.isaacgym, cfg.actors, cfg.initial_actor_positions, num_envs=1, device=dev)
    b = world.built
    K, H = cfg.mppi.num_samples, cfg.mppi.horizon
    fr = rollout_for(cfg, obj, b, world.engine)
    describe(fr, n_plain=PLAIN_K1_SAMPLES)
    torch.save({k: state_dict(v) for k, v in pick["states"].items()},
               os.path.join(root, "chiprun_out", "panda_pick_fast_states.pt"))
    params_K = ModelParams(torch.ones(K, b.scene.nbody, device=dev),
                           torch.ones(K, b.scene.ngeom, device=dev))
    t0 = time.perf_counter()
    cases = []
    for name, s0 in pick["states"].items():
        g = torch.Generator().manual_seed(SEED)
        V = hold_controls("panda_pick_fast", cfg, g, (K, H, fr.nu)).to(dev)
        k1_in = fr.pack(broadcast_state(s0, K), params_K, V)
        cases.append((name, k1_in, FAST_PICK_BOUNDS[name]))
    errs = hold_k1s(fr, cases, PLAIN_K1_SAMPLES)
    print(f"    holds: {time.perf_counter() - t0:.1f} s", flush=True)
    e1 = errs["held grasp"]
    return timed_path("panda_pick_fast", fr, pick["fw"], k1_in, pick["k2_in"], n1, n2,
                      errs["settled block"]["max"], pick["k2_err"], plain=(e1["plain_ms"], pick["k2_plain"]),
                      k1_extra={"held_grasp_first_step_max_abs_err": e1["first"],
                                "held_grasp_median_max_abs_err": e1["median"],
                                "held_grasp_max_abs_err": e1["max"],
                                "plain_samples": PLAIN_K1_SAMPLES})


class BoxPairObjective:
    """Phase 17's cost: TASK_MOBILE_PUSH with the point robot's last link as
    the EE (the term the controls move), the top box as the block and the
    boxes' contact forces."""

    def kernel_cost(self, built):
        from mppiisaac_tpu_torch.ops.fused_physics import TASK_MOBILE_PUSH, CostSpec

        s = built.scene
        a, b, r = s.actor_index("base_box"), s.actor_index("top_box"), s.actor_index("point_robot")
        return CostSpec(task=TASK_MOBILE_PUSH, ee_body=s.body_offset[r] + s.actors[r].nbody - 1,
                        goal_actor=-1, w_dist=0.1, w_ori=3.0, block_actor=b, goal_x=2.0,
                        goal_y=2.0, w_block=2.0, w_align=0.6, w_vel=0.5,
                        force_body0=s.body_offset[a], force_nbody=1, force2_body0=s.body_offset[b],
                        force2_nbody=1, force_dims=3, w_force=0.01)


def box_pair_scene(dev):
    """Phase 17's scene on the full box–box manifold: (cfg (the point
    robot's solver conf at K=256, H=12), objective, built, engine, the
    sliding state: the top box moving across at 0.4 m/s)."""
    from mppiisaac_tpu_torch.physics.contact import full_box_manifold
    from mppiisaac_tpu_torch.physics.step import Engine
    from mppiisaac_tpu_torch.scene.actor import ActorSpec
    from mppiisaac_tpu_torch.scene.builder import build_scene
    from mppiisaac_tpu_torch.utils.config_store import load_config

    cfg = load_config("tasks/point_robot", ["mppi.num_samples=256", "mppi.horizon=12"])
    built = build_scene([ActorSpec(**a) for a in BOX_PAIR], cfg.isaacgym)
    engine = Engine(built.scene)
    engine.tables = full_box_manifold(engine.tables)
    st = built.initial_state(engine, dev)
    top = built.scene.actor_index("top_box")
    linvel = st.root_linvel.clone()
    linvel[top] = torch.tensor([0.0, 0.4, 0.0], device=dev)
    return cfg, BoxPairObjective(), built, engine, engine.refresh(st.replace(root_linvel=linvel))


def box_pair_path(dev, root):
    """Phase 17: BOX_STEPS steps of the MPPI solver on the full box–box
    manifold, then K1 and K2 against their plain versions from the sliding
    state. → its timed path."""
    from mppiisaac_tpu_torch.mppi.solver import MPPIPlanner
    from mppiisaac_tpu_torch.ops.fused_physics import swept_blocks
    from mppiisaac_tpu_torch.ops.fused_rollout import FusedRollout, FusedWorldStep
    from mppiisaac_tpu_torch.physics.types import ModelParams
    from mppiisaac_tpu_torch.runtime.sim import broadcast_state

    t0 = time.perf_counter()
    cfg, obj, b, engine, s0 = box_pair_scene(dev)
    K = cfg.mppi.num_samples
    fr = rollout_for(cfg, obj, b, engine)
    fw = FusedWorldStep(b, engine, impulse_sweeps=cfg.isaacgym.fused_world_sweeps)
    solver = MPPIPlanner(cfg.mppi, cfg.nx, fused=fr, device=dev)
    params_K = ModelParams(torch.ones(K, b.scene.nbody, device=dev),
                           torch.ones(K, b.scene.ngeom, device=dev))
    params1 = ModelParams(torch.ones(b.scene.nbody, device=dev), torch.ones(b.scene.ngeom, device=dev))
    bb_rows = torch.as_tensor([r for blk in swept_blocks(b.scene, engine.tables)
                               if blk["kind"] in ("bbA", "bbB") for r in blk["rows"]], device=dev)
    FusedRollout.launches = 0
    FusedWorldStep.launches = 0
    st, live = s0, 0
    for _ in range(BOX_STEPS):
        action, solver.carry, _ = solver._command_impl(solver.carry, (broadcast_state(st, K), params_K))
        st = fw.step(st.replace(dof_target=b.cmd_map.apply(action[:1], st.q[None])[0]), params1)
        live += int(float(st.contact_lam[bb_rows].abs().max()) > 0)
    torch.cuda.synchronize()
    n1, n2 = FusedRollout.launches, FusedWorldStep.launches
    finite = all(bool(torch.isfinite(t).all()) for t in st.tensors())
    print(f"[17] box pair on the full manifold ({fr.ks.nblk} pair blocks, {fr.ks.n_fc} candidates, "
          f"{len(bb_rows)} of them bbA/bbB): {BOX_STEPS} solver steps, finite {finite}; launches K1 "
          f"{n1}, K2 {n2}; bbA/bbB λ rows live after {live} of the world steps; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if not finite:
        fail("non-finite world state")
    if n1 != BOX_STEPS or n2 != BOX_STEPS:
        fail("launch counters do not match the commands and world steps run")
    if live == 0:
        fail("no bbA/bbB λ row carried an impulse")
    describe(fr, fw)
    torch.save({"sliding": state_dict(s0)}, os.path.join(root, "chiprun_out", "box_pair_states.pt"))
    g = torch.Generator().manual_seed(SEED)
    V = hold_controls("box_pair", cfg, g, (K, cfg.mppi.horizon, fr.nu)).to(dev)
    k1_in = fr.pack(broadcast_state(s0, K), params_K, V)
    e1 = hold_k1s(fr, [("box pair sliding", k1_in, BOX_BOUNDS["sliding"])])["box pair sliding"]

    def tgt_of(i):
        u = hold_controls("box_pair", cfg, g, (fr.nu,)).to(dev)
        return b.cmd_map.apply(u[None], s0.q[None])[0].contiguous()

    e2, k2_in, k2_plain = hold_k2s(
        fw, [("box pair sliding", s0, tgt_of, BOX_BOUNDS["sliding"])], 5)["box pair sliding"]
    return timed_path("box_pair", fr, fw, k1_in, k2_in, n1, n2, e1["max"], e2,
                      plain=(e1["plain_ms"], k2_plain))


def geometry_table():
    """Phase 1's launch geometry of K1 and K2 at each timed path's conf."""
    import ctypes

    from mppiisaac_tpu_torch.ops.fused_physics import KernelScene
    from mppiisaac_tpu_torch.ops.fused_rollout import _SceneTablesC, launch_geometry
    from mppiisaac_tpu_torch.runtime.sim import Simulation
    from mppiisaac_tpu_torch.utils.config_store import load_config

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    tables = ctypes.sizeof(_SceneTablesC)
    for task in GEOMETRY_TASKS:
        cfg = load_config(f"tasks/{task}")
        w = Simulation(cfg.isaacgym, cfg.actors, cfg.initial_actor_positions, device="cpu")
        ks = KernelScene.build(w.built, w.engine, None)
        K = cfg.mppi.num_samples
        W, nbytes = launch_geometry(ks, K, n_sm)
        print(f"    geometry {task}: K1 K={K}, {W} warps per block, {-(-K // W)} blocks on {n_sm} "
              f"SMs, {tables + W * nbytes} B shared per block ({tables} B tables + {W} x {nbytes} "
              f"B per sample); K2 1 block of 1 warp, {tables + nbytes} B shared", flush=True)


def main():
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: this smoke run needs a CUDA GPU")
        sys.exit(2)
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "mppiisaac_tpu_torch")):
        print("FAIL: mppiisaac_tpu_torch is not beside chip_smoke.py")
        sys.exit(2)
    sys.path.insert(0, root)
    os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
    if "jax" in sys.modules:
        fail("jax is imported")
    if len(sys.argv) > 1:
        fail(f"unknown arguments {sys.argv[1:]} (usage: chip_smoke.py)")
    from mppiisaac_tpu_torch.ops import native

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
        if "registers" in line or "bytes stack frame" in line or "Compiling entry" in line:
            print("    ptxas:", line.strip())
    geometry_table()

    pick, records = earlier_paths(dev, root)
    point_paths(dev, root)
    for task in ARM_PATHS:
        rec = arm_path(task, dev, root)
        if task != "panda_effort":
            records.append(rec)
    for task in MESH_LOOPS:
        records.append(mesh_path(task, dev, root))
    records.append(anymal_path(dev, root))
    records.append(fast_pick_path(dev, root, pick))
    records.append(box_pair_path(dev, root))

    # ---- 18. timing, and each kernel's bound on the timed inputs ----
    t0 = time.perf_counter()
    entries = []
    src = "mppiisaac_tpu_torch/csrc/fused_rollout.cu"
    for r in records:
        fr, fw, k1_in, k2_in = r["fr"], r["fw"], r["k1_in"], r["k2_in"]
        k1_ms, k2_ms = cuda_time_ms(lambda: fr.run(*k1_in)), cuda_time_ms(lambda: fw.step_rows(*k2_in))
        if r["plain"] is None:
            plain = (cuda_time_ms(lambda: fr.plain(*k1_in), reps=5, warmup=1),
                     cuda_time_ms(lambda: fw.plain(*k2_in), reps=5, warmup=1))
        else:
            plain = r["plain"]
        b1, b2 = k1_bound(fr, k1_in), k2_bound(fw, k2_in)
        print(f"[18] {r['key']}: K1 {k1_ms:.3f} ms vs plain {plain[0]:.3f} ms; K2 {k2_ms:.3f} ms "
              f"vs plain {plain[1]:.3f} ms (kernels: medians); bounds: K1 {b1[0]:.6f} ms ({b1[1]}: "
              f"{b1[2]:.4g} flop, {b1[3]} B, live block share {b1[4]:.3f}), K2 {b2[0]:.6f} ms "
              f"({b2[1]}: {b2[2]:.4g} flop, {b2[3]} B, live block share {b2[4]:.3f})", flush=True)
        earlier = EARLIER_MS.get(r["key"])
        W, tables = fr.warps(dev), len(fr._tables._bytes)
        geom = ((W, tables + W * fr.warp_bytes), (1, tables + fw.warp_bytes))
        print(f"    {r['key']}: K1 {W} warps per block, {-(-fr.K // W)} blocks, {geom[0][1]} B "
              f"shared" + (f"; K1 {earlier[0] / k1_ms:.2f}x and K2 {earlier[1] / k2_ms:.2f}x "
                           f"faster than one thread per sample {earlier}" if earlier else ""),
              flush=True)
        for kname, line, n, e, tk, tp, b, extra, (wpb, smem) in (
                ("fused_rollout_kernel", 367, r["n1"], r["e1"], k1_ms, plain[0], b1, r["k1_extra"],
                 geom[0]),
                ("fused_world_step_kernel", 533, r["n2"], r["e2"], k2_ms, plain[1], b2,
                 r["k2_extra"], geom[1])):
            entries.append({
                "name": kname, "path": r["key"], "route": "cuda", "source": src,
                "replaces": f"mppiisaac_tpu/ops/pallas/fused_rollout.py:{line}",
                "launches": n, "max_abs_err": e, "ms": tk, "plain_ms": tp,
                "bound_ms": b[0], "bound_by": b[1], "library_ms": None,
                "warps_per_block": wpb, "smem_bytes": smem, **extra})
    print(f"    phase 18: {time.perf_counter() - t0:.1f} s", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip()
          else f"nvidia-smi unavailable (rc {smi.returncode})")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
