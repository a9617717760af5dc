"""Chip smoke run of the PyTorch + CUDA port (mppiisaac_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. build the CUDA kernels from csrc/ (nvcc, sm_90a) and print the seconds
     (the ablation and section libraries of phase 20 compile at the same
     time, each nvcc in a thread of its own),
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
     from the initial state, the first touching state of seed 1's episode
     (STICK_TOUCH_SEED1) and the loop's first touching state (STICK_BOUNDS;
     at a touching state a K1 bound is 10× the plain K1's own
     float32-vs-float64 drift there where that is larger: touch_bounds);
 12. omni_panda_pick (K=750, H=6, 8 sweeps in K1, effort drives with the
     finger motor) for 150 steps, launch counters checked: fails on a
     non-finite state or if the finger dofs never move; K1 and K2 against
     their plain versions from the initial state and the loop's last state
     (OMNI_BOUNDS). The states of phases 10-12 go to
     chiprun_out/<task>_states.pt;
 13. multi_jackal (K=300, H=12, two mesh-fitted floating jackals) at the
     conf's seed for 400 steps (twice the conf's: see MESH_LOOPS), then
     seeds 0-4 within 400 steps per step, of which JACKAL_MIN_RATE must
     bring both jackals within 0.25 m of their goals (jackal_rate); 14.
     albert (K=500,
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
 17a. the planner's direct API: point_robot (K=100, H=20) to within 0.1 m of
     its goal in its conf's 100 steps through `compute_action(q, qdot)`
     alone (the benchmark runner's path); then `update_weights` changes the
     next action from the same carry and state through the same
     FusedRollout (its identity and its launches checked),
     `update_mppi_params({"horizon": 10})` rebuilds it, and after
     `add_to_env` with one sphere the planner still plans finite actions;
 17b. the two-process examples on one card: the point_robot planner example
     (`python -m mppiisaac_tpu_torch.examples.point_robot.planner`) serves
     from a subprocess on a free port, its world example runs here to the
     goal within the conf's steps, and the first action over RPC equals the
     in-process `compute_action_tensor` from the same state and seed, bit
     for bit; then panda_pick for RPC_PICK_STEPS steps over RPC (no success
     bar: only dof and root states travel, not the λ rows, as in the JAX
     package) beside the same steps in process, through `run_task` and
     through `compute_action_tensor` (the RPC entry's own work without a
     second process), printing the three median control steps. K1's launches are the planner process's own count, which
     it prints when stopped; every subprocess is stopped whatever happens,
     and its failure fails the run;
 17c. seeded episodes on one build (`run_task_episodes`): pick over seeds 0-2
     within EPISODE_PICK_STEPS steps (fails unless one succeeds; the JAX
     package's rate is 10/10), multi_jackal over seeds 0-2 within its conf's
     200 steps (prints the rate; fails only on a non-finite state), and pick
     at seed 0 twice on one build: identical world states after
     DETERMINISM_STEPS steps. Phases 17a-17c check the launch counters of
     every loop and print their seconds;
 17d. the chunked loop (`device_steps`: one control step captured as a CUDA
     graph and replayed): pick at its shipped config, seed 0, for
     CHUNK_EQUAL_STEPS steps at device_steps=CHUNK_STEPS and at 1 on one
     build, world states and actions bit for bit (prints the largest |d|
     per field and the graph's nodes per control step); then panda reach,
     boxer_push, albert, multi_jackal, anymal (with its tape) and pick
     through `run_task(device_steps=CHUNK_STEPS)`, each to the goal or the
     step count of its earlier phase and ending at that phase's success step
     (multi_jackal also over phase 13's seeds, each at its success step),
     with the launch counters and the tape injections through the replays,
     printing the median control step beside the per-step loop's of the
     earlier phase; then the device's
     idle share over TRACE_STEPS steady steps of panda and pick, per step
     and chunked (torch.profiler; traces in profile_out/). Phase 17c's
     episodes run at device_steps=CHUNK_STEPS;
 17e. the batched world: the balls demo
     (`mppiisaac_tpu_torch.examples.balls_demo`, BALLS_ENVS = 1080 envs of 4
     balls, 100 steps after one warm-up step) through `Simulation.step`, one
     K2 launch per step over all envs (launches counted), the envs identical (1e-4, as the JAX demo)
     and the snapshot restored exactly; then the batched K2 held from the
     balls after BALLS_SETTLE steps with each env's x velocities drawn apart
     and from a randomized point robot pushing its block (256 envs, per-env
     mass, friction and commands), BATCH_HOLD_STEPS steps each: envs 0, N/2
     and N−1 of every launch bit for bit against the one-env launch on their
     inputs, the batch against the plain version on a slice of 16 envs
     within 10× that slice's own float32-vs-float64 drift (hold_batch);
 17f. the bench twin (`python -m mppiisaac_tpu_torch.bench`: pick K=1000,
     H=30, world fidelity, 1 sweep; its JSON line is printed on an earlier
     line) with its K1 launches counted, then its K1 on a command's inputs
     against the plain version on the first BENCH_PLAIN_SAMPLES samples
     (run on the host CPU beside the card's phases 18: PLAIN_WORKERS), by
     the largest difference, the first step's and the median over samples,
     each within BENCH_BOUNDS: 10× that plain version's own
     float32-vs-float64 drift in the same measure, measured on these inputs
     (`scripts/profile_torch_step.py --task bench --drift -`);
 18. time K1 and K2 on the reach, pick, boxer_push, panda_stick_push,
     omni_panda_pick, multi_jackal, albert, anymal, fast-pick and box-pair
     paths against their plain versions (CUDA events). To keep the run
     short, the plain K1 of phases 10-16 runs on the first PLAIN_K1_SAMPLES
     samples of the same packed inputs (samples are independent: the
     kernel's first costs are held against them); each path's plain K1 runs
     once over its hold states' samples side by side, and its plain K2
     steps those states as one batch (hold_k1s, hold_k2s); the plain K1 of
     phases 12-16 runs on the host CPU's workers beside the card's next
     phases, and its holds close here, before the timing; and the plain
     versions of every path but reach are timed once, in their holds
     (Python loops of small torch ops, seconds each); each path's phases
     print their seconds. The earlier paths keep their depth. Each kernel
     entry also gives its launch geometry (warps_per_block, smem_bytes);
     each path's line before them prints how many times faster both kernels
     are than with one thread per sample (EARLIER_MS). Then
     the batched K2 on phase 17e's balls (1080 envs, its launches those of
     the demo) and the bench's K1 at H=30, each as one more entry.
 19. the unfused rollout, the engine world and K-sharding:
 19a. panda reach (K=500, H=12) with `use_fused=False` (Engine.step,
     compute_cost): the first command on the card against the same command
     on the CPU (same state, same draw) within 10× the CPU's own
     float32-vs-float64 drift of that command's rollout; then the loop to
     its goal within the conf's 200 steps per step and at device_steps=16
     (one captured control step), K1 never launched, K2 once per world
     step; prints the median control steps, the aten ops of one command and
     the graph's nodes per step;
 19b. the same loop (chunked) with ArmJacobianPrior and use_priors: sample
     K−2's applied controls of the first command against the prior's
     clipped commands along that sample's own rollout, replayed alone
     (PRIOR_REPLAY_ATOL); prints the success step (not held);
 19c. point_robot (K=100, H=20) with a goal actor and PointNavigationPrior
     to its goal (chunked); then K2 from the loop's state at step 8 (the
     robot moving, its dof_target nonzero) over 5 steps against its plain
     version within 10× the plain version's own float32-vs-float64 drift
     there (floor 1e-6; the drift printed beside each bound), and timed;
 19d. `SimConfig.fused_world=False`: 19c's loop for ENGINE_WORLD_STEPS
     steps with the world on Engine.step (no kernel launched), replayed on
     the CPU with the card's actions, every field within 10× the CPU's own
     float32-vs-float64 drift of the replay (at least 1e-5); then the balls
     demo's scene at 1080 envs stepped by Engine.step, ms and env-steps/s
     beside K2's of phase 17e;
 19e. K-sharding: panda_pick (K=1000, H=12) with `fused_factory` on 2 gloo
     ranks sharing the card (`python -m mppiisaac_tpu_torch.parallel.sharding`,
     one process each), each rank's K1 over 500 samples once per command,
     beside the one-device command of the same carry and state: the same
     action on every rank and within 1e-5 relative of the one-device one,
     the per-sample costs equal (bit for bit, or within 1e-5 of the largest
     cost: it prints which), both command times; then K1 at K=500 from the
     settled block against plain (PICK_BOUNDS) and timed. NCCL across cards
     is not exercised (one card). Phase 19 adds three kernel entries: K2 under
     19a-19b (timed in phase 18 on the reach), K2 under 19c, K1 per rank in
     19e.
 20. the kernels' profiling ablations (ops/native.py ABLATE, csrc AB_*):
 20a. the ablation library's nvcc seconds and registers (one nvcc run for
     every mask) and the section build's;
 20b. at phase 6's held grasp (committed as HELD_GRASP), ABLATE_K samples
     at H=ABLATE_H: K1 nocost, nocontact, fkonly, oneway
     (two_way_sweeps=False) and nogate, and K2 oneway and nogate over
     ABLATE_K2_STEPS world steps, against their ablated plain versions (run
     on the host CPU from the start of the run: ablation_plain), each
     measure within ABLATE_BOUNDS (10× that plain version's own
     float32-vs-float64 drift there, floor 1e-6), the costs and, under
     zero_cost (nocost, fkonly), vis (the sum of the actors' root
     positions); fkonly from the grasp with every root given a seeded
     velocity, and its vis shown to move from the input's; K1 and K2 with
     the broadphase gate off bit for bit the default kernels;
 20c. the ablation profiler (`python -m mppiisaac_tpu_torch.profile_kernel`:
     the bench twin's pick at K=1000, H=30) with the launch counts zeroed
     before it and read after it, every ablated kernel launched there, its
     BREAKDOWN printed beside the clock64() split of the full K1 by section
     on the same inputs, with the card's name and power limit. Each ablated
     kernel is a kernel entry of its own (its time the profiler's, its
     error and plain time those of 20b).
 21. multi_jackal's recorded control steps (JACKAL_RECORDS: seed 42's
     initial state and states along seeds 0-4's episodes on the card,
     stalls among them): from each record's carry and world state the
     card's command (K1 at K=300, H=12) and from its state and action K2,
     launch counters zeroed before and read after, held against the JAX
     package's outputs stored beside the record (its Pallas K1 and K2 in
     interpret mode on the CPU, scripts/jackal_commands_jax.py): the
     rollout's costs (largest, first step's, median over samples), S, the
     new U, the action and the state after K2 by row group, each within 10×
     the port plain's own rounding at that record: the larger of its
     float32-vs-float64 drift and its envelope under one float32 rounding of
     the state.
Every K2 hold (hold_k2s: phases 6 and 8-17; hold_batch: 17e and 19c) and
phase 21's world steps also hold the body caches K2's epilogue writes
(positions, quaternions, linear and angular velocities of the stepped
state) against `engine.refresh` of the same state, each within the larger
of 1e-5 and 10× the float32 refresh's own drift from a float64 refresh
(body_cache_gaps); a batch's body rows of envs 0, N/2 and N−1 bit for bit
their one-env launches'. Phase 18 times K2 with its body rows beside K2
without them (`body_rows_ms`), and the run fails if a world step on the card
took its body caches from the torch refresh (FusedWorldStep.torch_refreshes).
Each kernel's bound — the least time the card could take for the same work —
is the larger of its bytes (inputs read once, outputs written once) over
3.35 TB/s and its float32 operations over 67 TFLOP/s; the operations are
counted on the plain version's first substep from the same inputs (one per
element of each arithmetic op, 2mnk per matrix product; the work of contact
blocks scaled by the share of (sample, block) pairs whose gate is on, which
is what the kernel computes), times the substeps and steps.
Prints the whole run's seconds, the card's name and power limit, one JSON
line describing the kernels on each path, and as its last line
`{"ok": true, "device": {...}}`.
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
PER_STEP = {}           # the per-step loops' (median control step ms, success step), by conf (phase 17d)
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


def _function_switches(profile):
    """The ablations of a wrapper's profile that change the function it
    computes: broadphase_gate=False gives the gated function, so its bound
    is the gated one's (the gate's live share applies)."""
    return {k: v for k, v in profile.items() if k not in ("zero_cost", "broadphase_gate")}


def k1_bound(fr, k1_in):
    """(bound ms, bound_by, flops, bytes, live share) of K1 on these inputs."""
    from mppiisaac_tpu_torch.ops import fused_physics as fp

    rows, V, mass, fric = k1_in
    sw = _function_switches(fr.profile)
    with torch.no_grad(), OpCount() as c:
        st = fp.rows_to_state(fr.ks, rows)
        tgt = fp.command_targets(fr.ks, V[0].T.float(), st["q"])
        st = fp.substep(fr.ks, st, tgt, mass.T, fric.T, fr.dt_sub, fr.impulse_sweeps,
                        fr.world_fidelity, **sw)
        sub = c.flops
        if not fr.profile["zero_cost"]:
            pos, quat, _, _, _ = fp.fk(fr.ks, st)
            fp.task_cost(fr.ks, st, pos, quat)
    flops = sub * fr.substeps * fr.H + (c.flops - sub) * fr.H
    nbytes = _nbytes(rows, V, mass, fric) + len(fr._tables._bytes) + fr.K * fr.H * 4 * 4
    return _bound(flops, nbytes) + (c.live_share,)


def k2_bound(fw, k2_in):
    """(bound ms, bound_by, flops, bytes, live share) of K2 on these inputs
    (one env, or N envs in the kernel's layout)."""
    from mppiisaac_tpu_torch.ops import fused_physics as fp

    rows, tgt, mass, fric = (x if x.dim() == 2 else x[:, None] for x in k2_in)
    with torch.no_grad(), OpCount() as c:
        st = fp.rows_to_state(fw.ks, rows)
        fp.substep(fw.ks, st, tgt.T, mass.T, fric.T, fw.dt_sub, fw.impulse_sweeps,
                   **_function_switches(fw.profile))
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


# the plain versions of phases 17f, 20b and the K1 holds of 12-16 run on the
# card's host CPU, in worker processes that overlap the card's phases (the
# card's machine has 8 cores; a plain version is launch-bound on the card:
# 20b's nocost K1 on 8 samples at H=12 took 24.5 s there and takes 6.5-9.9 s
# on the host's CPU)
PLAIN_WORKERS, PLAIN_THREADS = 2, 2


def _plain_worker_init(root, threads):
    sys.path.insert(0, root)
    torch.set_num_threads(threads)


def plain_pool(root):
    """The host CPU's worker processes for plain versions (spawned: they
    import torch and the port afresh, and touch no CUDA)."""
    import concurrent.futures
    import multiprocessing

    return concurrent.futures.ProcessPoolExecutor(
        PLAIN_WORKERS, mp_context=multiprocessing.get_context("spawn"),
        initializer=_plain_worker_init, initargs=(root, PLAIN_THREADS))


def stop_pool(pool):
    """Stop the workers whatever they are doing."""
    procs = list(getattr(pool, "_processes", {}).values())
    pool.shutdown(wait=False, cancel_futures=True)
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(timeout=10)


def timed_plain(fn, *args, **kw):
    """fn(*args, **kw) on the host CPU → (its output, its ms)."""
    t = time.perf_counter()
    out = fn(*args, **kw)
    return out, (time.perf_counter() - t) * 1e3


BODY_CACHES = ("body_pos", "body_quat", "body_linvel", "body_angvel")


def body_cache_gaps(engine, st):
    """K2's body caches in the stepped SimState `st` against
    `engine.refresh` of the same state. → {cache: (max |d|, bound)}, each
    bound the larger of 1e-5 and 10× the float32 refresh's own max |d| from
    a float64 refresh of the same state."""
    r32 = engine.refresh(st)
    r64 = engine.refresh(st.map(lambda x: x.double() if x.is_floating_point() else x))
    out = {}
    for f in BODY_CACHES:
        got, ref = getattr(st, f).double(), getattr(r32, f).double()
        drift = (ref - getattr(r64, f)).abs().max().item()
        out[f] = ((got - ref).abs().max().item(), max(1e-5, 10 * drift))
    return out


def hold_bodies(name, engine, st):
    """Fail unless K2's body caches in `st` are within body_cache_gaps's
    bounds. → the largest |d|."""
    gaps = body_cache_gaps(engine, st)
    print(f"  {name}: K2's body caches against engine.refresh: max|d| " + ", ".join(
        f"{f[5:]} {e:.2e} (bound {b:.2e})" for f, (e, b) in gaps.items()), flush=True)
    if not all(e <= b for e, b in gaps.values()):
        fail(f"{name}: K2's body caches disagree with engine.refresh")
    return max(e for e, _ in gaps.values())


def hold_k2s(fw, cases, n):
    """K2 against its plain version over n world steps from each case's
    state: cases [(name, s0, tgt_of, bound)]. The kernel steps each state on
    its own, as the world does; the plain version steps all of them side by
    side, one env per column (envs are independent). Max |d| by row group
    (pose, vel, lam), checked against each `bound`; where the scene has λ
    rows, the plain version must leave an impulse in them after one of the
    steps at least. The kernel writes its body rows at every step; the last
    step's are held against engine.refresh (hold_bodies). → {name: (the
    largest group's |d|, the last step's kernel inputs, the plain version's
    ms per step for all the states)}."""
    from mppiisaac_tpu_torch.ops.fused_rollout import world_step_plain

    ks = fw.ks
    dev = cases[0][1].q.device
    ones_b = torch.ones(ks.nbody, device=dev)
    ones_g = torch.ones(ks.ngeom, device=dev)
    r = [fw.pack(s0).contiguous() for _, s0, _, _ in cases]
    body = [torch.empty(13 * ks.nbody, device=dev) for _ in cases]
    rp = torch.stack(r, 1)
    N = len(cases)
    NS = ks.n_state_rows
    lam = torch.zeros(N, device=dev)  # the largest λ after each step, per state
    plain_ms = 0.0
    for i in range(n):
        tgt = [tgt_of(i) for _, _, tgt_of, _ in cases]
        r = [fw.step_rows(rc, tc, ones_b, ones_g, body=bc) for rc, tc, bc in zip(r, tgt, body)]
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
        s0 = cases[j][1].map(lambda x: x[None])
        hold_bodies(name, fw.engine, fw.unpack(s0, r[j][:, None], body[j][:, None]))
        out[name] = (max(groups.values()), (r[j], tgt[j], ones_b, ones_g), plain_ms)
    return out


def hold_k1s(fr, cases, n_plain=None, pool=None):
    """K1 against its plain version from each case's inputs: cases [(name,
    k1_in, bound)]. The kernel runs on each case's packed inputs (the main
    path's shapes); the plain version runs once, on the cases' samples side
    by side (the first n_plain of each, or all; samples are independent),
    and each case's kernel samples are held against theirs: max, first-step
    and median-over-samples cost differences, checked against the k1_*
    entries of its bound. → {name: errors, with "plain_ms" the one plain
    call's}; with a `pool`, the plain version runs on the host CPU's
    workers and the holds when the returned function is called (→ the
    same)."""
    from mppiisaac_tpu_torch.ops.fused_rollout import rollout_plain

    outs = [fr.run(*k1_in) for _, k1_in, _ in cases]
    torch.cuda.synchronize()
    n = n_plain or fr.K
    cat = [torch.cat([k1_in[i][..., :n] for _, k1_in, _ in cases], -1).contiguous()
           for i in range(4)]
    args = (fr.H, fr.substeps, fr.dt_sub, fr.vis_body, fr.impulse_sweeps, fr.world_fidelity)
    if pool is not None:
        host = [x.cpu() for x in cat]
        plain = pool.submit(timed_plain, rollout_plain, fr.ks, host[0], host[1].float(),
                            host[2], host[3], *args)
        outs = [(c[:n].cpu(), v[:, :n].cpu()) for c, v in outs]
        return lambda: _k1_checks(cases, outs, *plain.result(), n, " on the host CPU")
    with Timer() as t:
        out = rollout_plain(fr.ks, cat[0], cat[1].float(), cat[2], cat[3], *args)
    return _k1_checks(cases, outs, out, t.ms, n, "")


def _k1_checks(cases, outs, plain, ms, n, where):
    """hold_k1s' holds of each case's kernel outputs against its samples of
    the plain version's `plain` (costs, vis) → {name: errors}."""
    cp_all, vp_all = plain
    errs = {}
    for j, ((name, _, bound), (c, v)) in enumerate(zip(cases, outs)):
        c, v = c[:n], v[:, :n]
        cp, vp = cp_all[j * n:(j + 1) * n], vp_all[:, j * n:(j + 1) * n]
        if not bool(torch.isfinite(c).all()):
            fail(f"{name}: K1 costs are not finite")
        d = (c.double() - cp.double()).abs()
        err = dict(max=d.max().item(), first=d[:, 0].max().item(),
                   median=d.max(1).values.median().item(), plain_ms=ms)
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
    print(f"    the plain K1 ran once on {len(cases)} × {n} samples{where}: {ms / 1e3:.1f} s",
          flush=True)
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
    PER_STEP["panda"] = (1e3 / float(np.median(m.fps)), m.success_step)
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
    PER_STEP["panda_pick"] = (1e3 / float(np.median(pm.fps)), pm.success_step)
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
        PER_STEP[task] = (1e3 / float(np.median(mm.fps)), mm.success_step)
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


def hold_states(key, cfg, obj, dev, root, named, bounds, n_plain=None, pool=None):
    """K1 and K2 of the scene of `cfg` against their plain versions, with the
    hold controls of `key`, from each (name, state) of `named` (None: the
    conf's initial state); the states are first saved to
    chiprun_out/<key>_states.pt. → (fr, fw, the last state's K1 and K2
    inputs, {state: (K1 errors, K2 error, K2 plain ms)}); with a `pool`
    (hold_k1s) the last is a function that holds K1 and returns it."""
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
    e1s, e2s = hold_k1s(fr, k1_cases, n_plain, pool), hold_k2s(fw, k2_cases, 5)

    def errs_of(e1s):
        return {name: (e1s[f"{key} {name}"], *e2s[f"{key} {name}"][::2]) for name in states}

    k2_in = e2s[k2_cases[-1][0]][1]
    return fr, fw, k1_in, k2_in, (lambda: errs_of(e1s())) if callable(e1s) else errs_of(e1s)


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


# phase 11's second first touch: the stick's first touching state of seed 1's
# episode on the card (`validate.py one panda_stick_push mppi.seed_val=1
# record=`, `scripts/profile_torch_step.py --first-touch`), held as the
# loop's own first touch is (touch_bounds)
STICK_TOUCH_SEED1 = "tests/data/panda_stick_push_first_touch_seed1.pt"
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


def arm_path(task, dev, root, pool):
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
        # the first touch of another episode (seed 1), recorded on the card
        from mppiisaac_tpu_torch.physics.types import SimState

        seen["touching seed 1"] = SimState(**torch.load(os.path.join(root, STICK_TOUCH_SEED1)))\
            .map(lambda x: x[None].to(dev))
        bounds = dict(bounds, **{k: touch_bounds(task, cfg, obj, dev, seen[k], bounds["touching"])
                                 for k in ("touching", "touching seed 1")})
    if task == "omni_panda_pick":
        print(f"    the finger dofs moved by up to {seen['finger_move']:.4f} m", flush=True)
        if seen["finger_move"] < 1e-3:
            fail("omni_panda_pick's finger dofs never moved")

    # (a loop that ends before step 20 holds its last state instead)
    named = [("initial", None), (second, seen.get(second, seen["last"]))]
    if "touching seed 1" in seen:
        named.insert(1, ("touching seed 1", seen["touching seed 1"]))
    # the touching states' bounds are the card's own drift there (touch_bounds),
    # so the stick's holds stay against the card's plain version
    return held_path(task, cfg, obj, dev, root, named, bounds, n1, n2,
                     pool if task == "omni_panda_pick" else None)


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


def held_path(key, cfg, obj, dev, root, named, bounds, n1, n2, pool=None):
    """The holds of a loop's path from its named states (hold_states, the
    plain K1 on PLAIN_K1_SAMPLES samples; the last state's inputs are the
    timed ones) → its timed path: the first state's errors as max_abs_err,
    the others' beside them. With a `pool` the K1 holds wait for phase 18
    (the record's "finish")."""
    t0 = time.perf_counter()
    fr, fw, k1_in, k2_in, errs = hold_states(key, cfg, obj, dev, root, named, bounds,
                                             n_plain=PLAIN_K1_SAMPLES, pool=pool)
    print(f"    holds: {time.perf_counter() - t0:.1f} s", flush=True)

    def finish(errs):
        first = named[0][0]
        k1_extra, k2_extra = {"plain_samples": PLAIN_K1_SAMPLES}, {}
        for name, _ in named[1:]:
            tag = name.replace(" ", "_")
            e1, e2, _ = errs[name]
            k1_extra.update({f"{tag}_first_step_max_abs_err": e1["first"],
                             f"{tag}_median_max_abs_err": e1["median"],
                             f"{tag}_max_abs_err": e1["max"]})
            k2_extra[f"{tag}_max_abs_err"] = e2
        last = errs[named[-1][0]]
        return dict(e1=errs[first][0]["max"], e2=errs[first][1],
                    plain=(last[0]["plain_ms"], last[2]), k1_extra=k1_extra, k2_extra=k2_extra)

    if callable(errs):
        return dict(timed_path(key, fr, fw, k1_in, k2_in, n1, n2, None, None),
                    finish=lambda: finish(errs()))
    return timed_path(key, fr, fw, k1_in, k2_in, n1, n2, **finish(errs))


# phases 13-14: (phase, the JAX package's success step, the loop's steps).
# multi_jackal runs twice its conf's 200 steps and is held to a rate over
# JACKAL_SEEDS (jackal_rate), where the JAX package's one episode reached
# both goals at 147; albert runs its conf's 500
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


JACKAL_SEEDS = (0, 1, 2, 3, 4)
# the least number of JACKAL_SEEDS whose episode brings both jackals to
# their goals within 400 steps: the rate measured on the H100 before and
# after the Savitzky–Golay filter became one matrix (3/5 both times, other
# seeds: PERF.md §6), so one seed fewer fails the run
JACKAL_MIN_RATE = 3
JACKAL_PER_STEP = {}     # seed → success step of phase 13's per-step episodes


def jackal_episodes(cfg, obj, succ, dev, n_steps, device_steps):
    """The multi_jackal episodes of JACKAL_SEEDS within n_steps on one build
    (`run_task_episodes`), launch counters checked. → {seed: success step}."""
    from mppiisaac_tpu_torch.runtime.loop import run_task_episodes

    reset_counts()
    rs = run_task_episodes(cfg, obj, list(JACKAL_SEEDS), n_steps=n_steps, success_fn=succ,
                           device=dev, device_steps=device_steps)
    n1, n2 = read_counts()
    ok = {s: m.success_step for s, m in rs.items()}
    rate = sum(v is not None for v in ok.values())
    print(f"    multi_jackal over seeds {list(JACKAL_SEEDS)} within {n_steps} steps at "
          f"device_steps={device_steps}: {rate}/{len(rs)} (success steps {ok}); launches K1 "
          f"{n1}, K2 {n2}", flush=True)
    if n1 != sum(m.commands for m in rs.values()) or n2 != n1:
        fail("launch counters do not match the commands and world steps run")
    if not all(m.final_state_finite for m in rs.values()):
        fail("non-finite world state")
    return ok


def jackal_rate(cfg, obj, succ, dev, n_steps):
    """Phase 13's bar for multi_jackal: a rate, not one seed (one episode
    decides nothing: ROADMAP §3). The per-step episodes of JACKAL_SEEDS
    within n_steps; fails unless at least JACKAL_MIN_RATE reach both goals.
    Their success steps are held again through the chunked loop in 17d."""
    ok = jackal_episodes(cfg, obj, succ, dev, n_steps, device_steps=1)
    JACKAL_PER_STEP.update(ok)
    rate = sum(v is not None for v in ok.values())
    if rate < JACKAL_MIN_RATE:
        fail(f"multi_jackal reached both goals in {rate} of seeds {list(JACKAL_SEEDS)} within "
             f"{n_steps} steps, fewer than {JACKAL_MIN_RATE}")


def mesh_path(task, dev, root, pool):
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
    PER_STEP[task] = (1e3 / float(np.median(m.fps)), m.success_step)
    if task == "multi_jackal":
        jackal_rate(cfg, obj, succ, dev, n_steps)
    elif m.success_step is None:
        fail(f"{task} did not reach its goal within {n_steps} steps")
    return held_path(task, cfg, obj, dev, root,
                     [("initial", None), ("in motion", seen.get("in motion", seen["last"]))],
                     MESH_BOUNDS[task], n1, n2, pool)


def anymal_path(dev, root, pool):
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
            PER_STEP["anymal"] = (1e3 / float(np.median(m.fps)), m.success_step)
    seen = kept["seen"]
    return held_path("anymal", kept["cfg"], kept["obj"], dev, root,
                     [("landed", seen.get("landed", seen["last"])), ("last", seen["last"])],
                     ANYMAL_BOUNDS, kept["n1"], kept["n2"], pool)


def fast_pick_path(dev, root, pick, pool):
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
    errs = hold_k1s(fr, cases, PLAIN_K1_SAMPLES, pool)
    print(f"    holds: {time.perf_counter() - t0:.1f} s", flush=True)

    def finish(errs):
        e1 = errs["held grasp"]
        return dict(e1=errs["settled block"]["max"], e2=pick["k2_err"],
                    plain=(e1["plain_ms"], pick["k2_plain"]),
                    k1_extra={"held_grasp_first_step_max_abs_err": e1["first"],
                              "held_grasp_median_max_abs_err": e1["median"],
                              "held_grasp_max_abs_err": e1["max"],
                              "plain_samples": PLAIN_K1_SAMPLES})

    return dict(timed_path("panda_pick_fast", fr, pick["fw"], k1_in, pick["k2_in"], n1, n2,
                           None, None), finish=lambda: finish(errs()))


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


EPISODE_SEEDS = (0, 1, 2)
EPISODE_PICK_STEPS = 600
RPC_PICK_STEPS = 30
DETERMINISM_STEPS = 20
API_SPHERE = {"type": "sphere", "name": "api_obstacle", "size": [0.2],
              "init_pos": [1.0, 0.2, 0.2], "mass": 1.0, "fixed": True}


def reset_counts():
    from mppiisaac_tpu_torch.ops.fused_rollout import FusedRollout, FusedWorldStep

    FusedRollout.launches = 0
    FusedWorldStep.launches = 0


def read_counts():
    from mppiisaac_tpu_torch.ops.fused_rollout import FusedRollout, FusedWorldStep

    torch.cuda.synchronize()
    return FusedRollout.launches, FusedWorldStep.launches


def api_path(dev):
    """Phase 17a: point_robot to its goal through the direct call
    `compute_action(q, qdot)` alone (the benchmark runner's path); then
    update_weights changes the next action through the same FusedRollout,
    update_mppi_params({"horizon": ...}) rebuilds it, and after add_to_env
    with one sphere the planner still plans finite actions."""
    from mppiisaac_tpu_torch.planner.mppi_isaac import MPPIisaacPlanner
    from mppiisaac_tpu_torch.runtime.loop import goal_world
    from mppiisaac_tpu_torch.tasks import point_robot
    from mppiisaac_tpu_torch.utils.config_store import load_config

    t0 = time.perf_counter()
    cfg = load_config("tasks/point_robot")
    obj = point_robot.PointRobotObjective(cfg)
    planner = MPPIisaacPlanner(cfg, obj, device=dev)
    world = goal_world(cfg, dev)
    success = point_robot.success_fn(obj.nav_goal)
    reset_counts()
    step, done = 0, False
    while step < cfg.n_steps and not done:
        ds = world.dof_state[0].cpu().numpy()
        a = planner.compute_action(ds[:, 0], ds[:, 1])
        world.apply_robot_cmd(a)
        world.step()
        step += 1
        done = success(world)
    n1, n2 = read_counts()
    finite = all(bool(torch.isfinite(t).all()) for t in world.state.tensors())
    print(f"[17a] point_robot through compute_action(q, qdot) alone, K={cfg.mppi.num_samples} "
          f"H={cfg.mppi.horizon}: {'success at step ' + str(step - 1) if done else 'no success'} "
          f"(run_task: 41), {step} steps (conf {cfg.n_steps}), finite {finite}; launches K1 {n1}, "
          f"K2 {n2}", flush=True)
    if not done:
        fail("point_robot did not reach its goal through compute_action within the conf's steps")
    if not finite:
        fail("non-finite world state")
    if n1 != step or n2 != step:
        fail("launch counters do not match the commands and world steps run")

    # the same carry and state, other weights: another action, the same rollout
    ds = world.dof_state[0].cpu().numpy()
    fr, carry = planner.mppi.fused, planner.mppi.carry
    reset_counts()
    a_before = planner.compute_action(ds[:, 0], ds[:, 1])
    planner.mppi.carry = carry
    planner.update_weights({"nav": 0.0, "obstacle": 0.1, "coll": 0.0})
    a_after = planner.compute_action(ds[:, 0], ds[:, 1])
    n1, _ = read_counts()
    print(f"    update_weights(nav 1 -> 0): action {np.round(a_before, 4).tolist()} -> "
          f"{np.round(a_after, 4).tolist()}, same FusedRollout {planner.mppi.fused is fr}, "
          f"K1 launches {n1} for 2 commands", flush=True)
    if planner.mppi.fused is not fr or n1 != 2:
        fail("update_weights built a new FusedRollout or did not launch it")
    if np.array_equal(a_before, a_after):
        fail("update_weights did not change the next action")
    planner.update_mppi_params({"horizon": 10})
    reset_counts()
    a = planner.compute_action(ds[:, 0], ds[:, 1])
    n1, _ = read_counts()
    print(f"    update_mppi_params(horizon 10): new FusedRollout {planner.mppi.fused is not fr}, "
          f"H {planner.mppi.fused.H}, U {tuple(planner.mppi.carry.U.shape)}, finite "
          f"{bool(np.isfinite(a).all())}, K1 launches {n1}", flush=True)
    if planner.mppi.fused is fr or planner.mppi.fused.H != 10 or n1 != 1 or not np.isfinite(a).all():
        fail("update_mppi_params did not rebuild the rollout at the new horizon")
    planner.add_to_env([dict(API_SPHERE)])
    reset_counts()
    acts = [planner.compute_action(ds[:, 0], ds[:, 1]) for _ in range(3)]
    n1, _ = read_counts()
    print(f"    add_to_env(one sphere): {planner.mppi.fused.ks.nactor} actors in the rollout, "
          f"3 actions finite {all(np.isfinite(x).all() for x in acts)}, K1 launches {n1}; "
          f"phase 17a {time.perf_counter() - t0:.1f} s", flush=True)
    if planner.mppi.fused.ks.nactor != 2 or n1 != 3 or not all(np.isfinite(x).all() for x in acts):
        fail("the planner does not plan over the scene after add_to_env")


def remote_launches(proc, module):
    """Stop a planner example process; → its K1 launches, or fail."""
    from planner_process import stop_planner

    rc = stop_planner(proc)
    log = "".join(proc.log)
    lines = [ln for ln in proc.log if ln.startswith("planner stopped: ")]
    if rc != 0 or not lines:
        fail(f"{module} ended with rc {rc}:\n{log[-3000:]}")
    return int(lines[-1].rsplit(" ", 1)[1])


def rpc_path(dev, root):
    """Phase 17b: the two-process examples on one card. The point_robot
    planner example serves on a free port from a subprocess, and its world
    example runs here to the goal; its first action over RPC equals the
    in-process compute_action_tensor from the same state and seed, bit for
    bit. Then panda_pick for RPC_PICK_STEPS steps over RPC beside the same
    steps in process, through run_task and through compute_action_tensor
    (no success bar: the λ rows do not travel, as in the JAX package).
    Each subprocess is stopped whatever happens."""
    from planner_process import launch_planner, stop_planner
    from mppiisaac_tpu_torch.examples.panda_pick import world as pick_world
    from mppiisaac_tpu_torch.examples.point_robot import world as pr_world
    from mppiisaac_tpu_torch.planner.mppi_isaac import MPPIisaacPlanner
    from mppiisaac_tpu_torch.runtime.loop import goal_world, run_task
    from mppiisaac_tpu_torch.runtime.transport import bytes_to_torch, torch_to_bytes
    from mppiisaac_tpu_torch.tasks import panda_pick, point_robot
    from mppiisaac_tpu_torch.utils.config_store import load_config

    t0 = time.perf_counter()
    runs = {}
    for key, module, world_mod in (
            ("point_robot", "mppiisaac_tpu_torch.examples.point_robot.planner", pr_world),
            ("panda_pick", "mppiisaac_tpu_torch.examples.panda_pick.planner", pick_world)):
        t1 = time.perf_counter()
        try:
            proc, endpoint = launch_planner(module, [f"device={dev.type}",
                                                     "endpoint=tcp://127.0.0.1:0"],
                                            timeout=300, cwd=root)
        except (RuntimeError, TimeoutError) as e:
            fail(f"{module} did not start: {e}")
        up_s = time.perf_counter() - t1
        actions = []
        try:
            reset_counts()
            args = [f"device={dev.type}", f"endpoint={endpoint}"]
            if key == "panda_pick":
                args.append(f"n_steps={RPC_PICK_STEPS}")
            m = world_mod.run(args, device=dev.type, verbose=False,
                              observer=lambda step, w, a: actions.append(a.clone()))
            _, n2 = read_counts()
            alive = proc.poll() is None
        finally:
            if proc.poll() is None:
                n1 = remote_launches(proc, module)
            else:
                stop_planner(proc)
                fail(f"{module} died:\n{''.join(proc.log)[-3000:]}")
        if not alive:
            fail(f"{module} died during the run")
        runs[key] = (m, n1, n2, actions, up_s)
        print(f"[17b] {key} over RPC ({module} on {endpoint}, up in {up_s:.1f} s): "
              f"success_step {m.success_step}, {m.steps} steps, median step {1e3 / float(np.median(m.fps)):.3f} ms "
              f"(RPC round trip {np.median(m.solver_time) * 1e3:.3f} ms), finite "
              f"{m.final_state_finite}; launches K1 {n1} (planner process), K2 {n2}", flush=True)
        if not m.final_state_finite:
            fail("non-finite world state")
        if n1 != m.steps or n2 != m.steps or n1 == 0:
            fail("launch counters do not match the commands and world steps run")

    m = runs["point_robot"][0]
    if m.success_step is None:
        fail("point_robot over RPC did not reach its goal within the conf's steps")
    cfg = load_config("tasks/point_robot")
    world = goal_world(cfg, dev)
    planner = MPPIisaacPlanner(cfg, point_robot.PointRobotObjective(cfg), device=dev)
    direct = bytes_to_torch(planner.compute_action_tensor(
        torch_to_bytes(world.dof_state[0]), torch_to_bytes(world.root_state[0])))
    first = runs["point_robot"][3][0].cpu()
    same = bool(torch.equal(first, direct))
    print(f"    first RPC action {first.tolist()} vs in-process compute_action_tensor "
          f"{direct.tolist()}: bit for bit {same}", flush=True)
    if not same:
        fail("the first RPC action differs from the in-process action")

    # pick in process, twice: run_task (the world state broadcast K-wide),
    # and the RPC entry's own work without the second process (state bytes
    # in, the refresh of their body caches, action bytes out)
    pcfg = load_config("tasks/panda_pick")
    reset_counts()
    pm = run_task(pcfg, panda_pick.PandaPickObjective(pcfg), n_steps=RPC_PICK_STEPS, device=dev)
    n1, n2 = read_counts()
    world = goal_world(pcfg, dev)
    planner = MPPIisaacPlanner(pcfg, panda_pick.PandaPickObjective(pcfg), device=dev)
    reset_counts()
    bytes_ms, split = [], []     # the step; (state in, command, world step)
    for _ in range(RPC_PICK_STEPS):
        t1 = time.perf_counter()
        planner.objective.reset()
        planner.reset_rollout_sim(torch_to_bytes(world.dof_state[0]),
                                  torch_to_bytes(world.root_state[0]))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        a = bytes_to_torch(planner.command(), dev)
        t3 = time.perf_counter()
        world.apply_robot_cmd(a)
        world.step()
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        bytes_ms.append((t4 - t1) * 1e3)
        split.append(((t2 - t1) * 1e3, (t3 - t2) * 1e3, (t4 - t3) * 1e3))
    b1, b2 = read_counts()
    split = np.median(np.array(split), axis=0)
    rm = runs["panda_pick"][0]
    rpc_ms, local_ms = 1e3 / float(np.median(rm.fps)), 1e3 / float(np.median(pm.fps))
    print(f"    panda_pick {RPC_PICK_STEPS} steps, median control step: over RPC {rpc_ms:.3f} ms, in "
          f"process {local_ms:.3f} ms (launches K1 {n1}, K2 {n2}), in process through "
          f"compute_action_tensor {float(np.median(bytes_ms)):.3f} ms (state in "
          f"{split[0]:.3f}, command {split[1]:.3f}, world step {split[2]:.3f}; launches K1 {b1}, "
          f"K2 {b2}): "
          f"RPC overhead {rpc_ms - local_ms:.3f} ms; phase 17b {time.perf_counter() - t0:.1f} s",
          flush=True)
    if {n1, n2, b1, b2} != {RPC_PICK_STEPS}:
        fail("launch counters do not match the commands and world steps run")


def episode_paths(dev):
    """Phase 17c: seeded episodes on one build (`run_task_episodes`): pick
    over EPISODE_SEEDS within EPISODE_PICK_STEPS (fails if no seed succeeds:
    the JAX package's rate is 10/10), multi_jackal within its conf's 200
    steps (prints the rate, fails on nothing but a non-finite state), and
    seed 0 twice on one pick build: identical world states after
    DETERMINISM_STEPS steps."""
    from mppiisaac_tpu_torch.physics.types import SIM_STATE_FIELDS
    from mppiisaac_tpu_torch.runtime.loop import run_task_episodes
    from mppiisaac_tpu_torch.tasks import multi_robot, panda_pick
    from mppiisaac_tpu_torch.utils.config_store import load_config

    t0 = time.perf_counter()
    for key in ("panda_pick", "multi_jackal"):
        t1 = time.perf_counter()
        cfg = load_config(f"tasks/{key}")
        if key == "panda_pick":
            obj, n = panda_pick.PandaPickObjective(cfg), EPISODE_PICK_STEPS
            succ, jax_rate = panda_pick.success_fn(), "10/10 (steps 126-224, RESULTS_r5.json)"
        else:
            obj, n = multi_robot.MultiJackalObjective(cfg), cfg.n_steps
            succ, jax_rate = multi_robot.success_fn(key, obj), "suite seed: step 147"
        reset_counts()
        rs = run_task_episodes(cfg, obj, list(EPISODE_SEEDS), n_steps=n, success_fn=succ, device=dev,
                               device_steps=CHUNK_STEPS)
        n1, n2 = read_counts()
        steps = sum(m.commands for m in rs.values())
        ok = {s: m.success_step for s, m in rs.items()}
        rate = sum(v is not None for v in ok.values())
        print(f"[17c] run_task_episodes {key} seeds {list(EPISODE_SEEDS)} within {n} steps: "
              f"{rate}/{len(rs)} (success steps {ok}; the JAX package: {jax_rate}), median control "
              f"step {1e3 / float(np.median([f for m in rs.values() for f in m.fps])):.3f} ms; "
              f"launches K1 {n1}, K2 {n2} ({steps} steps run, chunks of {CHUNK_STEPS}); "
              f"{time.perf_counter() - t1:.1f} s",
              flush=True)
        if not all(m.final_state_finite for m in rs.values()):
            fail("non-finite world state")
        if n1 != steps or n2 != steps:
            fail("launch counters do not match the commands and world steps run")
        if key == "panda_pick" and rate == 0:
            fail("no pick episode brought the block within 0.2 m of the goal")

    cfg = load_config("tasks/panda_pick")
    states = []

    def record(world):
        states.append(world.state)
        return False

    reset_counts()
    run_task_episodes(cfg, panda_pick.PandaPickObjective(cfg), [0, "0"],
                      n_steps=DETERMINISM_STEPS, success_fn=record, device=dev,
                      device_steps=CHUNK_STEPS)
    n1, n2 = read_counts()
    a, b = states[DETERMINISM_STEPS - 1], states[2 * DETERMINISM_STEPS - 1]
    diff = {f: (getattr(a, f).double() - getattr(b, f).double()).abs().max().item()
            for f in SIM_STATE_FIELDS if getattr(a, f) is not None}
    same = all(torch.equal(getattr(a, f), getattr(b, f)) for f in diff)
    print(f"    pick seed 0 twice on one build: world states after {DETERMINISM_STEPS} steps "
          f"identical {same} (max |d| {max(diff.values()):.3e}); launches K1 {n1}, K2 {n2}; "
          f"phase 17c {time.perf_counter() - t0:.1f} s", flush=True)
    if not same:
        fail("seed 0 twice on one build gave different world states")
    if n1 != 2 * DETERMINISM_STEPS or n2 != 2 * DETERMINISM_STEPS:
        fail("launch counters do not match the commands and world steps run")


CHUNK_STEPS = 16           # control steps per host round trip (run_task_episodes' default)
CHUNK_EQUAL_STEPS = 32
TRACE_STEPS = 32
# phase 17d's loops: (the earlier phase of the same loop per step, its step cap)
CHUNK_LOOPS = {"panda": (3, None), "boxer_push": (7, None), "albert": (14, 500),
               "multi_jackal": (13, 400), "anymal": (15, ANYMAL_STEPS),
               "panda_pick": (5, PICK_MAX_STEPS)}


def chunk_setup(key):
    """(cfg, objective, success test, prior) of a phase-17d loop at its
    shipped config."""
    from mppiisaac_tpu_torch.tasks import (albert, anymal, mobile_push, multi_robot, panda_pick,
                                           panda_reach)
    from mppiisaac_tpu_torch.utils.config_store import load_config

    cfg = load_config(f"tasks/{key}")
    if key == "panda":
        return cfg, panda_reach.PandaReachObjective(cfg), panda_reach.success_fn(), None
    if key == "boxer_push":
        obj = mobile_push.MobilePushObjective(cfg, "boxer", mobile_push.EE_LINK["boxer"])
        return cfg, obj, mobile_push.success_fn(obj.goal), None
    if key == "albert":
        return cfg, albert.AlbertObjective(cfg), albert.success_fn(), None
    if key == "multi_jackal":
        obj = multi_robot.MultiJackalObjective(cfg)
        return cfg, obj, multi_robot.success_fn(key, obj), None
    if key == "anymal":
        return cfg, anymal.AnymalObjective(cfg), anymal.success_fn(), anymal.gait_prior(cfg)
    return cfg, panda_pick.PandaPickObjective(cfg), panda_pick.success_fn(), None


def chunk_equality(dev):
    """Phase 17d (1): pick at its shipped config, seed 0, CHUNK_EQUAL_STEPS
    steps on one build, at device_steps=CHUNK_STEPS and at 1: the world
    states and actions step by step, bit for bit."""
    from mppiisaac_tpu_torch.mppi import prng
    from mppiisaac_tpu_torch.physics.types import SIM_STATE_FIELDS
    from mppiisaac_tpu_torch.planner.mppi_isaac import MPPIisaacPlanner
    from mppiisaac_tpu_torch.runtime.loop import DeviceChunk, _run_chunked, goal_world, run_steps

    cfg, obj, _, _ = chunk_setup("panda_pick")
    world = goal_world(cfg, dev)
    planner = MPPIisaacPlanner(cfg, obj, device=dev)
    initial = world.state
    carry0 = dataclasses.replace(planner.mppi.init_carry(), key=prng.prng_key(0))
    runs = {}
    for n in (1, CHUNK_STEPS):
        states, acts = [], []

        def record(w, states=states):
            states.append(w.state.map(lambda x: x.detach().cpu().clone()))
            return False

        world.state, planner.mppi.carry = initial, carry0
        reset_counts()
        if n == 1:
            m = run_steps(world, planner.compute_action_from_state, CHUNK_EQUAL_STEPS,
                          cfg.isaacgym.dt, success_fn=record,
                          observer=lambda s, w, a: acts.append(a.detach().cpu().clone()))
        else:
            chunk = DeviceChunk(world, planner, n)
            m = _run_chunked(chunk, CHUNK_EQUAL_STEPS, cfg.isaacgym.dt, success_fn=record,
                             chunk_observer=lambda s, w, a: acts.append(torch.from_numpy(a)))
        runs[n] = (states, acts, read_counts(), m)
    (s1, a1, c1, m1), (sn, an, cn, mn) = runs[1], runs[CHUNK_STEPS]
    diff = {f: max(float((getattr(a, f).double() - getattr(b, f).double()).abs().max())
                   for a, b in zip(s1, sn))
            for f in SIM_STATE_FIELDS if getattr(s1[0], f) is not None}
    diff["action"] = max(float((a - b).abs().max()) for a, b in zip(a1, an))
    same = (len(s1) == len(sn) == CHUNK_EQUAL_STEPS and len(a1) == len(an)
            and all(torch.equal(getattr(a, f), getattr(b, f)) for a, b in zip(s1, sn)
                    for f in SIM_STATE_FIELDS if getattr(a, f) is not None)
            and all(torch.equal(a, b) for a, b in zip(a1, an)))
    print(f"[17d] pick K={cfg.mppi.num_samples} H={cfg.mppi.horizon}, seed 0, {CHUNK_EQUAL_STEPS} "
          f"steps on one build, device_steps={CHUNK_STEPS} against 1: bit for bit {same}; largest "
          f"|d| per field " + ", ".join(f"{k} {v:.3e}" for k, v in diff.items())
          + f"; launches K1/K2 {c1} per step, {cn} chunked; graph nodes per control step "
          f"{mn.graph_nodes}", flush=True)
    if not same:
        fail("the chunked pick differs from the per-step pick")
    if c1 != (CHUNK_EQUAL_STEPS,) * 2 or cn != (CHUNK_EQUAL_STEPS,) * 2:
        fail("launch counters do not match the commands and world steps run")
    if mn.graph_nodes is None:
        fail("the chunked loop did not capture a CUDA graph")


def chunk_loops(dev):
    """Phase 17d (2): the six loops through `run_task(device_steps=CHUNK_STEPS)`,
    each to the goal or the step count of its earlier phase, with the launch
    counters and anymal's tape injections through the replays: each must
    end at the success step of the same loop per step in its earlier phase
    (the same build and seed, the same kernels on the same inputs); the
    median control step beside the per-step loop's."""
    from mppiisaac_tpu_torch.mppi.solver import MPPIPlanner
    from mppiisaac_tpu_torch.runtime.loop import run_task

    for key, (phase, cap) in CHUNK_LOOPS.items():
        t1 = time.perf_counter()
        cfg, obj, succ, prior = chunk_setup(key)
        reset_counts()
        MPPIPlanner.tape_injections = 0
        m = run_task(cfg, obj, prior=prior, n_steps=cap, success_fn=succ, device=dev,
                     device_steps=CHUNK_STEPS)
        n1, n2 = read_counts()
        tapes = MPPIPlanner.tape_injections
        ms = 1e3 / float(np.median(m.fps))
        per, per_success = PER_STEP[key]
        print(f"[17d] run_task {key} device_steps={CHUNK_STEPS}: success_step {m.success_step} "
              f"(per step, phase {phase}: {per_success}), "
              f"{m.steps} steps ({m.commands} run), median control step {ms:.3f} ms chunked vs "
              f"{per:.3f} ms per step (phase {phase}), {per / ms:.2f}x; launches K1 {n1}, K2 {n2}"
              + (f", tapes {tapes}" if prior is not None else "")
              + f"; graph nodes per step {m.graph_nodes}; finite {m.final_state_finite}; "
              f"{time.perf_counter() - t1:.1f} s", flush=True)
        if not m.final_state_finite:
            fail("non-finite world state")
        if n1 != m.commands or n2 != m.commands or n1 == 0:
            fail("launch counters do not match the commands and world steps run")
        if prior is not None and tapes != m.commands:
            fail(f"{key}: the prior's tape went into {tapes} of {m.commands} commands")
        if m.graph_nodes is None:
            fail("the chunked loop did not capture a CUDA graph")
        if m.success_step != per_success:
            fail(f"{key}: the chunked loop ended at step {m.success_step}, the per-step loop at "
                 f"{per_success}")
        if key == "multi_jackal":
            # the conf seed reaches no goal, so the rate's episodes are what
            # the chunk must reproduce: each seed's success step of phase 13
            ok = jackal_episodes(cfg, obj, succ, dev, cap, device_steps=CHUNK_STEPS)
            if ok != JACKAL_PER_STEP:
                fail(f"multi_jackal: the chunked episodes end at {ok}, the per-step ones at "
                     f"{JACKAL_PER_STEP}")


def idle_shares(dev, root):
    """Phase 17d (3): the device's idle share over TRACE_STEPS steady control
    steps of panda and pick, per step and chunked (torch.profiler; Chrome
    traces in profile_out/: tens of MB each, kept out of chiprun_out/)."""
    from mppiisaac_tpu_torch.planner.mppi_isaac import MPPIisaacPlanner
    from mppiisaac_tpu_torch.runtime.loop import DeviceChunk, _run_chunked, goal_world, run_steps
    from mppiisaac_tpu_torch.utils.profiling import trace

    out = os.path.join(root, "profile_out")
    for key in ("panda", "panda_pick"):
        cfg, obj, _, _ = chunk_setup(key)
        world = goal_world(cfg, dev)
        planner = MPPIisaacPlanner(cfg, obj, device=dev)
        dt = cfg.isaacgym.dt
        run_steps(world, planner.compute_action_from_state, 3, dt)
        with trace(out, f"trace_{key}_per_step.json") as t1:
            run_steps(world, planner.compute_action_from_state, TRACE_STEPS, dt)
        chunk = DeviceChunk(world, planner, CHUNK_STEPS)
        _run_chunked(chunk, CHUNK_STEPS, dt)
        with trace(out, f"trace_{key}_chunked.json") as t2:
            _run_chunked(chunk, TRACE_STEPS, dt)
        n1 = sum(c for c, _ in t1.kernels.values()) / TRACE_STEPS
        n2 = sum(c for c, _ in t2.kernels.values()) / TRACE_STEPS
        # the graph alone: CHUNK_STEPS replays back to back between two CUDA
        # events (the step slot rewound first, as `run` does), against the
        # device's busy time per step: the gaps between the graph's nodes
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        chunk._slot.zero_()
        start.record()
        for _ in range(CHUNK_STEPS):
            chunk._graph.replay()
        end.record()
        torch.cuda.synchronize()
        graph_ms = start.elapsed_time(end) / CHUNK_STEPS
        print(f"[17d] {key} traced over {TRACE_STEPS} steps: per step {t1.window_s * 1e3 / TRACE_STEPS:.3f} "
              f"ms/step, device busy {t1.device_busy_s * 1e3 / TRACE_STEPS:.3f} ms/step, idle "
              f"share {t1.idle_share}, {n1:.1f} device events/step; chunked "
              f"{t2.window_s * 1e3 / TRACE_STEPS:.3f} ms/step, busy "
              f"{t2.device_busy_s * 1e3 / TRACE_STEPS:.3f} ms/step, idle share {t2.idle_share}, "
              f"{n2:.1f} device events/step; the graph alone, replayed back to back: "
              f"{graph_ms:.3f} ms/step", flush=True)
        if t2.idle_share is None:
            fail("the chunked trace shows no device time")


def chunked_paths(dev, root):
    """Phase 17d: the chunked loop (one captured control step, replayed)."""
    t0 = time.perf_counter()
    chunk_equality(dev)
    chunk_loops(dev)
    idle_shares(dev, root)
    print(f"    phase 17d {time.perf_counter() - t0:.1f} s", flush=True)


# phase 17e: the batched world (the balls demo's scene, then a randomized
# point-robot batch), each step of every env in one K2 launch
BALLS_ENVS, BALLS_BALLS, BALLS_STEPS = 1080, 4, 100
BALLS_SETTLE = 20            # steps before the hold: two balls landed, two falling
POINT_BATCH_ENVS = 256
BATCH_HOLD_STEPS = 3
BATCH_PLAIN_ENVS = 16        # the plain version's slice of the batch (envs are independent)


def _groups(ks, d):
    """max |d| of (rows, N) differences by row group (pose, vel, lam)."""
    A, D, NS = ks.nactor, ks.ndof, ks.n_state_rows
    root = d[: 13 * A].reshape(A, 13, -1)
    q = d[13 * A: 13 * A + D].max().item() if D else 0.0
    return dict(pose=max(root[:, :7].max().item(), q),
                vel=max(root[:, 7:].max().item(), d[13 * A + D: NS].max().item()),
                lam=d[NS:].max().item() if ks.n_fc else 0.0)


def hold_batch(name, sim, n):
    """K2 over all of `sim`'s envs for n steps from its state (one launch a
    step), each step's envs 0, N/2 and N−1 bit for bit against the one-env
    launch on their inputs, and the batch against the plain version on a
    slice of BATCH_PLAIN_ENVS envs, within 10× that slice's own
    float32-vs-float64 drift over the same steps (floor 1e-6) by row
    group; the λ rows must carry an impulse. Each launch writes its body
    rows, the three envs' bit for bit their one-env launches', and the last
    step's are held against engine.refresh (hold_bodies). → (the largest
    group's |d|, the kernel's inputs of the first step)."""
    from mppiisaac_tpu_torch.ops.fused_rollout import world_step_plain

    fw = sim._world_step
    ks = fw.ks
    rows = fw.pack(sim.state).contiguous()
    k2_in = (rows, sim.state.dof_target.T.contiguous(),
             sim.params.body_mass_scale.T.contiguous(), sim.params.geom_friction.T.contiguous())
    _, tgt, mass, fric = k2_in
    N = rows.shape[1]
    idx = torch.arange(0, N, max(1, N // BATCH_PLAIN_ENVS), device=rows.device)[:BATCH_PLAIN_ENVS]
    plain_in = {dt: [x[:, idx].to(dt) for x in k2_in] for dt in (torch.float32, torch.float64)}
    rp = {dt: v[0] for dt, v in plain_in.items()}
    body = torch.empty(13 * ks.nbody, N, device=rows.device)
    body1 = torch.empty(13 * ks.nbody, device=rows.device)
    for _ in range(n):
        out = fw.step_rows(rows, tgt, mass, fric, body=body)
        for e in (0, N // 2, N - 1):
            one = fw.step_rows(rows[:, e].contiguous(), tgt[:, e].contiguous(),
                               mass[:, e].contiguous(), fric[:, e].contiguous(), body=body1)
            if not (torch.equal(one, out[:, e]) and torch.equal(body1, body[:, e])):
                fail(f"{name}: env {e} of the batched K2 differs from its one-env launch")
        rows = out
        for dt, (_, t, m, f) in plain_in.items():
            rp[dt] = world_step_plain(ks, rp[dt], t.T, m.T, f.T, fw.substeps, fw.dt_sub,
                                      fw.impulse_sweeps)
    torch.cuda.synchronize()
    err = _groups(ks, (rows[:, idx].double() - rp[torch.float32].double()).abs())
    drift = _groups(ks, (rp[torch.float32].double() - rp[torch.float64]).abs())
    bound = {k: max(10 * v, 1e-6) for k, v in drift.items()}
    print(f"  {name}: envs 0, {N // 2}, {N - 1} bit-equal to their one-env launches over {n} "
          f"steps; envs {idx[0].item()}..{idx[-1].item()} (every {N // len(idx)}th) against the "
          f"plain batch: max|d| " + ", ".join(
              f"{k} {e:.3e} (bound {bound[k]:.3g}: 10x drift {drift[k]:.3g})"
              for k, e in err.items()), flush=True)
    if not bool(torch.isfinite(rows).all()) or any(e > bound[k] for k, e in err.items()):
        fail(f"{name}: the batched K2 disagrees with its plain version")
    if ks.n_fc and float(rp[torch.float32][ks.n_state_rows:].abs().max()) == 0.0:
        fail(f"{name}: no λ row carried a contact impulse")
    hold_bodies(name, fw.engine, fw.unpack(sim.state, rows, body))
    return max(err.values()), k2_in


def batched_paths(dev):
    """Phase 17e: the demo at BALLS_ENVS envs through the batched
    `Simulation.step` (launches counted, envs identical, exact restore);
    then the batched K2 held from the balls after BALLS_SETTLE steps with
    each env's x velocities drawn apart, and from a randomized point-robot
    batch pushing its block. → the timed batch (phase 18)."""
    from mppiisaac_tpu_torch.examples import balls_demo
    from mppiisaac_tpu_torch.runtime.sim import Simulation
    from mppiisaac_tpu_torch.scene.builder import SimConfig

    t0 = time.perf_counter()
    reset_counts()
    demo = balls_demo.main(BALLS_ENVS, BALLS_BALLS, BALLS_STEPS, device=dev)
    n1, n2 = read_counts()
    print(f"[17e] balls demo: {BALLS_ENVS} envs x {BALLS_STEPS} steps, launches K1 {n1} K2 {n2}; "
          f"{demo['ms_per_step']:.3f} ms per step, {demo['env_steps_per_s']:.0f} env-steps/s",
          flush=True)
    if not (demo["identical"] and demo["exact"]):
        fail("balls demo: envs differ or the restore is not exact")
    if (n1, n2) != (0, BALLS_STEPS + 1):
        fail(f"balls demo: expected K2 once per step ({BALLS_STEPS} and the warm-up step), got "
             f"K1 {n1} K2 {n2}")
    sim = balls_demo.balls_sim(BALLS_ENVS, BALLS_BALLS, dev)
    for _ in range(BALLS_SETTLE):
        sim.step()
    vx = np.random.RandomState(SEED).uniform(-0.5, 0.5, (BALLS_ENVS, BALLS_BALLS))
    rl = sim.state.root_linvel.clone()
    rl[..., 0] = torch.as_tensor(vx, dtype=torch.float32, device=dev)
    sim._set(sim.state.replace(root_linvel=rl))
    err, k2_in = hold_batch(f"balls N={BALLS_ENVS}", sim, BATCH_HOLD_STEPS)
    psim = Simulation(SimConfig(dt=0.05, substeps=1), ["point_robot", "block", "goal"],
                      num_envs=POINT_BATCH_ENVS, randomize=True, seed=3, device=dev)
    psim.set_actor_position_by_name("block", [0.45, 0.0, 0.1])      # in front of the robot
    u = np.random.RandomState(SEED).uniform(-1, 1, (POINT_BATCH_ENVS, 3)).astype(np.float32)
    u[:, 0] = 1.0                                                    # pushing along +x
    psim.apply_robot_cmd(u)
    hold_batch(f"point_robot + block N={POINT_BATCH_ENVS}, randomized", psim, BATCH_HOLD_STEPS)
    print(f"    phase 17e {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(fw=sim._world_step, k2_in=k2_in, n2=n2, err=err, demo=demo)


BENCH_PLAIN_SAMPLES = 32     # phase 17f: the plain K1 at H=30 on this many samples
# 17f's bounds: 10× that plain K1's own float32-vs-float64 drift on its
# inputs in each measure, the smaller of the CPU's
# (`scripts/profile_torch_step.py --task bench --drift -`) and the card's
# (as this phase computed it at run time before; NVIDIA H100 80GB HBM3, 700 W)
BENCH_BOUNDS = dict(max=6.69, first=1.37e-4, median=0.236)


MEASURES = {"max": lambda x: x.max(), "first": lambda x: x[:, 0].max(),
            "median": lambda x: x.max(1).values.median()}


def drift_bounds(dd):
    """10× a plain version's own float32-vs-float64 drift dd (samples,
    steps) in each measure of three_measures (floor 1e-6)."""
    return {k: max(10 * f(dd).item(), 1e-6) for k, f in MEASURES.items()}


def three_measures(d, bounds):
    """A (samples, steps) difference d held as the paths are: its largest,
    the first step's, and the median over samples of each sample's largest,
    each within its bound (10× the plain version's own float32-vs-float64
    drift in the same measure, floor 1e-6: drift_bounds, or those of a
    table). → (errs, all within, printed line)."""
    errs = {k: f(d).item() for k, f in MEASURES.items()}
    line = ", ".join(f"{k} {errs[k]:.3e} (bound {bounds[k]:.3g}: 10x drift {bounds[k] / 10:.3g})"
                     for k in errs)
    return errs, all(errs[k] <= bounds[k] for k in errs), line


def bench_path(dev, pool):
    """Phase 17f: the bench twin (`python -m mppiisaac_tpu_torch.bench`, its
    defaults: pick K=1000, H=30) with its K1 launches counted (warm-up batch
    and command, ITERS batches of CHUNK, the latency calls), then K1 on a
    command's inputs of its rollout (the initial state, V drawn as the
    solver draws it), whose plain version on the first BENCH_PLAIN_SAMPLES
    samples goes to the host CPU's workers (bench_hold holds them). → the
    timed path (phase 18)."""
    from mppiisaac_tpu_torch import bench
    from mppiisaac_tpu_torch.ops.fused_rollout import rollout_plain

    t0 = time.perf_counter()
    reset_counts()
    rec = bench.main()
    n1, n2 = read_counts()
    expect = (bench.CHUNK + 1) + bench.ITERS * bench.CHUNK + bench.LATENCY_CALLS
    print(f"[17f] bench twin: {rec['value']:.0f} env-steps/s, {rec['per_command_ms']:.3f} ms per "
          f"command, latency {rec['latency_ms']:.3f} ms; launches K1 {n1} (expected {expect}), "
          f"K2 {n2}", flush=True)
    if (n1, n2) != (expect, 0):
        fail(f"bench twin: expected {expect} K1 launches and no K2, got {n1} and {n2}")
    planner = rec["planner"]
    mppi, fr = planner.mppi, planner.mppi.fused
    _, d = mppi.draws(mppi.carry.key, 1)
    eps = mppi.noise(torch.as_tensor(d[0], device=dev), mppi.carry.sigma)
    V = torch.clamp(mppi.carry.U[None] + eps, mppi._u_min, mppi._u_max) * mppi.cfg.u_scale
    k1_in = fr.pack(planner.sim.state, planner._params_K, V)
    costs, vis = fr.run(*k1_in)
    n = BENCH_PLAIN_SAMPLES
    part = [x[..., :n].contiguous().cpu() for x in k1_in]
    plain = pool.submit(timed_plain, rollout_plain, fr.ks, part[0], part[1].float(), part[2],
                        part[3], fr.H, fr.substeps, fr.dt_sub, fr.vis_body, fr.impulse_sweeps,
                        fr.world_fidelity)
    print(f"    its plain K1 on {n} samples goes to the host CPU; phase 17f "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return dict(fr=fr, k1_in=k1_in, n1=n1, rec=rec, costs=costs[:n].cpu(), vis=vis[:, :n].cpu(),
                plain=plain)


def bench_hold(run):
    """17f's hold, once the host CPU's plain version is back: the bench's
    K1 costs against it by the largest difference, the first step's and the
    median over samples, within BENCH_BOUNDS; vis within VIS_ATOL."""
    t0 = time.perf_counter()
    (cp, vp), ms = run["plain"].result()
    fr, n = run["fr"], BENCH_PLAIN_SAMPLES
    errs, held, line = three_measures((run["costs"].double() - cp.double()).abs(), BENCH_BOUNDS)
    print(f"  bench K1 (K={fr.K}, H={fr.H}) costs of the first {n} samples against the plain "
          f"version: {line}; the plain K1 on {n} samples {ms / 1e3:.1f} s on the host CPU "
          f"(waited {time.perf_counter() - t0:.1f} s for it)", flush=True)
    if not bool(torch.isfinite(run["costs"]).all()) or not held:
        fail("bench twin: K1 disagrees with its plain version")
    within("bench vis", run["vis"], vp, VIS_ATOL, 0.0)
    run.update(err=errs["max"], errs=errs, plain_ms=ms)


# ---------------------------------------------------------------------------
# phase 19: the unfused rollout (the engine's Engine.step, compute_cost, the
# closed-loop priors), the engine world (fused_world=False) and K-sharding
# ---------------------------------------------------------------------------

UNFUSED_CHUNK = 16          # device_steps of the chunked unfused loops
ENGINE_WORLD_STEPS = 20     # 19d: the engine world on the card against the CPU
BALLS_ENGINE_STEPS = 10     # 19d: timed engine steps of the balls scene
NAV_HOLD_STEP, NAV_HOLD_STEPS = 8, 5   # 19c: K2's hold state (a step of the loop), its steps
SHARD_RANKS, SHARD_REPS = 2, 5
# 19b: sample K−2 replayed alone against its place in the K-batch: the
# batched products may sum in another order on the card
PRIOR_REPLAY_ATOL = 1e-4
_VIEW_OPS = {"view", "_unsafe_view", "expand", "slice", "select", "unsqueeze", "squeeze", "t",
             "transpose", "permute", "as_strided", "alias", "detach", "unbind", "split",
             "split_with_sizes", "diagonal", "_reshape_alias", "reshape", "lift_fresh"}


def aten_ops(fn):
    """(the aten operations fn dispatches that are not views — each launches
    at most one kernel on the card —, fn's result)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    n = [0]

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__ not in _VIEW_OPS:
                n[0] += 1
            return func(*args, **(kwargs or {}))

    with Mode():
        out = fn()
    torch.cuda.synchronize()
    return n[0], out


def first_command(cfg, obj, dev, prior=None):
    """One unfused command from the task's initial world state with the
    first draw of the conf's seed: → (action, costs, info, planner)."""
    from mppiisaac_tpu_torch.planner.mppi_isaac import MPPIisaacPlanner
    from mppiisaac_tpu_torch.runtime.loop import goal_world

    world = goal_world(cfg, dev)
    p = MPPIisaacPlanner(cfg, obj, prior, device=dev, use_fused=False)
    p.reset_rollout_from_state(world.state)
    _, d = p.mppi.draws(p.mppi.carry.key, 1)
    draw = torch.as_tensor(d[0], device=dev)
    st = (p.sim.state, p._params_K)
    a, _, info = p.mppi._command_impl(p.mppi.carry, st, draw=draw)
    return a, info["costs"], info, p, st, draw


def unfused_loop(label, cfg, obj, dev, prior=None, **kw):
    """run_task with the unfused rollout, launch counters set to 0 just
    before it: K1 never launches, K2 once per world step. → (metrics, K2)."""
    from mppiisaac_tpu_torch.runtime.loop import run_task

    reset_counts()
    t0 = time.perf_counter()
    m = run_task(cfg, obj, prior=prior, device=dev, use_fused=False if prior is None else None,
                 **kw)
    n1, n2 = read_counts()
    nodes = m.graph_nodes
    print(f"{label}: success_step {m.success_step}, {m.steps} steps ({m.commands} run), median "
          f"control step {1e3 / float(np.median(m.fps)):.3f} ms, finite {m.final_state_finite}; "
          f"launches K1 {n1}, K2 {n2}" + (f"; graph nodes per step {nodes}" if nodes else "")
          + f"; {time.perf_counter() - t0:.1f} s", flush=True)
    if not m.final_state_finite:
        fail(f"{label}: non-finite world state")
    if n1 != 0 or n2 != m.commands or n2 == 0:
        fail(f"{label}: expected no K1 and K2 once per world step, got K1 {n1} K2 {n2} for "
             f"{m.commands} steps")
    return m, n2


def unfused_reach(dev):
    """19a: panda reach with use_fused=False: the first command on the card
    against the CPU's (bounds: 10× the CPU's own float32-vs-float64 drift of
    that command), then the loop to its goal per step and chunked."""
    from mppiisaac_tpu_torch.tasks.panda_reach import PandaReachObjective, success_fn
    from mppiisaac_tpu_torch.utils.config_store import load_config

    t0 = time.perf_counter()
    cfg = load_config("tasks/panda")
    obj = PandaReachObjective(cfg)
    a_g, c_g, _, pg, _, _ = first_command(cfg, obj, dev)
    a_c, c_c, _, pc, st, draw = first_command(cfg, obj, "cpu")
    # the same command with its rollout in float64 (the update in float32)
    st64 = tuple(x.map(torch.Tensor.double) for x in st)
    rollout = pc.mppi._rollout

    def rollout64(state0, V, use_prior):
        return tuple(x.float() for x in rollout(st64, V.double(), use_prior))

    pc.mppi._rollout = rollout64
    a64, _, i64 = pc.mppi._command_impl(pc.mppi.carry, st, draw=draw)
    del pc.mppi._rollout
    drift_c = (c_c.double() - i64["costs"].double()).abs().max().item()
    drift_a = (a_c.double() - a64.double()).abs().max().item()
    print(f"[19a] panda reach unfused, first command K={cfg.mppi.num_samples} "
          f"H={cfg.mppi.horizon}, {pg.sim.engine.substeps} substeps: CPU float32 vs float64 "
          f"drift: costs {drift_c:.3e}, action {drift_a:.3e}", flush=True)
    within("[19a] first command costs, card vs CPU", c_g.cpu(), c_c, max(10 * drift_c, 1e-5), 0.0)
    within("[19a] first action, card vs CPU", a_g.cpu(), a_c, max(10 * drift_a, 1e-6), 0.0)
    carry, state0 = pg.mppi.carry, (pg.sim.state, pg._params_K)
    ops_cmd, _ = aten_ops(lambda: pg.mppi._command_impl(carry, state0))
    succ = success_fn()
    m1, n2a = unfused_loop("[19a] panda reach unfused, per step", cfg, obj, dev, n_steps=cfg.n_steps,
                           success_fn=succ)
    m2, n2b = unfused_loop(f"[19a] panda reach unfused, device_steps={UNFUSED_CHUNK}", cfg, obj,
                           dev, n_steps=cfg.n_steps, success_fn=succ, device_steps=UNFUSED_CHUNK)
    for m in (m1, m2):
        if m.success_step is None:
            fail("[19a] panda reach with the unfused rollout did not reach its goal")
    per, chunk = 1e3 / float(np.median(m1.fps)), 1e3 / float(np.median(m2.fps))
    print(f"[19a] median control step {per:.3f} ms per step, {chunk:.3f} ms chunked; "
          f"{ops_cmd} aten ops per command (eager, on the card), graph nodes per control step "
          f"{m2.graph_nodes}; success steps {m1.success_step} / {m2.success_step}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return dict(n2=n2a + n2b, per_ms=per, chunk_ms=chunk, ops=ops_cmd, nodes=m2.graph_nodes,
                success=(m1.success_step, m2.success_step))


def arm_prior_reach(dev):
    """19b: the reach loop with ArmJacobianPrior and use_priors: sample
    K−2's applied controls against the prior's clipped commands along its
    own rollout (the first command, the sample replayed alone), then the
    loop chunked (its success step printed, not held)."""
    from mppiisaac_tpu_torch.planner.priors import ArmJacobianPrior
    from mppiisaac_tpu_torch.runtime.sim import Simulation
    from mppiisaac_tpu_torch.tasks.panda_reach import PandaReachObjective, success_fn
    from mppiisaac_tpu_torch.utils.config_store import load_config

    t0 = time.perf_counter()
    cfg = load_config("tasks/panda", ["mppi.use_priors=true"])
    obj = PandaReachObjective(cfg)
    built = Simulation(cfg.isaacgym, cfg.actors, cfg.initial_actor_positions, device=dev).built
    prior = ArmJacobianPrior(built, ee_link="panda_ee_tip")
    a, _, info, p, (st, pr), _ = first_command(cfg, obj, dev, prior)
    K, H = cfg.mppi.num_samples, cfg.mppi.horizon
    applied = info["applied"][K - 2]
    mp = p.mppi
    s1 = (st.map(lambda x: x[K - 2: K - 1].contiguous()), pr.map(lambda x: x[K - 2: K - 1]))
    worst = 0.0
    for t in range(H):
        pu = torch.clamp(mp.prior(s1, t), mp._u_min, mp._u_max)[0]
        worst = max(worst, (pu - applied[t]).abs().max().item())
        s1 = mp.dynamics(s1, applied[t][None] * cfg.mppi.u_scale, t)
    print(f"[19b] sample K-2 applies the prior's clipped commands along its rollout: max |d| "
          f"{worst:.3e} over {H} steps (atol {PRIOR_REPLAY_ATOL:g}); |u| up to "
          f"{applied.abs().max().item():.3f}", flush=True)
    if not worst <= PRIOR_REPLAY_ATOL or not torch.isfinite(info["costs"]).all():
        fail("[19b] sample K-2 does not follow the closed-loop prior")
    m, n2 = unfused_loop(f"[19b] panda reach + ArmJacobianPrior, device_steps={UNFUSED_CHUNK}",
                         cfg, obj, dev, prior=prior, n_steps=cfg.n_steps, success_fn=success_fn(),
                         device_steps=UNFUSED_CHUNK)
    print(f"[19b] success step {m.success_step} (a sample, not a bar); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return dict(n2=n2, success=m.success_step, ms=1e3 / float(np.median(m.fps)))


def point_prior_cfg(fused_world=None):
    from mppiisaac_tpu_torch.tasks.point_robot import PointRobotObjective
    from mppiisaac_tpu_torch.utils.config_store import load_config

    cfg = load_config("tasks/point_robot", ["mppi.use_priors=true"])
    cfg.actors = ["point_robot", "goal"]
    if fused_world is not None:
        cfg.isaacgym.fused_world = fused_world
    return cfg, PointRobotObjective(cfg)


def point_prior_loop(dev):
    """19c: point_robot with a goal actor and PointNavigationPrior to its
    goal (chunked); then K2 from the loop's state after NAV_HOLD_STEP steps
    (the robot moving, its dof_target nonzero) over NAV_HOLD_STEPS steps
    against its plain version (hold_batch: within 10× the plain version's
    own float32-vs-float64 drift there, printed beside each bound), and
    timed on those inputs for phase 19's kernel entry."""
    from mppiisaac_tpu_torch.planner.priors import PointNavigationPrior
    from mppiisaac_tpu_torch.runtime.loop import goal_world
    from mppiisaac_tpu_torch.tasks.point_robot import success_fn

    t0 = time.perf_counter()
    cfg, obj = point_prior_cfg()
    seen = {}

    def keep(step, w, a):
        if step == NAV_HOLD_STEP:
            seen["state"] = w.state.map(lambda x: x.clone())

    m, n2 = unfused_loop(f"[19c] point_robot + PointNavigationPrior K={cfg.mppi.num_samples} "
                         f"H={cfg.mppi.horizon}, device_steps={UNFUSED_CHUNK}", cfg, obj, dev,
                         prior=PointNavigationPrior(), success_fn=success_fn(obj.nav_goal),
                         device_steps=UNFUSED_CHUNK, chunk_observer=keep)
    if m.success_step is None:
        fail("[19c] point_robot with PointNavigationPrior did not reach its goal")
    if "state" not in seen:
        fail(f"[19c] the loop ended before step {NAV_HOLD_STEP}, K2's hold state")
    world = goal_world(cfg, dev)
    world.state = seen["state"].map(lambda x: x.to(dev))
    speed = world.state.qd.abs().max().item()
    target = world.state.dof_target.abs().max().item()
    print(f"[19c] K2's hold state: step {NAV_HOLD_STEP} of the loop, |qd| up to {speed:.3e}, "
          f"|dof_target| up to {target:.3e}", flush=True)
    if not (speed > 1e-3 and target > 1e-3):
        fail("[19c] K2's hold state is at rest: a kernel that left it unchanged would pass")
    err, _ = hold_batch(f"[19c] K2 from step {NAV_HOLD_STEP}", world, NAV_HOLD_STEPS)
    fw = world._world_step
    s0 = world.state.map(lambda x: x[0])
    k2_in = (fw.pack(s0).contiguous(), s0.dof_target.contiguous(),
             torch.ones(world.scene.nbody, device=dev), torch.ones(world.scene.ngeom, device=dev))
    ms = cuda_time_ms(lambda: fw.step_rows(*k2_in))
    plain = cuda_time_ms(lambda: fw.plain(*k2_in), reps=3, warmup=1)
    b2 = k2_bound(fw, k2_in)
    print(f"[19c] success step {m.success_step}; its K2: {ms:.4f} ms vs plain {plain:.3f} ms, "
          f"max |d| {err:.3e} over {NAV_HOLD_STEPS} steps, bound {b2[0]:.6f} ms ({b2[1]}); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return dict(n2=n2, success=m.success_step, ms=ms, plain_ms=plain, err=err, bound=b2)


def engine_world(dev, demo):
    """19d: fused_world=False. The point_robot prior loop of 19c with its
    world on Engine.step for ENGINE_WORLD_STEPS steps, replayed on the CPU
    with the card's actions (bounds: 10× the CPU's own float32-vs-float64
    drift of the same replay, at least 1e-5); then the balls demo's scene
    at BALLS_ENVS envs stepped by Engine.step, beside K2's (phase 17e)."""
    from mppiisaac_tpu_torch.examples import balls_demo
    from mppiisaac_tpu_torch.physics.types import SIM_STATE_FIELDS
    from mppiisaac_tpu_torch.planner.priors import PointNavigationPrior
    from mppiisaac_tpu_torch.runtime.loop import goal_world, run_task
    from mppiisaac_tpu_torch.runtime.sim import Simulation
    from mppiisaac_tpu_torch.scene.builder import SimConfig

    t0 = time.perf_counter()
    cfg, obj = point_prior_cfg(fused_world=False)
    seen = []
    reset_counts()
    run_task(cfg, obj, prior=PointNavigationPrior(), n_steps=ENGINE_WORLD_STEPS, device=dev,
             observer=lambda step, w, a: seen.append(
                 (a.detach().cpu().clone(), w.state.map(lambda x: x.detach().cpu().clone()))))
    n1, n2 = read_counts()
    if (n1, n2) != (0, 0) or len(seen) != ENGINE_WORLD_STEPS:
        fail(f"[19d] the engine world launched a kernel (K1 {n1}, K2 {n2}) or ran {len(seen)} "
             f"steps")
    world = goal_world(cfg, "cpu")
    if world._world_step is not world.engine:
        fail("[19d] fused_world=False did not give the engine world")
    s32, s64 = world.state, world.state.map(torch.Tensor.double)
    p32, p64 = world.params, world.params.map(torch.Tensor.double)
    cmap, eng = world.built.cmd_map, world.engine
    worst = {}
    for a, card in seen:
        u = a.reshape(1, -1)
        s32 = eng.step(s32.replace(dof_target=cmap.apply(u, s32.q)), p32)
        s64 = eng.step(s64.replace(dof_target=cmap.apply(u.double(), s64.q)), p64)
        for f in SIM_STATE_FIELDS:
            c, x, y = getattr(card, f), getattr(s32, f), getattr(s64, f)
            d, drift = (c - x).abs().max().item(), (x.double() - y).abs().max().item()
            w = worst.setdefault(f, [0.0, 0.0])
            w[0], w[1] = max(w[0], d), max(w[1], drift)
    for f, (d, drift) in worst.items():
        bound = max(10 * drift, 1e-5)
        print(f"  [19d] engine world card vs CPU over {ENGINE_WORLD_STEPS} steps, {f}: max |d| "
              f"{d:.3e}, drift {drift:.3e}, bound {bound:.3e} {'ok' if d <= bound else 'MISS'}",
              flush=True)
        if not d <= bound:
            fail(f"[19d] the engine world on the card disagrees with the CPU in {f}")
    sim = Simulation(SimConfig(**balls_demo.BALLS_CONFIG, fused_world=False),
                     balls_demo.ball_actors(BALLS_BALLS), num_envs=BALLS_ENVS, device=dev)
    sim.step()
    torch.cuda.synchronize()
    with Timer() as t:
        for _ in range(BALLS_ENGINE_STEPS):
            sim.step()
    ms = t.ms / BALLS_ENGINE_STEPS
    if not all(torch.isfinite(x).all() for x in sim.state.tensors()):
        fail("[19d] the balls' engine world went non-finite")
    print(f"[19d] balls scene, {BALLS_ENVS} envs x {BALLS_BALLS} balls on Engine.step (eager): "
          f"{ms:.3f} ms per step, {BALLS_ENVS / ms * 1e3:.0f} env-steps/s; K2 (phase 17e): "
          f"{demo['ms_per_step']:.3f} ms per step, {demo['env_steps_per_s']:.0f} env-steps/s; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return dict(balls_ms=ms, balls_env_steps_per_s=BALLS_ENVS / ms * 1e3)


def sharded_pick(dev, root):
    """19e: panda_pick (K=1000, H=12) with fused_factory on SHARD_RANKS gloo
    ranks sharing the card (`python -m mppiisaac_tpu_torch.parallel.sharding`,
    one process per rank), beside the one-device command of the same carry
    and state; then K1 at the rank's K timed for phase 19's entry."""
    from mppiisaac_tpu_torch.parallel import sharding
    from mppiisaac_tpu_torch.planner.mppi_isaac import MPPIisaacPlanner
    from mppiisaac_tpu_torch.runtime.loop import goal_world
    from mppiisaac_tpu_torch.tasks.panda_pick import PandaPickObjective
    from mppiisaac_tpu_torch.utils.config_store import load_config

    t0 = time.perf_counter()
    out = os.path.join(root, "chiprun_out", "sharded_pick.json")
    rc = sharding.launch(SHARD_RANKS, ["task=panda_pick", "device=cuda", f"reps={SHARD_REPS}",
                                       f"out={out}"], timeout=400)
    if rc != 0:
        fail(f"[19e] the sharded command's ranks failed (rc {rc})")
    with open(out) as fh:
        r = json.load(fh)
    K, Kr = r["K"], r["K_rank"]
    print(f"[19e] panda_pick K={K} H={r['H']} on {r['ranks']} gloo ranks (one card): K1 over "
          f"{Kr} samples per rank, launches per rank {r['k1_launches_per_rank']} ({SHARD_REPS} "
          f"commands each), one-device K1 launches {r['k1_launches_one']}; per-sample costs "
          f"{'equal bit for bit' if r['costs_bit_equal'] else 'max |d| %.3e' % r['costs_max_abs_diff']}"
          f" (costs up to {r['costs_max_abs']:.3f}); action max rel |d| "
          f"{r['action_max_rel_diff']:.3e}; same action on every rank "
          f"{r['same_action_on_every_rank']}; command {r['ms_sharded']:.3f} ms sharded vs "
          f"{r['ms_one']:.3f} ms on one device (medians of {SHARD_REPS}); NCCL across cards is "
          f"not exercised (one card)", flush=True)
    if Kr != K // SHARD_RANKS or r["k1_launches_per_rank"] != [SHARD_REPS] * SHARD_RANKS:
        fail("[19e] each rank's K1 must run over K/ranks samples once per command")
    if not r["same_action_on_every_rank"] or not r["action_max_rel_diff"] <= 1e-5:
        fail("[19e] the sharded action disagrees with the one-device action")
    if not r["costs_max_abs_diff"] <= 1e-5 * max(r["costs_max_abs"], 1.0):
        fail("[19e] the sharded per-sample costs disagree with the one-device ones")
    # K1 at the rank's K (phase 19's entry), from the settled block (20
    # world steps holding the arm still, as phase 6) under controls uniform
    # in ±0.3·u_max
    from mppiisaac_tpu_torch.runtime.sim import broadcast_state

    cfg = load_config("tasks/panda_pick")
    world = goal_world(cfg, dev)
    p = MPPIisaacPlanner(cfg, PandaPickObjective(cfg), device=dev)
    for _ in range(20):
        world.apply_robot_cmd(np.zeros(p.mppi.nu, np.float32))
        world.step()
    fr, frp = p.fused_factory()(Kr), p.fused_factory()(PLAIN_K1_SAMPLES)
    g = torch.Generator().manual_seed(SEED)
    amp = 0.3 * torch.as_tensor(cfg.mppi.u_max, dtype=torch.float32)
    V = ((torch.rand((Kr, fr.H, fr.nu), generator=g) * 2.0 - 1.0) * amp).to(dev)
    k1_in = fr.pack(broadcast_state(world.state.map(lambda x: x[0]), Kr),
                    p._params_K.map(lambda x: x[:Kr]), V)
    ms = cuda_time_ms(lambda: fr.run(*k1_in))
    part = tuple(x[..., :PLAIN_K1_SAMPLES].contiguous() for x in k1_in)
    with Timer() as t:
        plain_costs = frp.plain(*part)[0]
    plain = t.ms
    err = (fr.run(*k1_in)[0][:PLAIN_K1_SAMPLES] - plain_costs).abs().max().item()
    if not err <= PICK_BOUNDS["settled block"]["k1_max"]:
        fail(f"[19e] K1 at K={Kr} disagrees with its plain version ({err:.3e})")
    b1 = k1_bound(fr, k1_in)
    print(f"[19e] K1 at K={Kr}: {ms:.3f} ms vs plain {plain:.3f} ms on {PLAIN_K1_SAMPLES} "
          f"samples, max |d| {err:.3e} (the settled-block bound 5e-4), bound {b1[0]:.6f} ms "
          f"({b1[1]}); {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(r=r, ms=ms, plain_ms=plain, err=err, bound=b1, K=Kr)


def phase19(dev, root, reach_entry, demo):
    """Phase 19 → its kernel entries: K2 under the unfused panda loops (19a,
    19b: the reach world's K2, timed in phase 18), K2 under the point_robot
    prior loop (19c), K1 on the sharded path (19e, per rank)."""
    t0 = time.perf_counter()
    a = unfused_reach(dev)
    b = arm_prior_reach(dev)
    c = point_prior_loop(dev)
    d = engine_world(dev, demo)
    e = sharded_pick(dev, root)
    src = "mppiisaac_tpu_torch/csrc/fused_rollout.cu"
    k2 = "mppiisaac_tpu/ops/pallas/fused_rollout.py:533"
    entries = [
        dict(reach_entry, path="panda_reach_unfused_loops", launches=a["n2"] + b["n2"],
             timed_on="panda_reach", unfused_ms_per_step=a["per_ms"],
             unfused_ms_chunked=a["chunk_ms"], unfused_aten_ops_per_command=a["ops"],
             unfused_graph_nodes_per_step=a["nodes"], arm_prior_success_step=b["success"],
             engine_balls_ms_per_step=d["balls_ms"],
             engine_balls_env_steps_per_s=d["balls_env_steps_per_s"]),
        {"name": "fused_world_step_kernel", "path": "point_robot_nav_prior", "route": "cuda",
         "source": src, "replaces": k2, "launches": c["n2"], "max_abs_err": c["err"],
         "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound"][0],
         "bound_by": c["bound"][1], "library_ms": None, "success_step": c["success"]},
        {"name": "fused_rollout_kernel", "path": f"panda_pick_sharded_{SHARD_RANKS}ranks_K{e['K']}",
         "route": "cuda", "source": src, "replaces": "mppiisaac_tpu/ops/pallas/fused_rollout.py:367",
         "launches": sum(e["r"]["k1_launches_per_rank"]), "max_abs_err": e["err"], "ms": e["ms"],
         "plain_ms": e["plain_ms"], "bound_ms": e["bound"][0], "bound_by": e["bound"][1],
         "library_ms": None, "plain_samples": PLAIN_K1_SAMPLES,
         "sharded_command_ms": e["r"]["ms_sharded"], "one_device_command_ms": e["r"]["ms_one"],
         "costs_bit_equal": e["r"]["costs_bit_equal"]},
    ]
    print(f"    phase 19: {time.perf_counter() - t0:.1f} s", flush=True)
    return entries


# ---------------------------------------------------------------------------
# phase 20: the kernels' profiling ablations (the ablation library) and the
# ablation profiler
# ---------------------------------------------------------------------------

ABLATE_K, ABLATE_H = 8, 12      # 20b: the holds' samples and steps at the held grasp
ABLATE_K2_STEPS = 5
# 20b's state: phase 6's held grasp (pick's success step at seed 0), as
# chip_smoke.py saves it to chiprun_out/panda_pick_states.pt on the card
HELD_GRASP = "tests/data/panda_pick_held_grasp.pt"
# 20b's bounds by mask: 10× each ablated plain version's own
# float32-vs-float64 drift at the held grasp in each measure (floor 1e-6),
# each the smaller of two measurements of it: on the CPU
# (`scripts/profile_torch_step.py --task ablations --drift -`) and on the
# card at the same state and inputs (the bounds this phase computed at run
# time before its plain versions moved to the host CPU; NVIDIA H100 80GB
# HBM3, 700 W)
ABLATE_BOUNDS = {
    4: dict(k1=dict(max=2.99e-4, first=1e-6, median=1.68e-6),           # nocost
            vis=dict(max=0.521, first=1.06e-5, median=2.4e-3)),
    1: dict(k1=dict(max=6.36e-3, first=1.14e-4, median=4.71e-3)),       # nocontact
    7: dict(k1=dict(max=1e-6, first=1e-6, median=1e-6),                 # fkonly
            vis=dict(max=1.97e-5, first=2.5e-6, median=1.39e-5)),
    8: dict(k1=dict(max=5.8, first=2.09e-4, median=0.033),              # oneway
            k2=dict(pose=2.48e-5, vel=2.83e-3, lam=1e-6)),
    16: dict(k1=dict(max=11.4, first=2.07e-4, median=0.0537),           # nogate
             k2=dict(pose=3.18e-4, vel=3.61e-2, lam=1.22e-6)),
}
ABLATED = {4: ("nocost", {"zero_cost": True}), 1: ("nocontact", {"skip_contacts": True}),
           7: ("fkonly", {"skip_contacts": True, "skip_dynamics": True, "zero_cost": True}),
           8: ("oneway", {"two_way_sweeps": False}), 16: ("nogate", {"broadphase_gate": False})}


def start_builds(variants):
    """nvcc for each library variant, all started now, each in a thread of
    its own. → {variant: thread}; join_build(thread) → (path, nvcc s, ptxas)."""
    import threading

    from mppiisaac_tpu_torch.ops import native

    out = {}
    for v in variants:
        res = {}

        def run(v=v, res=res):
            try:
                res["r"] = native.build(v)
            except Exception as e:  # noqa: BLE001 — re-raised by join_build
                res["e"] = e

        th = threading.Thread(target=run, daemon=True)
        th.res = res
        th.start()
        out[v] = th
    return out


def join_build(th):
    th.join()
    if "e" in th.res:
        fail(f"a kernel library did not build: {th.res['e']}")
    return th.res["r"]


def ablation_inputs():
    """20b's inputs, on the CPU, from the held grasp in HELD_GRASP: the
    default K1 inputs (ABLATE_K samples of controls uniform in ±0.3 at
    H=ABLATE_H), fkonly's (every root given a seeded velocity), K2's rows
    and its ABLATE_K2_STEPS targets (around the grasp's q, the fingers'
    targets kept). → dict."""
    from mppiisaac_tpu_torch.ops.fused_rollout import FusedRollout, FusedWorldStep
    from mppiisaac_tpu_torch.physics.types import ModelParams, SimState
    from mppiisaac_tpu_torch.runtime.sim import Simulation, broadcast_state
    from mppiisaac_tpu_torch.tasks.panda_pick import PandaPickObjective
    from mppiisaac_tpu_torch.utils.config_store import load_config

    held = SimState(**torch.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                              HELD_GRASP)))
    pcfg = load_config("tasks/panda_pick")
    world = Simulation(pcfg.isaacgym, pcfg.actors, pcfg.initial_actor_positions, device="cpu")
    pb, engine = world.built, world.engine
    cost = PandaPickObjective(pcfg).kernel_cost(pb)
    g = torch.Generator().manual_seed(SEED)
    V = torch.rand(ABLATE_K, ABLATE_H, pb.cmd_map.nu, generator=g) * 0.6 - 0.3
    pm = ModelParams(torch.ones(ABLATE_K, pb.scene.nbody), torch.ones(ABLATE_K, pb.scene.ngeom))

    def rollout(profile):
        return FusedRollout(pb, engine, cost, ABLATE_H, ABLATE_K, vis_body=pb.visualize_bodies[0],
                            impulse_sweeps=pcfg.mppi.rollout_sweeps, profile=profile)

    k1_in = rollout(None).pack(broadcast_state(held, ABLATE_K), pm, V)
    # fkonly keeps every dof, so of what it computes only the roots' drift
    # reaches its output (vis, the sum of the roots): every root gets a
    # seeded velocity
    rows = k1_in[0].clone()
    A = pb.scene.nactor
    lin = rows[: 13 * A].view(A, 13, -1)[:, 7:10]
    lin.copy_(torch.rand(lin.shape, generator=torch.Generator().manual_seed(SEED + 7)) - 0.5)
    tgts = []
    for _ in range(ABLATE_K2_STEPS):
        t_ = held.q + (torch.rand(pb.scene.ndof, generator=g) * 0.4 - 0.2)
        t_[7:9] = held.dof_target[7:9]
        tgts.append(t_.contiguous())
    sweeps = pcfg.isaacgym.fused_world_sweeps
    rows0 = FusedWorldStep(pb, engine, impulse_sweeps=sweeps).pack(held).contiguous()
    return dict(pb=pb, engine=engine, sweeps=sweeps, rollout=rollout, k1_in=k1_in,
                fk_in=(rows,) + tuple(k1_in[1:]), tgts=tgts, rows0=rows0)


def ablation_plain(dtype=torch.float32):
    """20b's ablated plain versions on the host CPU in dtype (the workers
    run float32; `scripts/profile_torch_step.py --drift HELD_GRASP
    --ablations` both, for ABLATE_BOUNDS). → {"k1": {mask: ((costs, vis),
    ms)}, "k2": {mask: (rows after ABLATE_K2_STEPS steps, ms per step)}}."""
    from mppiisaac_tpu_torch.ops.fused_rollout import (FusedWorldStep, rollout_plain,
                                                       world_step_plain)

    inp = ablation_inputs()
    out = {"k1": {}, "k2": {}}
    for mask in (4, 1, 7, 8, 16):
        fr = inp["rollout"](ABLATED[mask][1])
        x = inp["fk_in"] if mask == 7 else inp["k1_in"]
        out["k1"][mask] = timed_plain(
            rollout_plain, fr.ks, *(t.to(dtype) for t in x), fr.H, fr.substeps, fr.dt_sub,
            fr.vis_body, fr.impulse_sweeps, fr.world_fidelity, **fr.profile)
    for mask in (8, 16):
        fw = FusedWorldStep(inp["pb"], inp["engine"], impulse_sweeps=inp["sweeps"],
                            profile=ABLATED[mask][1])
        ks = fw.ks
        r, ms = inp["rows0"].to(dtype), 0.0
        for t_ in inp["tgts"]:
            r, t = timed_plain(world_step_plain, ks, r, t_.to(dtype),
                               torch.ones(ks.nbody, dtype=dtype), torch.ones(ks.ngeom, dtype=dtype),
                               fw.substeps, fw.dt_sub, fw.impulse_sweeps, **fw.profile)
            ms += t / len(inp["tgts"])
        out["k2"][mask] = (r, ms)
    return out


def ablation_holds(dev, plain):
    """20b: each ablated K1 (nocost, nocontact, fkonly, oneway, nogate) at
    the held grasp (ablation_inputs) on ABLATE_K samples at H=ABLATE_H, and
    the oneway and nogate K2 over ABLATE_K2_STEPS world steps, against their
    ablated plain versions (`plain`: ablation_plain's future, from the host
    CPU), each measure within ABLATE_BOUNDS (10× that plain version's own
    float32-vs-float64 drift there, floor 1e-6): the costs, and under
    zero_cost also vis (the sum of the roots). fkonly starts with every root
    given a seeded velocity and its vis must move. The gate off (nogate) bit
    for bit the default kernels, K1 and K2. → {mask: (K1 or K2 errors,
    plain ms)} by kernel."""
    from mppiisaac_tpu_torch.ops.fused_rollout import FusedWorldStep

    inp = ablation_inputs()
    base = inp["rollout"](None)
    k1_in = tuple(x.to(dev) for x in inp["k1_in"])
    c_ref, v_ref = base.run(*k1_in)
    t0 = time.perf_counter()
    res = plain.result()
    print(f"  [20b] the ablated plain versions came from the host CPU (waited "
          f"{time.perf_counter() - t0:.1f} s for them)", flush=True)
    out = {"k1": {}, "k2": {}}
    for mask in (4, 1, 7, 8, 16):
        name, profile = ABLATED[mask]
        fr = inp["rollout"](profile)
        inp_cpu = inp["fk_in"] if mask == 7 else inp["k1_in"]
        costs, vis = fr.run(*(x.to(dev) for x in inp_cpu))
        torch.cuda.synchronize()
        if mask == 16:
            same = torch.equal(costs, c_ref) and torch.equal(vis, v_ref)
            print(f"  [20b] K1 {name} (mask {mask}) at the held grasp, K={ABLATE_K}, "
                  f"H={ABLATE_H}: bit for bit the gated kernel: {same}", flush=True)
            if not same:
                fail("K1 with the broadphase gate off differs from the gated kernel")
        costs, vis = costs.cpu(), vis.cpu()
        (c32, v32), ms = res["k1"][mask]
        bound = ABLATE_BOUNDS[mask]
        errs, ok, line = three_measures((costs.double() - c32.double()).abs(), bound["k1"])
        print(f"  [20b] K1 {name} (mask {mask}) vs its plain version: {line}; the plain K1 "
              f"{ms / 1e3:.1f} s on the host CPU", flush=True)
        if not bool(torch.isfinite(costs).all()) or not ok:
            fail(f"K1 {name} disagrees with its ablated plain version")
        err = errs["max"]
        if fr.profile["zero_cost"]:
            # vis is the sum of the roots, unrounded: held as the costs are
            verrs, ok, line = three_measures((vis.double() - v32.double()).abs().amax(2).T,
                                             bound["vis"])
            print(f"  [20b] K1 {name} (mask {mask}) vis vs its plain version: {line}", flush=True)
            if not bool(torch.isfinite(vis).all()) or not ok:
                fail(f"K1 {name}: vis disagrees with its ablated plain version")
            err = max(err, verrs["max"])
        else:
            dv = (vis.double() - v32.double()).abs().max().item()
            if dv > VIS_ATOL:
                fail(f"K1 {name}: vis disagrees with its ablated plain version ({dv:.3e})")
        if mask == 7:
            r0 = inp_cpu[0][: 13 * fr.ks.nactor].view(fr.ks.nactor, 13, -1)[:, :3].sum(0).T
            moved = (vis[-1] - r0).abs().max().item()
            print(f"  [20b] K1 {name}: the roots moved {moved:.3e} from the input state",
                  flush=True)
            if moved <= 1e3 * max(err, 1e-6):
                fail(f"K1 {name}: its output did not move from the input state")
        out["k1"][mask] = (err, ms)
    # K2 from the held grasp
    ones_b = torch.ones(inp["pb"].scene.nbody, device=dev)
    ones_g = torch.ones(inp["pb"].scene.ngeom, device=dev)
    tgts = [t_.to(dev) for t_ in inp["tgts"]]
    rows0 = inp["rows0"].to(dev)
    ref_fw = FusedWorldStep(inp["pb"], inp["engine"], impulse_sweeps=inp["sweeps"])
    r_ref = rows0
    for t_ in tgts:
        r_ref = ref_fw.step_rows(r_ref, t_, ones_b, ones_g)
    for mask in (8, 16):
        name, profile = ABLATED[mask]
        fw = FusedWorldStep(inp["pb"], inp["engine"], impulse_sweeps=inp["sweeps"],
                            profile=profile)
        r = rows0
        for t_ in tgts:
            r = fw.step_rows(r, t_, ones_b, ones_g)
        torch.cuda.synchronize()
        if mask == 16:
            same = torch.equal(r, r_ref)
            print(f"  [20b] K2 {name} (mask {mask}) over {len(tgts)} steps from the held grasp: "
                  f"bit for bit the gated kernel: {same}", flush=True)
            if not same:
                fail("K2 with the broadphase gate off differs from the gated kernel")
        rp, plain_ms = res["k2"][mask]
        e = _groups(fw.ks, (r.cpu().double() - rp.double()).abs())
        b = ABLATE_BOUNDS[mask]["k2"]
        print(f"  [20b] K2 {name} (mask {mask}) vs its plain version over {len(tgts)} steps: "
              + ", ".join(f"{k} {e[k]:.3e} (bound {b[k]:.3g})" for k in e)
              + f"; the plain K2 {plain_ms:.1f} ms a step on the host CPU", flush=True)
        if not bool(torch.isfinite(r).all()) or any(e[k] > b[k] for k in e):
            fail(f"K2 {name} disagrees with its ablated plain version")
        out["k2"][mask] = (max(e.values()), plain_ms)
    return out


def phase20(dev, builds, plain):
    """Phase 20 → the ablated kernels' entries: 20a the ablation library
    (started with the others in phase 1) and the section build; 20b the
    holds (ablation_holds); 20c the ablation profiler
    (`python -m mppiisaac_tpu_torch.profile_kernel`, its defaults: the bench
    twin's pick at K=1000, H=30) with the counts zeroed before it and read
    after it, every ablated instantiation launched there, its BREAKDOWN
    printed beside the clock64() split of the full K1 on the same inputs."""
    from mppiisaac_tpu_torch import profile_kernel
    from mppiisaac_tpu_torch.ops import native
    from mppiisaac_tpu_torch.ops.fused_rollout import FusedRollout, FusedWorldStep

    t0 = time.perf_counter()
    for v, th in builds.items():
        path, nvcc_s, ptxas = join_build(th)
        print(f"[20a] build {v}: nvcc {nvcc_s:.1f} s (started in phase 1 beside the main build) -> "
              f"{os.path.relpath(path, os.path.dirname(os.path.abspath(__file__)))}", flush=True)
        for line in ptxas.splitlines():
            if v == native.ABLATE and ("registers" in line or "Compiling entry" in line):
                print("    ptxas:", line.strip())
    holds = ablation_holds(dev, plain)
    print(f"    phase 20b: {time.perf_counter() - t0:.1f} s", flush=True)
    FusedRollout.launches = FusedWorldStep.launches = 0
    FusedRollout.ablated_launches.clear()
    FusedWorldStep.ablated_launches.clear()
    prof = profile_kernel.main(["sections"])
    torch.cuda.synchronize()
    n1, n2 = dict(FusedRollout.ablated_launches), dict(FusedWorldStep.ablated_launches)
    print(f"[20c] the profiler's launches: K1 default {FusedRollout.launches}, ablated {n1}; "
          f"K2 default {FusedWorldStep.launches}, ablated {n2}", flush=True)
    from mppiisaac_tpu_torch.ops.fused_rollout import K1_MASKS, K2_MASKS

    if any(n1.get(m, 0) == 0 for m in K1_MASKS) or any(n2.get(m, 0) == 0 for m in K2_MASKS):
        fail("an ablated kernel was not launched on the profiler's path")
    sec = prof["sections"]
    b = prof["breakdown"]
    print("[20c] BREAKDOWN beside the clock64 split of the full K1 (the same inputs): cost "
          f"{b['cost_section_ms']:.3f} ms ({b['cost_section_ms'] / b['full_ms']:.3f} of full; "
          f"sections: command map and cost {sec['command map and cost']:.3f}), sweeps "
          f"{b['gs_sweeps_ms']:.3f} ms ({b['gs_sweeps_ms'] / b['full_ms']:.3f}; warm start + "
          f"sweeps + snap {sec['warm start'] + sec['sweeps'] + sec['snap']:.3f}), contacts "
          f"{b['contacts_ms']:.3f} ms ({b['contacts_ms'] / b['full_ms']:.3f}; "
          f"{sec['contacts']:.3f}), articulated solve {b['artic_solve_ms']:.3f} ms "
          f"({b['artic_solve_ms'] / b['full_ms']:.3f}; solves "
          f"{sum(sec[k] for k in profile_kernel.SECTIONS if k.startswith('solves')):.3f}), "
          f"FK/integrate base {b['fk_integrate_base_ms']:.3f} ms "
          f"({b['fk_integrate_base_ms'] / b['full_ms']:.3f}; fk {sec['fk']:.3f}); "
          f"{b['device']}, {b['power_limit']}", flush=True)
    src = "mppiisaac_tpu_torch/csrc/fused_rollout.cu"
    entries = []
    for mask in K1_MASKS:
        name, profile = ABLATED[mask]
        r = prof["k1"][name]
        bnd = k1_bound(r["fr"], r["inputs"])
        entries.append({
            "name": f"fused_rollout_kernel[{name}]", "path": f"profile_kernel_pick_K{r['fr'].K}_H"
            f"{r['fr'].H}", "route": "cuda", "source": src,
            "replaces": "mppiisaac_tpu/ops/pallas/fused_rollout.py:367", "launches": n1[mask],
            "max_abs_err": holds["k1"][mask][0], "ms": r["ms"], "plain_ms": holds["k1"][mask][1],
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None, "ablation_mask": mask,
            "profile": profile, "sweeps": r["fr"].impulse_sweeps, "plain_samples": ABLATE_K,
            "plain_H": ABLATE_H, "max_abs_err_at": "held grasp", "plain_on": "host CPU"})
    for mask in K2_MASKS:
        name, profile = ABLATED[mask]
        r = prof["k2"][name]
        bnd = k2_bound(r["fw"], r["inputs"])
        entries.append({
            "name": f"fused_world_step_kernel[{name}]", "path": "profile_kernel_pick_world",
            "route": "cuda", "source": src, "replaces": "mppiisaac_tpu/ops/pallas/fused_rollout.py:533",
            "launches": n2[mask], "max_abs_err": holds["k2"][mask][0], "ms": r["ms"],
            "plain_ms": holds["k2"][mask][1], "bound_ms": bnd[0], "bound_by": bnd[1],
            "library_ms": None, "ablation_mask": mask, "profile": profile,
            "max_abs_err_at": "held grasp", "plain_on": "host CPU"})
    print(f"    phase 20: {time.perf_counter() - t0:.1f} s", flush=True)
    return entries, b



# ---------------------------------------------------------------------------
# phase 21: multi_jackal's commands and world steps recorded on the card,
# held against the JAX package's outputs from the same inputs
# ---------------------------------------------------------------------------

# `python -m mppiisaac_tpu_torch.validate jackal ... record=` on the card, with
# the JAX package's outputs and the port plain's own float32-vs-float64 drift
# of each record added by scripts/jackal_commands_jax.py on the CPU
JACKAL_RECORDS = "tests/data/multi_jackal_commands.npz"
COMMAND_MEASURES = ("costs_max", "costs_first", "costs_median", "S_max", "S_median", "U", "action")


def command_measures(a, b):
    """How far two commands part (dicts of CPU arrays: the rollout's costs
    (K, H), S (K,), the new U and the action), by COMMAND_MEASURES."""
    d = {k: (torch.as_tensor(a[k]).double() - torch.as_tensor(b[k]).double()).abs()
         for k in ("costs", "S", "U", "action")}
    return {"costs_max": d["costs"].max().item(), "costs_first": d["costs"][:, 0].max().item(),
            "costs_median": d["costs"].max(1).values.median().item(),
            "S_max": d["S"].max().item(), "S_median": d["S"].median().item(),
            "U": d["U"].max().item(), "action": d["action"].max().item()}


def out_rows(fw, st):
    """K2's output rows of a 1-env state (N=1): its packed rows with its
    net contact forces in their place (packing leaves them zero)."""
    ks = fw.ks
    lo = 13 * ks.nactor + 2 * ks.ndof
    r = fw.pack(st)[:, 0].clone()
    r[lo: ks.n_state_rows] = st.net_contact_force[0].reshape(-1)
    return r


def jackal_records(dev):
    """Phase 21: from each record of JACKAL_RECORDS (seed 42's initial state
    and states along seeds 0-4's episodes, stalls among them) the card's
    multi_jackal command (`MPPIisaacPlanner._full`: K1 at K=300, H=12) from
    the recorded carry and world state, and K2 from the recorded state with
    the recorded action, held against the JAX package's outputs: the
    rollout's costs (largest, first step's, median over samples), S (largest,
    median), the new U and the action, and the state after K2 by row group,
    each within 10× the port plain's own rounding in the same measure at
    that record (floor 1e-6): the larger of its float32-vs-float64 drift and
    its envelope under one float32 rounding of the state
    (scripts/jackal_commands_jax.py). The launch counters are set to 0 just
    before and read just after. → (K1, K2 launches, the largest difference
    of each measure)."""
    from mppiisaac_tpu_torch.mppi.solver import MppiCarry
    from mppiisaac_tpu_torch.physics.types import SIM_STATE_FIELDS, SimState
    from mppiisaac_tpu_torch.planner.mppi_isaac import MPPIisaacPlanner
    from mppiisaac_tpu_torch.runtime.sim import Simulation
    from mppiisaac_tpu_torch.tasks.multi_robot import MultiJackalObjective
    from mppiisaac_tpu_torch.utils.config_store import load_config

    t0 = time.perf_counter()
    with np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), JACKAL_RECORDS)) as f:
        d = {k: f[k] for k in f.files}
    cfg = load_config("tasks/multi_jackal")
    planner = MPPIisaacPlanner(cfg, MultiJackalObjective(cfg), device=dev)
    pm = planner._params_K
    if not (np.array_equal(pm.body_mass_scale.cpu().numpy(), d["params.body_mass_scale"])
            and np.array_equal(pm.geom_friction.cpu().numpy(), d["params.geom_friction"])):
        fail("multi_jackal's per-sample ModelParams differ from the records'")
    world = Simulation(cfg.isaacgym, cfg.actors, cfg.initial_actor_positions, device=dev)
    fw = world._world_step
    R = len(d["seed"])
    worst = dict.fromkeys(COMMAND_MEASURES + ("pose", "vel", "lam"), 0.0)
    reset_counts()
    outs = []
    for i in range(R):
        t = (lambda k: torch.as_tensor(d[k][i], device=dev))
        carry = MppiCarry(U=t("carry.U"), lambda_=t("carry.lambda"), sigma=t("carry.sigma"),
                          t0=torch.tensor(int(d["carry.t0"][i]), device=dev),
                          key=np.array(d["carry.key"][i], np.uint32))
        ws = SimState(**{f: t(f"before.{f}") for f in SIM_STATE_FIELDS if f"before.{f}" in d})
        action, new, info = planner._full(carry, ws)
        st = world.stepped(world.commanded(ws, t("card.action")[None]))
        hold_bodies(f"[21] seed {int(d['seed'][i])} step {int(d['step'][i])}", fw.engine, st)
        outs.append(({"costs": info["rollout_costs"].cpu(), "S": info["costs"].cpu(),
                      "U": new.U.cpu(), "action": action.reshape(-1).cpu()},
                     out_rows(fw, st).cpu()))
    n1, n2 = read_counts()
    print(f"[21] multi_jackal: {R} recorded states (seeds {sorted(set(d['seed'].tolist()))}, "
          f"{int(d['stalled'].sum())} from stalled episodes; recorded on {d['device']}) through "
          f"the card's command and K2; launches K1 {n1}, K2 {n2}", flush=True)
    if (n1, n2) != (R, R):
        fail(f"phase 21: expected {R} launches of each kernel, got K1 {n1}, K2 {n2}")
    same = 0
    for i, (card, rows) in enumerate(outs):
        jax_ = {k: d[f"jax.{k}"][i] for k in ("costs", "S", "U", "action")}
        e = command_measures(card, jax_)
        e.update(_groups(fw.ks, (rows.double() - torch.as_tensor(d["jax.after_rows"][i]).double())
                         .abs()))
        b = {k: max(10.0 * max(float(d[f"drift.{k}"][i]), float(d[f"envelope.{k}"][i])), 1e-6)
             for k in e}
        same += all(np.array_equal(card[k].numpy(), d[f"card.{k}"][i]) for k in card)
        print(f"  seed {int(d['seed'][i])} step {int(d['step'][i])}"
              f"{' (stalled episode)' if d['stalled'][i] else ''}: " + ", ".join(
                  f"{k} {e[k]:.2e} (bound {b[k]:.2e})" for k in e), flush=True)
        finite = all(bool(torch.isfinite(torch.as_tensor(v)).all()) for v in card.values())
        if not finite or any(e[k] > b[k] for k in e):
            fail(f"phase 21: the card's command or K2 at seed {int(d['seed'][i])} step "
                 f"{int(d['step'][i])} disagrees with the JAX package's")
        for k in e:
            worst[k] = max(worst[k], e[k])
    print(f"    the card's commands bit for bit the recorded ones at {same} of {R} records; "
          f"phase 21 {time.perf_counter() - t0:.1f} s", flush=True)
    return n1, n2, worst


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
    from mppiisaac_tpu_torch.examples import balls_demo

    w = balls_demo.balls_sim(1, BALLS_BALLS, device="cpu")
    W, nbytes = launch_geometry(KernelScene.build(w.built, w.engine, None), BALLS_ENVS, n_sm)
    print(f"    geometry balls batch: K2 N={BALLS_ENVS} envs, {W} warps per block, "
          f"{-(-BALLS_ENVS // W)} blocks on {n_sm} SMs, {tables + W * nbytes} B shared per block "
          f"({tables} B tables + {W} x {nbytes} B per env)", flush=True)


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
    pool = plain_pool(root)
    try:
        smoke(dev, root, pool, native)
    finally:
        stop_pool(pool)


def smoke(dev, root, pool, native):
    """Phases 1-21 (the module's docstring), then the result lines."""
    t_start = time.perf_counter()
    # 20b's plain versions start on the host CPU now; the card's phases run
    # meanwhile
    ablation = pool.submit(ablation_plain)

    # ---- 1. build ----
    t0 = time.perf_counter()
    # the ablation and section libraries (phase 20) compile beside the main one
    builds = start_builds((native.ABLATE, "sections"))
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
        rec = arm_path(task, dev, root, pool)
        if task != "panda_effort":
            records.append(rec)
    for task in MESH_LOOPS:
        records.append(mesh_path(task, dev, root, pool))
    records.append(anymal_path(dev, root, pool))
    records.append(fast_pick_path(dev, root, pick, pool))
    records.append(box_pair_path(dev, root))
    api_path(dev)
    rpc_path(dev, root)
    episode_paths(dev)
    chunked_paths(dev, root)
    batch = batched_paths(dev)
    bench_run = bench_path(dev, pool)

    # ---- 18. timing, and each kernel's bound on the timed inputs ----
    t0 = time.perf_counter()
    entries = []
    src = "mppiisaac_tpu_torch/csrc/fused_rollout.cu"
    for r in records:
        if "finish" in r:                # its K1 holds against the host CPU's plain version
            r.update(r.pop("finish")())
        fr, fw, k1_in, k2_in = r["fr"], r["fw"], r["k1_in"], r["k2_in"]
        k1_ms, k2_ms = cuda_time_ms(lambda: fr.run(*k1_in)), cuda_time_ms(lambda: fw.step_rows(*k2_in))
        body = torch.empty(13 * fw.ks.nbody, device=dev)
        k2b_ms = cuda_time_ms(lambda: fw.step_rows(*k2_in, body=body))
        if r["plain"] is None:
            plain = (cuda_time_ms(lambda: fr.plain(*k1_in), reps=5, warmup=1),
                     cuda_time_ms(lambda: fw.plain(*k2_in), reps=5, warmup=1))
        else:
            plain = r["plain"]
        b1, b2 = k1_bound(fr, k1_in), k2_bound(fw, k2_in)
        print(f"[18] {r['key']}: K1 {k1_ms:.3f} ms vs plain {plain[0]:.3f} ms; K2 {k2_ms:.3f} ms "
              f"vs plain {plain[1]:.3f} ms (kernels: medians); bounds: K1 {b1[0]:.6f} ms ({b1[1]}: "
              f"{b1[2]:.4g} flop, {b1[3]} B, live block share {b1[4]:.3f}), K2 {b2[0]:.6f} ms "
              f"({b2[1]}: {b2[2]:.4g} flop, {b2[3]} B, live block share {b2[4]:.3f}); K2 with "
              f"its body rows {k2b_ms:.3f} ms (the epilogue {k2b_ms - k2_ms:+.3f} ms)", flush=True)
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
        entries[-1]["body_rows_ms"] = k2b_ms
    # the batched K2 (the balls at BALLS_ENVS envs) and the bench's K1 (H=30)
    fw, k2_in = batch["fw"], batch["k2_in"]
    N = k2_in[0].shape[1]
    k2_ms = cuda_time_ms(lambda: fw.step_rows(*k2_in))
    k2_plain = cuda_time_ms(lambda: fw.plain(*k2_in), reps=3, warmup=1)
    b2 = k2_bound(fw, k2_in)
    W = fw.warps(dev, N)
    tables = len(fw._tables._bytes)
    # the same launch shape on the first n_sm·W envs: one wave of blocks
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    wave_in = [x[:, : n_sm * W].contiguous() for x in k2_in]
    wave_ms = cuda_time_ms(lambda: fw.step_rows(*wave_in))
    body = torch.empty(13 * fw.ks.nbody, N, device=dev)
    k2b_ms = cuda_time_ms(lambda: fw.step_rows(*k2_in, body=body))
    print(f"[18] balls batch N={N}: K2 {k2_ms:.3f} ms vs plain {k2_plain:.3f} ms; {W} warps per "
          f"block, {-(-N // W)} blocks on {n_sm} SMs, {tables + W * fw.warp_bytes} B shared; one "
          f"wave ({n_sm * W} envs, {n_sm} blocks) {wave_ms:.3f} ms; bound {b2[0]:.6f} ms ({b2[1]}: "
          f"{b2[2]:.4g} flop, {b2[3]} B, live block share {b2[4]:.3f}); "
          f"{N / k2_ms * 1e3:.0f} env-steps/s in the kernel; with its body rows {k2b_ms:.3f} ms "
          f"(the epilogue {k2b_ms - k2_ms:+.3f} ms)", flush=True)
    entries.append({
        "name": "fused_world_step_kernel", "path": f"balls_batch_N{N}", "route": "cuda",
        "source": src, "replaces": "mppiisaac_tpu/ops/pallas/fused_rollout.py:533",
        "launches": batch["n2"], "max_abs_err": batch["err"], "ms": k2_ms, "plain_ms": k2_plain,
        "bound_ms": b2[0], "bound_by": b2[1], "library_ms": None, "warps_per_block": W,
        "smem_bytes": tables + W * fw.warp_bytes, "envs": N, "blocks": -(-N // W),
        "one_wave_envs": n_sm * W, "one_wave_ms": wave_ms, "body_rows_ms": k2b_ms,
        "demo_ms_per_step": batch["demo"]["ms_per_step"],
        "demo_env_steps_per_s": batch["demo"]["env_steps_per_s"]})
    bench_hold(bench_run)
    fr, k1_in = bench_run["fr"], bench_run["k1_in"]
    k1_ms = cuda_time_ms(lambda: fr.run(*k1_in), reps=10)
    b1 = k1_bound(fr, k1_in)
    W = fr.warps(dev)
    tables = len(fr._tables._bytes)
    print(f"[18] bench K={fr.K}, H={fr.H}: K1 {k1_ms:.3f} ms vs plain {bench_run['plain_ms']:.3f} "
          f"ms on {BENCH_PLAIN_SAMPLES} samples; {W} warps per block; bound {b1[0]:.6f} ms "
          f"({b1[1]}: {b1[2]:.4g} flop, {b1[3]} B, live block share {b1[4]:.3f})", flush=True)
    entries.append({
        "name": "fused_rollout_kernel", "path": f"bench_pick_K{fr.K}_H{fr.H}", "route": "cuda",
        "source": src, "replaces": "mppiisaac_tpu/ops/pallas/fused_rollout.py:367",
        "launches": bench_run["n1"], "max_abs_err": bench_run["err"], "ms": k1_ms,
        "plain_ms": bench_run["plain_ms"], "bound_ms": b1[0], "bound_by": b1[1],
        "library_ms": None, "warps_per_block": W, "smem_bytes": tables + W * fr.warp_bytes,
        "plain_samples": BENCH_PLAIN_SAMPLES, "plain_on": "host CPU",
        "first_step_max_abs_err": bench_run["errs"]["first"],
        "median_max_abs_err": bench_run["errs"]["median"],
        "bench_env_steps_per_s": bench_run["rec"]["value"],
        "bench_latency_ms": bench_run["rec"]["latency_ms"]})
    print(f"    phase 18: {time.perf_counter() - t0:.1f} s", flush=True)
    reach_entry = next(e for e in entries if e["path"] == "panda_reach"
                       and e["name"] == "fused_world_step_kernel")
    entries += phase19(dev, root, reach_entry, batch["demo"])
    ablated, _ = phase20(dev, builds, ablation)
    entries += ablated
    n1, n2, worst = jackal_records(dev)
    for e in entries:
        if e["path"] == "multi_jackal":
            k2 = e["name"] == "fused_world_step_kernel"
            e.update({"records_launches": n2 if k2 else n1,
                      "records_vs_jax_max_abs_err": (max(worst[k] for k in ("pose", "vel", "lam"))
                                                     if k2 else worst["costs_max"])})
    from mppiisaac_tpu_torch.ops.fused_rollout import FusedWorldStep

    refreshes = FusedWorldStep.torch_refreshes
    print(f"    world steps whose body caches came from engine.refresh over the run: {refreshes}",
          flush=True)
    if refreshes:
        fail("a fused world step on the card refreshed its body caches in torch, not in K2")
    print(f"    the whole run: {time.perf_counter() - t_start:.1f} s", flush=True)
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
