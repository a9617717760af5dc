"""The CUDA kernels against their plain PyTorch versions on the card, at the
shapes of the panda reach, panda pick (also at fast fidelity with the
reduced manifold), boxer_push, point-robot, panda_effort, omni_panda_pick,
multi_jackal, albert and anymal main paths, on the box pair of the full
box–box manifold (bbA/bbB), and on the mini-gripper grasp scenes (a ball held
by fingers with the gripper map or with effort fingers, and velocity fingers
closing on a post through the finger force gate), and K2 over a grid of
envs (a randomized point-robot batch, the 1080-ball demo through
`Simulation.step`), K2's body caches against `engine.refresh` of its
stepped state (reach, pick's held grasp, the 1080-ball batch), and every
instantiation of the ablation library (its kernels against their ablated
plain versions, the gate off bit for bit the default kernels, a mask it
lacks refused). Marked `cuda`: they skip without an
NVIDIA GPU and run on the card (whose machine has no JAX, which
tests/conftest.py imports) with

    python -m pytest tests/test_torch_cuda.py -m cuda -p no:cacheprovider --noconftest
"""
import os

import numpy as np
import pytest
import torch

import chip_smoke
from mppiisaac_tpu_torch.ops.fused_rollout import FusedRollout, FusedWorldStep
from mppiisaac_tpu_torch.physics.types import ModelParams, SimState
from mppiisaac_tpu_torch.runtime.sim import Simulation, broadcast_state
from mppiisaac_tpu_torch.scene.builder import SimConfig
from mppiisaac_tpu_torch.tasks.panda_pick import PandaPickObjective
from mppiisaac_tpu_torch.tasks.panda_reach import PandaReachObjective
from mppiisaac_tpu_torch.utils.config_store import load_config

pytestmark = pytest.mark.cuda

# see chip_smoke.py for the reasons behind these bounds
COST_TOL = 1e-4
STATE_TOL = 1e-4
VIS_ATOL = 1e-2
# pick from the settled block: chip_smoke.py PICK_BOUNDS["settled block"]
# (the largest of its row groups for the world rows)
PICK_COST_ATOL, PICK_COST_RTOL = 5e-4, 0.0
PICK_STATE_ATOL, PICK_STATE_RTOL = 2e-3, 0.0


@pytest.fixture(scope="module")
def panda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    cfg = load_config("tasks/panda")
    world = Simulation(cfg.isaacgym, cfg.actors, cfg.initial_actor_positions, device="cuda")
    return cfg, world


def test_rollout_kernel_matches_plain(panda):
    cfg, world = panda
    built = world.built
    K, H = cfg.mppi.num_samples, cfg.mppi.horizon
    fr = FusedRollout(built, world.engine, PandaReachObjective(cfg).kernel_cost(built), H, K,
                      vis_body=built.visualize_bodies[0])
    g = torch.Generator().manual_seed(1)
    V = (torch.rand(K, H, fr.nu, generator=g) * 4 - 2).cuda()
    st = broadcast_state(world.state.map(lambda x: x[0]), K)
    pm = ModelParams(torch.ones(K, built.scene.nbody, device="cuda"),
                     torch.ones(K, built.scene.ngeom, device="cuda"))
    inputs = fr.pack(st, pm, V)
    n0 = FusedRollout.launches
    costs, vis = fr.run(*inputs)
    torch.cuda.synchronize()
    assert FusedRollout.launches == n0 + 1
    costs_p, vis_p = fr.plain(*inputs)
    assert costs.shape == (K, H) and vis.shape == (H, K, 3)
    torch.testing.assert_close(costs, costs_p, rtol=COST_TOL, atol=COST_TOL)
    torch.testing.assert_close(vis, vis_p, rtol=0.0, atol=VIS_ATOL)


def test_world_step_kernel_matches_plain(panda):
    cfg, world = panda
    built = world.built
    fw = FusedWorldStep(built, world.engine)
    rows = fw.pack(world.state.map(lambda x: x[0])).contiguous()
    rows_p = rows.clone()
    ones_b = torch.ones(built.scene.nbody, device="cuda")
    ones_g = torch.ones(built.scene.ngeom, device="cuda")
    g = torch.Generator().manual_seed(2)
    for _ in range(10):
        tgt = (torch.rand(built.scene.ndof, generator=g) * 4 - 2).cuda()
        rows = fw.step_rows(rows, tgt, ones_b, ones_g)
        rows_p = fw.plain(rows_p, tgt, ones_b, ones_g)
    torch.cuda.synchronize()
    torch.testing.assert_close(rows, rows_p, rtol=STATE_TOL, atol=STATE_TOL)


def test_wrapper_rejects_bad_inputs(panda):
    cfg, world = panda
    built = world.built
    fw = FusedWorldStep(built, world.engine)
    rows = fw.pack(world.state.map(lambda x: x[0])).contiguous()
    tgt = torch.zeros(built.scene.ndof, device="cuda", dtype=torch.float64)
    ones_b = torch.ones(built.scene.nbody, device="cuda")
    ones_g = torch.ones(built.scene.ngeom, device="cuda")
    with pytest.raises(ValueError, match="dtype"):
        fw.step_rows(rows, tgt, ones_b, ones_g)
    with pytest.raises(ValueError, match="on cpu"):
        fw.step_rows(rows, tgt.float(), ones_b.cpu(), ones_g)
    with pytest.raises(ValueError, match="body: shape"):
        fw.step_rows(rows, tgt.float(), ones_b, ones_g, body=torch.empty(13, device="cuda"))


def test_world_step_kernel_prismatic_scene(panda):
    """A second scene through the same build: point_robot with collision off
    (prismatic + continuous joints, gravity on)."""
    from mppiisaac_tpu_torch.physics.step import Engine
    from mppiisaac_tpu_torch.scene.actor import ActorSpec
    from mppiisaac_tpu_torch.scene.builder import SimConfig, build_scene

    built = build_scene([ActorSpec(type="robot", name="point_robot", urdf_file="point_robot.urdf",
                                   fixed=True, collision=False)], SimConfig(dt=0.05, substeps=2))
    engine = Engine(built.scene)
    fw = FusedWorldStep(built, engine)
    st = built.initial_state(engine, "cuda")
    rows = fw.pack(st).contiguous()
    rows_p = rows.clone()
    ones_b = torch.ones(built.scene.nbody, device="cuda")
    ones_g = torch.ones(built.scene.ngeom, device="cuda")
    g = torch.Generator().manual_seed(3)
    for _ in range(10):
        tgt = (torch.rand(built.scene.ndof, generator=g) * 2 - 1).cuda()
        rows = fw.step_rows(rows, tgt, ones_b, ones_g)
        rows_p = fw.plain(rows_p, tgt, ones_b, ones_g)
    torch.cuda.synchronize()
    torch.testing.assert_close(rows, rows_p, rtol=STATE_TOL, atol=STATE_TOL)


@pytest.fixture(scope="module")
def pick(panda):
    cfg = load_config("tasks/panda_pick")
    world = Simulation(cfg.isaacgym, cfg.actors, cfg.initial_actor_positions, device="cuda")
    fw = FusedWorldStep(world.built, world.engine, impulse_sweeps=cfg.isaacgym.fused_world_sweeps)
    params = ModelParams(torch.ones(world.scene.nbody, device="cuda"),
                         torch.ones(world.scene.ngeom, device="cuda"))
    st = world.state.map(lambda x: x[0])
    hold = st.q.clone()
    for _ in range(20):                       # the block falls and settles on the table
        st = fw.step(st.replace(dof_target=hold), params)
    return cfg, world, fw, st


def test_pick_rollout_kernel_matches_plain(pick):
    cfg, world, _, st = pick
    built = world.built
    K, H = cfg.mppi.num_samples, cfg.mppi.horizon
    fr = FusedRollout(built, world.engine, PandaPickObjective(cfg).kernel_cost(built), H, K,
                      vis_body=built.visualize_bodies[0], impulse_sweeps=cfg.mppi.rollout_sweeps)
    g = torch.Generator().manual_seed(4)
    V = (torch.rand(K, H, fr.nu, generator=g) * 0.6 - 0.3).cuda()
    pm = ModelParams(torch.ones(K, built.scene.nbody, device="cuda"),
                     torch.ones(K, built.scene.ngeom, device="cuda"))
    inputs = fr.pack(broadcast_state(st, K), pm, V)
    n0 = FusedRollout.launches
    costs, vis = fr.run(*inputs)
    torch.cuda.synchronize()
    assert FusedRollout.launches == n0 + 1
    costs_p, vis_p = fr.plain(*inputs)
    torch.testing.assert_close(costs, costs_p, rtol=PICK_COST_RTOL, atol=PICK_COST_ATOL)
    torch.testing.assert_close(vis, vis_p, rtol=0.0, atol=VIS_ATOL)


def test_pick_world_step_kernel_matches_plain(pick):
    _, world, fw, st = pick
    built = world.built
    rows = fw.pack(st).contiguous()
    rows_p = rows.clone()
    ones_b = torch.ones(built.scene.nbody, device="cuda")
    ones_g = torch.ones(built.scene.ngeom, device="cuda")
    g = torch.Generator().manual_seed(5)
    for _ in range(5):
        tgt = st.q + (torch.rand(built.scene.ndof, generator=g) * 0.4 - 0.2).cuda()
        rows = fw.step_rows(rows, tgt, ones_b, ones_g)
        rows_p = fw.plain(rows_p, tgt, ones_b, ones_g)
    torch.cuda.synchronize()
    torch.testing.assert_close(rows, rows_p, rtol=PICK_STATE_RTOL, atol=PICK_STATE_ATOL)
    assert float(rows_p[fw.ks.n_state_rows:].abs().max()) > 0.0, "no λ row carried an impulse"


def test_grasp_scene_kernels_match_plain(panda):
    """The mini-gripper holding a ball: couple terms, Ψ, two-way sweeps, λ
    warm start and snap on a second scene, K2 closing for 5 steps, then K1
    from the held grasp."""
    from mppiisaac_tpu_torch.ops import fused_physics as tfp
    from mppiisaac_tpu_torch.physics.step import Engine
    from mppiisaac_tpu_torch.scene.actor import ActorSpec
    from mppiisaac_tpu_torch.scene.builder import SimConfig, build_scene

    built = build_scene([
        ActorSpec(type="robot", name="mini_gripper", fixed=True, gripper_binarize=True,
                  init_pos=[0.0, 0.0, 0.5]),
        ActorSpec(type="sphere", name="ball", size=[0.02], mass=0.005, init_pos=[0.0, 0.0, 0.53],
                  friction=1.0)], SimConfig(dt=0.05, substeps=2))
    engine = Engine(built.scene)
    fw = FusedWorldStep(built, engine)
    st = built.initial_state(engine, "cuda")
    st = engine.refresh(st.replace(q=torch.full_like(st.q, 0.034)))
    rows = fw.pack(st).contiguous()
    rows_p = rows.clone()
    ones_b = torch.ones(built.scene.nbody, device="cuda")
    ones_g = torch.ones(built.scene.ngeom, device="cuda")
    tgt = built.cmd_map.apply(torch.full((2,), -1.0, device="cuda"), st.q)
    for _ in range(5):
        rows = fw.step_rows(rows, tgt, ones_b, ones_g)
        rows_p = fw.plain(rows_p, tgt, ones_b, ones_g)
    torch.cuda.synchronize()
    torch.testing.assert_close(rows, rows_p, rtol=STATE_TOL, atol=STATE_TOL)
    ball = built.scene.actor_index("ball")
    spec = tfp.CostSpec(task=tfp.TASK_PANDA_PICK, ee_body=built.scene.body_offset[ball] - 1,
                        goal_actor=0, w_dist=1.0, w_ori=0.5, block_actor=ball,
                        force_body0=built.scene.body_offset[ball], force_nbody=1, w_block=2.0,
                        w_force=0.01)
    K, H = 256, 6
    fr = FusedRollout(built, engine, spec, H, K, vis_body=built.scene.body_offset[ball])
    A, D, NS = fw.ks.nactor, fw.ks.ndof, fw.ks.n_state_rows
    held = st.with_root_state(rows[:13 * A].reshape(A, 13)).replace(
        q=rows[13 * A:13 * A + D], qd=rows[13 * A + D:13 * A + 2 * D])
    lam = held.contact_lam.clone()
    lam[torch.as_tensor(fw.fc_idx, device="cuda")] = rows[NS:].reshape(-1, 4)
    held = held.replace(contact_lam=lam)
    g = torch.Generator().manual_seed(6)
    V = (torch.rand(K, H, fr.nu, generator=g) * 2 - 1).cuda()
    pm = ModelParams(torch.ones(K, built.scene.nbody, device="cuda"),
                     torch.ones(K, built.scene.ngeom, device="cuda"))
    inputs = fr.pack(broadcast_state(held, K), pm, V)
    costs, vis = fr.run(*inputs)
    torch.cuda.synchronize()
    costs_p, vis_p = fr.plain(*inputs)
    torch.testing.assert_close(costs, costs_p, rtol=COST_TOL, atol=COST_TOL)
    torch.testing.assert_close(vis, vis_p, rtol=0.0, atol=VIS_ATOL)


@pytest.fixture(scope="module")
def boxer_push(panda):
    from mppiisaac_tpu_torch.tasks.mobile_push import MobilePushObjective

    cfg = load_config("tasks/boxer_push")
    world = Simulation(cfg.isaacgym, cfg.actors, cfg.initial_actor_positions, device="cuda")
    return cfg, world, MobilePushObjective(cfg, "boxer", "ee_link")


def test_boxer_push_rollout_kernel_matches_plain(boxer_push):
    """K1 at the boxer_push config (K=400, H=12, 2 sweeps) from the boxer
    resting on its wheels: the floating base and its stiction blocks.
    Bounds: chip_smoke.py BOXER_BOUNDS["initial"]."""
    import chip_smoke

    cfg, world, obj = boxer_push
    built = world.built
    K, H = cfg.mppi.num_samples, cfg.mppi.horizon
    fr = FusedRollout(built, world.engine, obj.kernel_cost(built), H, K,
                      vis_body=built.visualize_bodies[0], impulse_sweeps=cfg.mppi.rollout_sweeps)
    g = torch.Generator().manual_seed(7)
    V = (torch.rand(K, H, fr.nu, generator=g) * 2 - 1).cuda()
    pm = ModelParams(torch.ones(K, built.scene.nbody, device="cuda"),
                     torch.ones(K, built.scene.ngeom, device="cuda"))
    inputs = fr.pack(broadcast_state(world.state.map(lambda x: x[0]), K), pm, V)
    n0 = FusedRollout.launches
    costs, vis = fr.run(*inputs)
    torch.cuda.synchronize()
    assert FusedRollout.launches == n0 + 1
    costs_p, vis_p = fr.plain(*inputs)
    bound = chip_smoke.BOXER_BOUNDS["initial"]["k1_max"]
    torch.testing.assert_close(costs, costs_p, rtol=0.0, atol=bound)
    torch.testing.assert_close(vis, vis_p, rtol=0.0, atol=VIS_ATOL)


def test_boxer_push_world_step_kernel_matches_plain(boxer_push):
    """K2 (16 sweeps) over 5 world steps under random (v, ω) from rest, λ
    rows included. Bounds: chip_smoke.py BOXER_BOUNDS["initial"] (the
    largest of its row groups)."""
    import chip_smoke

    cfg, world, _ = boxer_push
    built = world.built
    fw = FusedWorldStep(built, world.engine, impulse_sweeps=cfg.isaacgym.fused_world_sweeps)
    st = world.state.map(lambda x: x[0])
    rows = fw.pack(st).contiguous()
    rows_p = rows.clone()
    ones_b = torch.ones(built.scene.nbody, device="cuda")
    ones_g = torch.ones(built.scene.ngeom, device="cuda")
    g = torch.Generator().manual_seed(8)
    for _ in range(5):
        u = (torch.rand(fw.ks.nu, generator=g) * 2 - 1).cuda()
        tgt = built.cmd_map.apply(u[None], st.q[None])[0].contiguous()
        rows = fw.step_rows(rows, tgt, ones_b, ones_g)
        rows_p = fw.plain(rows_p, tgt, ones_b, ones_g)
    torch.cuda.synchronize()
    b = chip_smoke.BOXER_BOUNDS["initial"]
    torch.testing.assert_close(rows, rows_p, rtol=0.0, atol=max(b["pose"], b["vel"], b["lam"]))
    assert float(rows_p[fw.ks.n_state_rows:].abs().max()) > 0.0, "no λ row carried an impulse"


def _hold_inputs(task, cfg, fr, K, H, seed):
    """chip_smoke.py's hold controls for task: K1's V and a K2 target maker."""
    import chip_smoke

    g = torch.Generator().manual_seed(seed)
    V = chip_smoke.hold_controls(task, cfg, g, (K, H, fr.nu)).cuda()
    return V, lambda: chip_smoke.hold_controls(task, cfg, g, (fr.nu,)).cuda()


def _world_steps(fw, built, st, tgt_of, n, device="cuda"):
    rows = fw.pack(st).contiguous()
    rows_p = rows.clone()
    ones_b = torch.ones(built.scene.nbody, device=device)
    ones_g = torch.ones(built.scene.ngeom, device=device)
    for _ in range(n):
        tgt = tgt_of()
        rows = fw.step_rows(rows, tgt, ones_b, ones_g)
        rows_p = fw.plain(rows_p, tgt, ones_b, ones_g)
    if device == "cuda":
        torch.cuda.synchronize()
    return rows, rows_p


def _initial_hold(key, cfg, obj, bound, K, seed, settle=0):
    """K1 (K samples, the conf's H and rollout settings) and K2 over 5 world
    steps from the conf's initial state (after `settle` world steps with
    zero dof targets, when given), with chip_smoke.py's hold controls for
    `key`, against their plain versions within `bound` (K2: the largest of
    its row groups)."""
    import chip_smoke

    world = Simulation(cfg.isaacgym, cfg.actors, cfg.initial_actor_positions, device="cuda")
    built = world.built
    H = cfg.mppi.horizon
    fr = chip_smoke.rollout_for(cfg, obj, built, world.engine, K)
    V, u_of = _hold_inputs(key, cfg, fr, K, H, seed=seed)
    st = world.state.map(lambda x: x[0])
    if settle:
        fw = FusedWorldStep(built, world.engine, impulse_sweeps=cfg.isaacgym.fused_world_sweeps)
        params = ModelParams(torch.ones(built.scene.nbody, device="cuda"),
                             torch.ones(built.scene.ngeom, device="cuda"))
        for _ in range(settle):
            st = fw.step(st.replace(dof_target=torch.zeros_like(st.q)), params)
    pm = ModelParams(torch.ones(K, built.scene.nbody, device="cuda"),
                     torch.ones(K, built.scene.ngeom, device="cuda"))
    inputs = fr.pack(broadcast_state(st, K), pm, V)
    n0 = FusedRollout.launches
    costs, vis = fr.run(*inputs)
    torch.cuda.synchronize()
    assert FusedRollout.launches == n0 + 1
    costs_p, vis_p = fr.plain(*inputs)
    if "k1_first" in bound:
        # a sensitive state (chip_smoke.py hold_k1s): held at the first step
        # and by the median over samples of each sample's largest difference
        d, dv = (costs - costs_p).abs(), (vis - vis_p).abs()
        assert float(d[:, 0].max()) <= bound["k1_first"]
        assert float(d.max(1).values.median()) <= bound["k1_median"]
        assert max(float(dv[0].max()), float(dv.amax(dim=(0, 2)).median())) <= VIS_ATOL
    else:
        torch.testing.assert_close(costs, costs_p, rtol=0.0, atol=bound["k1_max"])
        torch.testing.assert_close(vis, vis_p, rtol=0.0, atol=VIS_ATOL)
    fw = FusedWorldStep(built, world.engine, impulse_sweeps=cfg.isaacgym.fused_world_sweeps)
    rows, rows_p = _world_steps(
        fw, built, st, lambda: built.cmd_map.apply(u_of()[None], st.q[None])[0].contiguous(), 5)
    torch.testing.assert_close(rows, rows_p, rtol=0.0,
                               atol=max(bound["pose"], bound["vel"], bound["lam"]))
    assert float(rows_p[13 * fw.ks.nactor + fw.ks.ndof: fw.ks.n_state_rows].abs().max()) > 0.0


@pytest.mark.parametrize("task,K", [("panda_effort", None), ("omni_panda_pick", 128)])
def test_effort_task_kernels_match_plain(panda, task, K):
    """K1 and K2 at the effort-driven configs from their initial states:
    panda_effort (K=500, H=8, 7 effort joints) and omni_panda_pick (H=6, 8
    sweeps, the base and arm effort-driven, the fingers with the motor
    curve; K1 at 128 samples to keep the plain version short). Bounds:
    chip_smoke.py EFFORT_BOUNDS / OMNI_BOUNDS["initial"]."""
    import chip_smoke
    from mppiisaac_tpu_torch.tasks.omni_panda_pick import OmniPandaPickObjective

    cfg = load_config(f"tasks/{task}")
    obj = (PandaReachObjective(cfg, "panda_link7") if task == "panda_effort"
           else OmniPandaPickObjective(cfg))
    bound = (chip_smoke.EFFORT_BOUNDS if task == "panda_effort" else chip_smoke.OMNI_BOUNDS)["initial"]
    _initial_hold(task, cfg, obj, bound, K or cfg.mppi.num_samples, seed=9)


@pytest.mark.parametrize("key", ["point_robot", "point_robot_obst1", "multi_pointbot"])
def test_point_kernels_match_plain(panda, key):
    """K1 (all samples) and K2 at the point-robot paths' shipped configs from
    their initial states: the TASK_POINT_ROBOT hook, with the obstacle term
    for point_robot_obst1, and TASK_MULTI_ROBOT. Bounds: chip_smoke.py
    POINT_BOUNDS[key]["initial"]."""
    import chip_smoke

    cfg, obj, _ = chip_smoke.point_config(key)
    _initial_hold(key, cfg, obj, chip_smoke.POINT_BOUNDS[key]["initial"], cfg.mppi.num_samples,
                  seed=11)


@pytest.mark.parametrize("task", ["multi_jackal", "albert", "anymal"])
def test_mesh_robot_kernels_match_plain(panda, task):
    """K1 (128 samples) and K2 at the mesh-fitted robots' shipped configs:
    multi_jackal and albert from their initial states (resting on the
    wheels: the mesh-fitted stiction blocks), anymal after LANDED_STEP world
    steps from its drop start with zero velocity targets (TASK_ANYMAL's
    height terms live). Bounds: chip_smoke.py MESH_BOUNDS[task]["initial"],
    ANYMAL_BOUNDS["landed"]."""
    import chip_smoke
    from mppiisaac_tpu_torch.tasks import albert, anymal, multi_robot

    cfg = load_config(f"tasks/{task}")
    obj = {"multi_jackal": multi_robot.MultiJackalObjective, "albert": albert.AlbertObjective,
           "anymal": anymal.AnymalObjective}[task](cfg)
    if task == "anymal":
        _initial_hold(task, cfg, obj, chip_smoke.ANYMAL_BOUNDS["landed"], 128, seed=13,
                      settle=chip_smoke.LANDED_STEP)
    else:
        _initial_hold(task, cfg, obj, chip_smoke.MESH_BOUNDS[task]["initial"], 128, seed=13)


def test_pick_fast_rollout_kernel_matches_plain(pick):
    """K1 at fast fidelity with the reduced manifold (no λ rows, 8-sample
    box–box tables) at the pick config from the settled block. Bound:
    chip_smoke.py FAST_PICK_BOUNDS["settled block"]."""
    import chip_smoke

    _, world, _, st = pick
    cfg = load_config("tasks/panda_pick", chip_smoke.FAST_OVERRIDES)
    built = world.built
    K, H = cfg.mppi.num_samples, cfg.mppi.horizon
    fr = chip_smoke.rollout_for(cfg, PandaPickObjective(cfg), built, world.engine)
    assert not fr.world_fidelity and fr.tables.bbc_samples == 8
    V, _ = _hold_inputs("panda_pick_fast", cfg, fr, K, H, seed=14)
    pm = ModelParams(torch.ones(K, built.scene.nbody, device="cuda"),
                     torch.ones(K, built.scene.ngeom, device="cuda"))
    inputs = fr.pack(broadcast_state(st, K), pm, V)
    assert inputs[0].shape[0] == fr.ks.n_state_rows
    n0 = FusedRollout.launches
    costs, vis = fr.run(*inputs)
    torch.cuda.synchronize()
    assert FusedRollout.launches == n0 + 1
    costs_p, vis_p = fr.plain(*inputs)
    bound = chip_smoke.FAST_PICK_BOUNDS["settled block"]["k1_max"]
    torch.testing.assert_close(costs, costs_p, rtol=0.0, atol=bound)
    torch.testing.assert_close(vis, vis_p, rtol=0.0, atol=VIS_ATOL)


def test_box_pair_full_manifold_kernels_match_plain(panda):
    """K1 (K=256, H=12, world fidelity, the λ rows of 52 bbA/bbB candidates)
    and K2 over 5 world steps on chip_smoke.py's box pair from the sliding
    state. Bounds: chip_smoke.py BOX_BOUNDS["sliding"]."""
    import chip_smoke

    cfg, obj, built, engine, st = chip_smoke.box_pair_scene("cuda")
    K, H = cfg.mppi.num_samples, cfg.mppi.horizon
    fr = chip_smoke.rollout_for(cfg, obj, built, engine)
    assert fr.ks.n_fc == 16 + 52
    V, u_of = _hold_inputs("box_pair", cfg, fr, K, H, seed=15)
    pm = ModelParams(torch.ones(K, built.scene.nbody, device="cuda"),
                     torch.ones(K, built.scene.ngeom, device="cuda"))
    inputs = fr.pack(broadcast_state(st, K), pm, V)
    costs, vis = fr.run(*inputs)
    torch.cuda.synchronize()
    costs_p, vis_p = fr.plain(*inputs)
    bound = chip_smoke.BOX_BOUNDS["sliding"]
    torch.testing.assert_close(costs, costs_p, rtol=0.0, atol=bound["k1_max"])
    torch.testing.assert_close(vis, vis_p, rtol=0.0, atol=VIS_ATOL)
    fw = FusedWorldStep(built, engine, impulse_sweeps=cfg.isaacgym.fused_world_sweeps)
    rows, rows_p = _world_steps(
        fw, built, st, lambda: built.cmd_map.apply(u_of()[None], st.q[None])[0].contiguous(), 5)
    torch.testing.assert_close(rows, rows_p, rtol=0.0,
                               atol=max(bound["pose"], bound["vel"], bound["lam"]))
    assert float(rows_p[fw.ks.n_state_rows:].abs().max()) > 0.0, "no λ row carried an impulse"


def _gripper_scene(effort, device="cuda"):
    """The mini-gripper with effort fingers holding a ball (effort=True), or
    with 1 kg velocity-driven fingers closing on a fixed post (the finger
    force gate; no shipped conf has velocity fingers)."""
    from mppiisaac_tpu_torch.physics.model import DRIVE_VELOCITY
    from mppiisaac_tpu_torch.physics.step import Engine
    from mppiisaac_tpu_torch.scene.actor import ActorSpec
    from mppiisaac_tpu_torch.scene.builder import SimConfig, build_scene

    gripper = dict(type="robot", name="mini_gripper", fixed=True, init_pos=[0.0, 0.0, 0.5])
    if effort:
        other = ActorSpec(type="sphere", name="ball", size=[0.02], mass=0.005,
                          init_pos=[0.0, 0.0, 0.53], friction=1.0)
        gripper["dof_mode"] = "effort"
    else:
        other = ActorSpec(type="box", name="post", size=[0.04, 0.04, 0.04], fixed=True,
                          init_pos=[0.0, 0.0, 0.53])
    built = build_scene([ActorSpec(**gripper), other], SimConfig(dt=0.05, substeps=2))
    if not effort:
        art = built.scene.actors[0]
        art.drive_mode[:] = DRIVE_VELOCITY
        art.drive_kp[:] = 0.0
        art.drive_kd[:] = 600.0
        art.mass[1:] = 1.0
    engine = Engine(built.scene)
    st = built.initial_state(engine, device)
    st = engine.refresh(st.replace(q=torch.full_like(st.q, 0.025 if effort else 0.03)))
    return built, engine, st


# The effort gripper's K1 hold is a sensitive state, as pick's held grasp:
# efforts of ±6 N juggle the 5 g ball, and its plain version in float32 and
# float64 part by up to 0.15 in cost (costs up to 1.4) in about a tenth of
# the (sample, step) pairs. It is held at the first step and by the median
# over samples of each sample's largest difference, at 10× that drift or
# more, which tests/test_torch_effort.py measures on the CPU
# (test_effort_gripper_bounds_cover_float64_drift).
GRIPPER_K1_FIRST, GRIPPER_K1_MEDIAN = COST_TOL, 4e-4


def effort_gripper_hold(device):
    """The effort fingers' hold: K2 squeezing the ball with 3 N for 5 world
    steps from the touching grasp (kernel and plain version; on the CPU both
    are the plain version), then K1's packed inputs at K=256, H=6 with
    efforts over ±6 N from the state the kernel reached. → (built, fw, rows,
    rows_p, fr, K1 inputs)."""
    from mppiisaac_tpu_torch.ops import fused_physics as tfp

    built, engine, st = _gripper_scene(effort=True, device=device)
    fw = FusedWorldStep(built, engine)
    tgt = torch.full((2,), -3.0, device=device)
    rows, rows_p = _world_steps(fw, built, st, lambda: tgt, 5, device=device)
    ball = built.scene.actor_index("ball")
    spec = tfp.CostSpec(task=tfp.TASK_PANDA_PICK, ee_body=built.scene.body_offset[ball] - 1,
                        goal_actor=0, w_dist=1.0, w_ori=0.5, block_actor=ball,
                        force_body0=built.scene.body_offset[ball], force_nbody=1, w_block=2.0,
                        w_force=0.01)
    K, H = 256, 6
    fr = FusedRollout(built, engine, spec, H, K, vis_body=built.scene.body_offset[ball])
    A, D, NS = fw.ks.nactor, fw.ks.ndof, fw.ks.n_state_rows
    held = st.with_root_state(rows[:13 * A].reshape(A, 13)).replace(
        q=rows[13 * A:13 * A + D], qd=rows[13 * A + D:13 * A + 2 * D])
    lam = held.contact_lam.clone()
    lam[torch.as_tensor(fw.fc_idx, device=device)] = rows[NS:].reshape(-1, 4)
    held = held.replace(contact_lam=lam)
    g = torch.Generator().manual_seed(10)
    V = (torch.rand(K, H, fr.nu, generator=g) * 12 - 6).to(device)
    pm = ModelParams(torch.ones(K, built.scene.nbody, device=device),
                     torch.ones(K, built.scene.ngeom, device=device))
    return built, fw, rows, rows_p, fr, fr.pack(broadcast_state(held, K), pm, V)


def test_effort_gripper_kernels_match_plain(panda):
    """The effort fingers' motor curve and spindle stiction: K2 squeezing the
    ball with 3 N for 5 steps, then K1 (K=256, H=6) from the held grasp."""
    built, fw, rows, rows_p, fr, inputs = effort_gripper_hold("cuda")
    assert fw.ks.dof_motor.tolist() == [1, 1]
    torch.testing.assert_close(rows, rows_p, rtol=STATE_TOL, atol=STATE_TOL)
    ball = built.scene.actor_index("ball")
    assert float(rows[13 * ball + 2]) > 0.5, "the ball fell out of the grasp"
    costs, vis = fr.run(*inputs)
    torch.cuda.synchronize()
    costs_p, vis_p = fr.plain(*inputs)
    d = (costs - costs_p).abs()
    assert float(d[:, 0].max()) <= GRIPPER_K1_FIRST
    assert float(d.max(1).values.median()) <= GRIPPER_K1_MEDIAN
    dv = (vis.float() - vis_p.float()).abs()
    assert float(dv[0].max()) <= VIS_ATOL and float(dv.amax(dim=(0, 2)).median()) <= VIS_ATOL


def test_finger_gate_world_step_kernel_matches_plain(panda):
    """Velocity fingers closing on a post at -0.2 m/s: a finger's net contact
    force passes grip_force_gate and the gate zeroes its closing target."""
    built, engine, st = _gripper_scene(effort=False)
    fw = FusedWorldStep(built, engine)
    fingers = [built.scene.body_index("finger1"), built.scene.body_index("finger2")]
    assert fw.ks.dof_gate_body.tolist() == fingers
    tgt = torch.full((2,), -0.2, device="cuda")
    rows, rows_p = _world_steps(fw, built, st, lambda: tgt, 4)
    torch.testing.assert_close(rows, rows_p, rtol=STATE_TOL, atol=STATE_TOL)
    A, D, NS = fw.ks.nactor, fw.ks.ndof, fw.ks.n_state_rows
    ncf = rows_p[13 * A + 2 * D: NS].reshape(-1, 3)
    assert float(ncf[fingers].norm(dim=-1).max()) > built.scene.grip_force_gate


def test_rollout_launch_replays_from_a_cuda_graph(panda):
    """K1 at the panda config (52 KB of shared memory per block, so every
    launch sets the kernel's shared-memory attribute): captured once after a
    warm-up launch, a replay gives the eager launch's costs and vis bit for
    bit."""
    cfg, world = panda
    built = world.built
    K, H = cfg.mppi.num_samples, cfg.mppi.horizon
    fr = FusedRollout(built, world.engine, PandaReachObjective(cfg).kernel_cost(built), H, K,
                      vis_body=built.visualize_bodies[0])
    g = torch.Generator().manual_seed(3)
    V = (torch.rand(K, H, fr.nu, generator=g) * 4 - 2).cuda()
    st = broadcast_state(world.state.map(lambda x: x[0]), K)
    pm = ModelParams(torch.ones(K, built.scene.nbody, device="cuda"),
                     torch.ones(K, built.scene.ngeom, device="cuda"))
    inputs = fr.pack(st, pm, V)
    costs0, vis0 = fr.run(*inputs)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        costs, vis = fr.run(*inputs)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(costs, costs0) and torch.equal(vis, vis0)


@pytest.mark.parametrize("task", ["panda", "panda_pick"])
def test_chunk_equals_the_per_step_loop(panda, task):
    """`run_task` at device_steps=4 (one captured control step, replayed)
    against the per-step loop over 8 steps at the shipped config: world
    states bit for bit, K1 and K2 once per step, one capture."""
    from mppiisaac_tpu_torch.physics.types import SIM_STATE_FIELDS
    from mppiisaac_tpu_torch.runtime.loop import run_task

    cfg = load_config(f"tasks/{task}")
    obj = (PandaReachObjective if task == "panda" else PandaPickObjective)(cfg)
    runs = {}
    for n in (1, 4):
        seen = []

        def record(w, seen=seen):
            seen.append(w.state.map(lambda x: x.detach().cpu().clone()))
            return False

        FusedRollout.launches = FusedWorldStep.launches = 0
        m = run_task(cfg, obj, n_steps=8, success_fn=record, device="cuda", device_steps=n)
        torch.cuda.synchronize()
        assert (FusedRollout.launches, FusedWorldStep.launches) == (8, 8), n
        assert m.steps == m.commands == 8
        runs[n] = seen
    for i, (a, b) in enumerate(zip(runs[1], runs[4])):
        for f in SIM_STATE_FIELDS:
            if getattr(a, f) is not None:
                assert torch.equal(getattr(a, f), getattr(b, f)), (i, f)


def test_chunk_capture_under_the_profiler_takes_no_span(panda):
    """A chunk whose graph is captured under torch.profiler: the capture is
    one `chunk.capture` span, whose only world step is the warm-up's (no
    span enters the capture), the next chunk replays; the spans' marks on
    the device's timeline are user annotations, which `device_time` leaves
    out; the actions equal an unprofiled chunk's bit for bit."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    from mppiisaac_tpu_torch.planner.mppi_isaac import MPPIisaacPlanner
    from mppiisaac_tpu_torch.runtime.loop import DeviceChunk, goal_world
    from mppiisaac_tpu_torch.utils import profiling

    cfg = load_config("tasks/panda")
    runs = []
    for profiled in (True, False):
        world = goal_world(cfg, "cuda")
        planner = MPPIisaacPlanner(cfg, PandaReachObjective(cfg), device="cuda")
        chunk = DeviceChunk(world, planner, 4)
        profiling.clear()
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        with prof if profiled else contextlib.nullcontext():
            actions = np.concatenate([chunk.run(4)[1], chunk.run(4)[1]])
            torch.cuda.synchronize()
        runs.append(actions)
        if not profiled:
            assert profiling.spans() == []
            continue
        recs = profiling.spans()
        names = [r.name for r in recs]
        assert chunk.captures == 1 and names.count("chunk.capture") == 1
        cap = names.index("chunk.capture")
        c = recs[cap]
        under = [r.name for r in recs
                 if r.root == c.root and c.start_ns <= r.start_ns and r.end_ns <= c.end_ns]
        assert under.count("world.step") == under.count("k1.launch") == 1
        assert names.count("chunk.replay") == 2
        marks = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.name in set(names)]
        assert marks and all(e.is_user_annotation for e in marks)
        busy, kernels = profiling.device_time(prof.events())
        assert busy > 0 and not set(kernels) & set(names)
    assert np.array_equal(runs[0], runs[1])


def test_chunk_sees_online_changes_on_the_card(panda):
    """On the card, between two chunks: `update_weights` re-packs the tables
    the captured graph reads (no new capture), a changed solver config is
    captured anew, and each next chunk equals the per-step loop under the
    change, bit for bit; a structural `update_mppi_params` makes the old
    chunk raise."""
    from mppiisaac_tpu_torch.planner.mppi_isaac import MPPIisaacPlanner
    from mppiisaac_tpu_torch.runtime.loop import DeviceChunk, goal_world

    cfg = load_config("tasks/panda")
    world = goal_world(cfg, "cuda")
    planner = MPPIisaacPlanner(cfg, PandaReachObjective(cfg), device="cuda")
    chunk = DeviceChunk(world, planner, 4)
    chunk.run(4)
    carry, state = planner.mppi.carry, world.state

    def chunked():
        planner.mppi.carry, world.state = carry, state
        return chunk.run(4)[1]

    def per_step():
        planner.mppi.carry, world.state = carry, state
        acts = []
        for _ in range(4):
            a = planner.compute_action_from_state(world.state)
            world.apply_robot_cmd(a)
            world.step()
            acts.append(a.cpu().numpy())
        return np.stack(acts)

    a0 = chunked()
    assert np.array_equal(a0, per_step()) and chunk.captures == 1
    planner.update_weights({k: 3.0 * v for k, v in planner.objective.weights.items()})
    a1 = chunked()
    assert chunk.captures == 1 and not np.array_equal(a0, a1)
    assert np.array_equal(a1, per_step())
    planner.update_mppi_params({"noise_abs_cost": not cfg.mppi.noise_abs_cost})
    a2 = chunked()
    assert chunk.captures == 2 and not np.array_equal(a1, a2)
    assert np.array_equal(a2, per_step())
    planner.update_mppi_params({"horizon": 10})
    with pytest.raises(RuntimeError, match="rebuilt"):
        chunk.run(4)


def test_chunk_draws_ahead_on_the_card(panda):
    """On the card, three chunks of 4 (12, 8, then 4 steps left): the chunk
    that draws the next chunk's noise while the replays run against one
    that draws each chunk's on the spot, bit for bit (actions, world state,
    key, draw buffer); the second and third chunks use the draws made
    ahead."""
    from mppiisaac_tpu_torch.planner.mppi_isaac import MPPIisaacPlanner
    from mppiisaac_tpu_torch.runtime.loop import DeviceChunk, goal_world

    cfg = load_config("tasks/panda")
    runs = []
    for spot in (False, True):
        world = goal_world(cfg, "cuda")
        planner = MPPIisaacPlanner(cfg, PandaReachObjective(cfg), device="cuda")
        chunk = DeviceChunk(world, planner, 4)
        out = []
        for n_steps in (12, 8, 4):
            if spot:
                chunk._ahead = None
            _, actions = chunk.run(n_steps)
            out.append((actions, world.state.q.cpu(), planner.mppi.carry.key.copy(),
                        chunk._draws.cpu()))
        assert (chunk.draws_ahead_hits, chunk.draws_ahead_misses) == ((0, 3) if spot else (2, 1))
        runs.append(out)
    for (a0, q0, k0, d0), (a1, q1, k1, d1) in zip(*runs):
        assert np.array_equal(a0, a1) and torch.equal(q0, q1)
        assert np.array_equal(k0, k1) and torch.equal(d0, d1)


def test_batched_world_step_kernel_matches_plain_and_one_env(panda):
    """K2 over a grid of N=64 envs of a randomized point robot pushing a
    block (per-env mass, friction and commands; W warps per block) against
    the plain version's batch over 3 steps, and envs 0, 31 and 63 of each
    launch equal the one-env launch on their inputs bit for bit."""
    N = 64
    sim = Simulation(SimConfig(dt=0.05, substeps=1), ["point_robot", "block", "goal"],
                     num_envs=N, randomize=True, seed=3, device="cuda")
    sim.set_actor_position_by_name("block", [0.45, 0.0, 0.1])
    u = np.random.RandomState(1).uniform(-1, 1, (N, 3)).astype(np.float32)
    u[:, 0] = 1.0
    sim.apply_robot_cmd(u)
    fw = sim._world_step
    rows = fw.pack(sim.state).contiguous()
    rows_p = rows.clone()
    tgt = sim.state.dof_target.T.contiguous()
    mass = sim.params.body_mass_scale.T.contiguous()
    fric = sim.params.geom_friction.T.contiguous()
    for _ in range(3):
        n0 = FusedWorldStep.launches
        out = fw.step_rows(rows, tgt, mass, fric)
        assert FusedWorldStep.launches == n0 + 1
        for e in (0, 31, 63):
            one = fw.step_rows(rows[:, e].contiguous(), tgt[:, e].contiguous(),
                               mass[:, e].contiguous(), fric[:, e].contiguous())
            assert torch.equal(one, out[:, e]), e
        rows, rows_p = out, fw.plain(rows_p, tgt, mass, fric)
    torch.cuda.synchronize()
    assert fw.warps(rows.device, N) == 1      # 64 envs spread over the SMs one per block
    torch.testing.assert_close(rows, rows_p, rtol=STATE_TOL, atol=STATE_TOL)
    assert float(rows_p[fw.ks.n_state_rows:].abs().max()) > 0.0, "no λ row carried an impulse"


def test_simulation_steps_every_env_in_one_launch(panda):
    """The balls demo's scene at 1080 envs: each `Simulation.step` is one K2
    launch (8 warps per block, 135 blocks), the envs stay identical and the
    snapshot restores exactly."""
    from mppiisaac_tpu_torch.examples import balls_demo

    sim = balls_demo.balls_sim(1080, 4, device="cuda")
    snap = sim.save_state()
    n0 = FusedWorldStep.launches
    for _ in range(30):
        sim.step()
    torch.cuda.synchronize()
    assert FusedWorldStep.launches == n0 + 30
    assert sim._world_step.warps(sim.device, 1080) == 8
    z = sim.state.root_pos[..., 2]
    torch.testing.assert_close(z, z[:1].expand_as(z), rtol=0.0, atol=1e-4)
    sim.restore_state(snap)
    assert torch.equal(sim.state.root_pos, snap.root_pos)


@pytest.mark.parametrize("case", ["reach", "pick_held_grasp", "balls_1080"])
def test_world_step_body_caches_match_refresh(panda, case):
    """`FusedWorldStep.step` on the card takes the body caches of the stepped
    state from K2's epilogue, with no torch refresh
    (FusedWorldStep.torch_refreshes unchanged): positions, quaternions and
    both velocities within the larger of 1e-5 and 10× the float32 refresh's
    own drift from a float64 refresh of `engine.refresh` on the same state
    (chip_smoke.body_cache_gaps), after 5 steps from panda reach under
    random targets, from pick's held grasp (chip_smoke.HELD_GRASP) with its
    targets, and of the balls demo's 1080 envs after 20 steps."""
    if case == "balls_1080":
        from mppiisaac_tpu_torch.examples import balls_demo

        world = balls_demo.balls_sim(1080, 4, device="cuda")
        st, tgt_of, n = world.state, lambda st: st.dof_target, 20
    elif case == "reach":
        cfg, world = panda
        g = torch.Generator().manual_seed(6)
        st, n = world.state, 5
        tgt_of = (lambda st: (torch.rand(st.q.shape, generator=g) * 4 - 2).cuda())
    else:
        cfg = load_config("tasks/panda_pick")
        world = Simulation(cfg.isaacgym, cfg.actors, cfg.initial_actor_positions, device="cuda")
        path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            chip_smoke.HELD_GRASP)
        held = {k: v.cuda()[None] for k, v in torch.load(path).items() if v is not None}
        st, tgt_of, n = SimState(**held), lambda st: st.dof_target, 5
    fw = world._world_step
    n0 = FusedWorldStep.torch_refreshes
    for _ in range(n):
        st = fw.step(st.replace(dof_target=tgt_of(st)), world.params)
    torch.cuda.synchronize()
    assert FusedWorldStep.torch_refreshes == n0
    gaps = chip_smoke.body_cache_gaps(fw.engine, st)
    assert all(e <= b for e, b in gaps.values()), gaps
    assert float(st.body_linvel.abs().max()) > 0.0, "nothing moved"


def test_unfused_command_replays_from_a_cuda_graph(panda):
    """The unfused command (Engine.step over H × substeps, the objective's
    compute_cost, the MPPI update) at K=64, H=4 from the panda state:
    captured once as a CUDA graph after a warm-up on a side stream, a replay
    gives the eager command's action and costs bit for bit; and run_task
    with use_fused=False at device_steps=4 equals the per-step loop over 4
    steps, K2 once per step and K1 never."""
    from mppiisaac_tpu_torch.physics.types import SIM_STATE_FIELDS
    from mppiisaac_tpu_torch.planner.mppi_isaac import MPPIisaacPlanner
    from mppiisaac_tpu_torch.runtime.loop import run_task

    cfg = load_config("tasks/panda", ["mppi.num_samples=64", "mppi.horizon=4"])
    world = panda[1]
    planner = MPPIisaacPlanner(cfg, PandaReachObjective(cfg), device="cuda", use_fused=False)
    assert planner.mppi.fused is None
    planner.reset_rollout_from_state(world.state)
    carry = planner.mppi.carry
    _, d = planner.mppi.draws(carry.key, 1)
    draw = torch.as_tensor(d[0], device="cuda")
    state0 = (planner.sim.state, planner._params_K)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        a0, _, i0 = planner.mppi._command_impl(carry, state0, draw=draw)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        a, _, info = planner.mppi._command_impl(carry, state0, draw=draw)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(a, a0) and torch.equal(info["costs"], i0["costs"])
    assert torch.isfinite(a).all() and a.abs().max() > 1e-3

    runs = {}
    for n in (1, 4):
        seen = []

        def record(w, seen=seen):
            seen.append(w.state.map(lambda x: x.detach().cpu().clone()))
            return False

        FusedRollout.launches = FusedWorldStep.launches = 0
        m = run_task(cfg, PandaReachObjective(cfg), n_steps=4, success_fn=record, device="cuda",
                     device_steps=n, use_fused=False)
        torch.cuda.synchronize()
        assert (FusedRollout.launches, FusedWorldStep.launches) == (0, 4), n
        runs[n] = seen
    for i, (x, y) in enumerate(zip(runs[1], runs[4])):
        for f in SIM_STATE_FIELDS:
            if getattr(x, f) is not None:
                assert torch.equal(getattr(x, f), getattr(y, f)), (i, f)


def _gripper_beside_far_ball(dev):
    """The mini-gripper closed on its ball beside a far ball (whose blocks
    the gate turns off), its cost, and K1's inputs from the grasp."""
    from mppiisaac_tpu_torch.ops import fused_physics as tfp
    from mppiisaac_tpu_torch.physics.step import Engine
    from mppiisaac_tpu_torch.scene.actor import ActorSpec
    from mppiisaac_tpu_torch.scene.builder import build_scene

    built = build_scene([
        ActorSpec(type="robot", name="mini_gripper", fixed=True, gripper_binarize=True,
                  init_pos=[0.0, 0.0, 0.5]),
        ActorSpec(type="sphere", name="ball", size=[0.02], mass=0.005, init_pos=[0.0, 0.0, 0.53],
                  friction=1.0),
        ActorSpec(type="sphere", name="far_ball", size=[0.05], mass=0.1, init_pos=[5.0, 5.0, 0.05],
                  friction=0.5)], SimConfig(dt=0.05, substeps=2))
    engine = Engine(built.scene)
    st = built.initial_state(engine, dev)
    st = engine.refresh(st.replace(q=torch.full_like(st.q, 0.034)))
    ball = built.scene.actor_index("ball")
    spec = tfp.CostSpec(task=tfp.TASK_PANDA_PICK, ee_body=built.scene.body_offset[ball] - 1,
                        goal_actor=0, w_dist=1.0, w_ori=0.5, block_actor=ball,
                        force_body0=built.scene.body_offset[ball], force_nbody=1, w_block=2.0,
                        w_force=0.01)
    return built, engine, st, spec


ABLATED = {4: {"zero_cost": True}, 1: {"skip_contacts": True},
           7: {"skip_contacts": True, "skip_dynamics": True, "zero_cost": True},
           8: {"two_way_sweeps": False}, 16: {"broadphase_gate": False}}


def test_ablation_variants_build_launch_and_match_plain(panda):
    """Every instantiated mask of the ablation library (ops/native.py
    ABLATE) launches, is counted per mask, and agrees with its ablated plain
    version; the gate off is bit for bit the default kernels."""
    from mppiisaac_tpu_torch.ops import fused_rollout as fro

    built, engine, st, spec = _gripper_beside_far_ball("cuda")
    K, H = 64, 4
    g = torch.Generator().manual_seed(12)
    V = (torch.rand(K, H, 2, generator=g) * 2 - 1).cuda()
    pm = ModelParams(torch.ones(K, built.scene.nbody, device="cuda"),
                     torch.ones(K, built.scene.ngeom, device="cuda"))
    ref = FusedRollout(built, engine, spec, H, K)
    inputs = ref.pack(broadcast_state(st, K), pm, V)
    c_ref, v_ref = ref.run(*inputs)
    FusedRollout.ablated_launches.clear()
    for mask in fro.K1_MASKS:
        fr = FusedRollout(built, engine, spec, H, K, profile=ABLATED[mask])
        inp = inputs
        if mask == 7:      # fkonly keeps every dof: only the roots' drift reaches its output
            sK = broadcast_state(st, K)
            sK = sK.replace(root_linvel=(torch.rand(sK.root_linvel.shape, generator=g) - 0.5).cuda())
            inp = fr.pack(sK, pm, V)
        costs, vis = fr.run(*inp)
        torch.cuda.synchronize()
        costs_p, vis_p = fr.plain(*inp)
        torch.testing.assert_close(costs, costs_p, rtol=COST_TOL, atol=COST_TOL)
        if fr.profile["zero_cost"]:      # vis: the sum of the roots, unrounded
            torch.testing.assert_close(vis, vis_p, rtol=COST_TOL, atol=COST_TOL)
        else:
            torch.testing.assert_close(vis, vis_p, rtol=0.0, atol=VIS_ATOL)
        if mask == 7:
            assert float((vis[-1] - sK.root_pos.sum(1)).abs().max()) > 10 * COST_TOL
        if mask == 16:
            assert torch.equal(costs, c_ref) and torch.equal(vis, v_ref)
    assert FusedRollout.ablated_launches == {m: 1 for m in fro.K1_MASKS}
    ones_b = torch.ones(built.scene.nbody, device="cuda")
    ones_g = torch.ones(built.scene.ngeom, device="cuda")
    tgt = built.cmd_map.apply(torch.full((2,), -1.0, device="cuda"), st.q)
    w_ref = FusedWorldStep(built, engine)
    r_ref = w_ref.pack(st).contiguous()
    for _ in range(3):
        r_ref = w_ref.step_rows(r_ref, tgt, ones_b, ones_g)
    for mask in fro.K2_MASKS:
        fw = FusedWorldStep(built, engine, profile=ABLATED[mask])
        rows = rows_p = fw.pack(st).contiguous()
        for _ in range(3):
            rows, rows_p = fw.step_rows(rows, tgt, ones_b, ones_g), fw.plain(rows_p, tgt, ones_b, ones_g)
        torch.cuda.synchronize()
        torch.testing.assert_close(rows, rows_p, rtol=STATE_TOL, atol=STATE_TOL)
        if mask == 16:
            assert torch.equal(rows, r_ref)


def test_ablation_masks_not_instantiated_raise(panda):
    built, engine, st, spec = _gripper_beside_far_ball("cuda")
    fr = FusedRollout(built, engine, spec, 2, 8, profile={"skip_dynamics": True})
    pm = ModelParams(torch.ones(8, built.scene.nbody, device="cuda"),
                     torch.ones(8, built.scene.ngeom, device="cuda"))
    inputs = fr.pack(broadcast_state(st, 8), pm, torch.zeros(8, 2, 2, device="cuda"))
    with pytest.raises(NotImplementedError):
        fr.run(*inputs)
