"""The CUDA kernels against their plain PyTorch versions on the card, at the
shapes of the panda reach and panda pick main paths, and on the mini-gripper
grasp scene. Marked `cuda`: they skip without an
NVIDIA GPU and run on the card (whose machine has no JAX, which
tests/conftest.py imports) with

    python -m pytest tests/test_torch_cuda.py -m cuda -p no:cacheprovider --noconftest
"""
import pytest
import torch

from mppiisaac_tpu_torch.ops.fused_rollout import FusedRollout, FusedWorldStep
from mppiisaac_tpu_torch.physics.types import ModelParams
from mppiisaac_tpu_torch.runtime.sim import Simulation, broadcast_state
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
