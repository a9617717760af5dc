"""The CUDA device code of csrc/fused_rollout.cu run on the CPU, against the
kernels' plain versions.

g++ (C++20) compiles the kernels with the stub CUDA headers of
csrc/emu/ (each block one warp of 32 std::threads, __syncwarp a
std::barrier, the shuffles through an exchange array) and csrc/emu/launch.cpp
into a library in a temporary directory; the tests run K1 (one warp per
sample, block by block) and K2 through it on panda reach (K=4, H=2), on the
boxer of boxer_push resting on its wheels, on pick's block settled on the
table, on the mini-gripper holding a ball (the couple contacts) and at the
stick's first touch of the block in the panda_stick_push loop, and hold
them against `FusedRollout.plain` / `FusedWorldStep.plain`
with the tolerances of tests/test_torch_cuda.py (chip_smoke.py's bounds for
the boxer, the settled block and the stick's touch). The build decides inside the fixture
whether g++ is there, and skips without it. No kernel wrapper loads this
library: on the card they launch the nvcc build, on the CPU they run the
plain versions.

Also, without g++: the lane orders and the per-warp layout that
`pack_tables` appends to the scene tables, and the launch geometry of every
shipped config at its K.
"""
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from mppiisaac_tpu_torch.ops import fused_physics as tfp
from mppiisaac_tpu_torch.ops import fused_rollout as fro
from mppiisaac_tpu_torch.ops.fused_rollout import FusedRollout, FusedWorldStep
from mppiisaac_tpu_torch.physics.types import ModelParams, SimState
from mppiisaac_tpu_torch.runtime.sim import Simulation, broadcast_state
from mppiisaac_tpu_torch.tasks.mobile_push import MobilePushObjective
from mppiisaac_tpu_torch.tasks.panda_pick import PandaPickObjective
from mppiisaac_tpu_torch.tasks.panda_reach import PandaReachObjective
from mppiisaac_tpu_torch.tasks.panda_stick_push import PandaStickPushObjective
from mppiisaac_tpu_torch.utils.config_store import load_config

torch.set_num_threads(1)
EMU = os.path.join(os.path.dirname(fro.__file__), os.pardir, "csrc", "emu")
K, H = 4, 2
# tests/test_torch_cuda.py
COST_TOL = STATE_TOL = 1e-4
VIS_ATOL = 1e-2
PICK_COST_ATOL, PICK_STATE_ATOL = 5e-4, 2e-3
# the stick's first touch of the block in chip_smoke.py phase 11's
# panda_stick_push loop on the card (step 73), as that run saved it
STICK_TOUCH = os.path.join(os.path.dirname(__file__), "data", "panda_stick_push_first_touch.pt")
N_TOUCH = 32
SHIPPED = ("panda", "panda_pick", "boxer_push", "boxer_reach", "heijn_push", "heijn_reach",
           "point_robot", "multi_pointbot", "panda_effort", "panda_stick_push", "omni_panda_pick",
           "multi_jackal", "albert", "anymal")


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ with C++20 to build the CPU emulation of the device code")
    out = str(tmp_path_factory.mktemp("emu") / "libfused_emu.so")
    proc = subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-I", EMU,
                           "-o", out, os.path.join(EMU, "launch.cpp")],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(out)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.emu_rollout.argtypes = [P] * 7 + [I, I, I, F, I, I, I]
    lib.emu_world_step.argtypes = [P] * 6 + [I, F, I, I]
    assert lib.emu_scene_tables_size() == ctypes.sizeof(fro._SceneTablesC)
    return lib


def _bytes(tables):
    return np.frombuffer(tables._bytes, np.uint8).copy()


def emu_rollout(lib, fr, rows, V, mass, fric):
    costs = torch.empty(fr.K, fr.H)
    vis = torch.empty(fr.H, fr.K, 3)
    tb = _bytes(fr._tables)
    rc = lib.emu_rollout(tb.ctypes.data, rows.data_ptr(), V.data_ptr(), mass.data_ptr(),
                         fric.data_ptr(), costs.data_ptr(), vis.data_ptr(), fr.K, fr.H,
                         fr.substeps, fr.dt_sub, fr.impulse_sweeps, int(fr.world_fidelity),
                         fr.warp_bytes)
    assert rc == 0
    return costs, vis


def emu_world_steps(lib, fw, built, st, tgt_of, n):
    """n world steps of the emulated K2 and of its plain version."""
    tb = _bytes(fw._tables)
    rows = fw.pack(st).contiguous()
    rows_p = rows.clone()
    ones_b, ones_g = torch.ones(built.scene.nbody), torch.ones(built.scene.ngeom)
    for _ in range(n):
        tgt = tgt_of().contiguous()
        out = torch.empty_like(rows)
        assert lib.emu_world_step(tb.ctypes.data, rows.data_ptr(), tgt.data_ptr(),
                                  ones_b.data_ptr(), ones_g.data_ptr(), out.data_ptr(),
                                  fw.substeps, fw.dt_sub, fw.impulse_sweeps, fw.warp_bytes) == 0
        rows = out
        rows_p = fw.plain(rows_p, tgt, ones_b, ones_g)
    return rows, rows_p


def world(task):
    cfg = load_config(f"tasks/{task}")
    return cfg, Simulation(cfg.isaacgym, cfg.actors, cfg.initial_actor_positions, device="cpu")


def rollout_inputs(cfg, w, obj, st, seed, amp):
    b = w.built
    fr = FusedRollout(b, w.engine, obj.kernel_cost(b), H, K, vis_body=b.visualize_bodies[0],
                      impulse_sweeps=cfg.mppi.rollout_sweeps)
    g = torch.Generator().manual_seed(seed)
    V = torch.rand(K, H, fr.nu, generator=g) * 2 * amp - amp
    pm = ModelParams(torch.ones(K, b.scene.nbody), torch.ones(K, b.scene.ngeom))
    return fr, fr.pack(broadcast_state(st, K), pm, V)


def test_panda_reach_kernels_match_plain(emu):
    cfg, w = world("panda")
    st = w.state.map(lambda x: x[0])
    fr, inputs = rollout_inputs(cfg, w, PandaReachObjective(cfg), st, 1, 2.0)
    costs, vis = emu_rollout(emu, fr, *inputs)
    costs_p, vis_p = fr.plain(*inputs)
    torch.testing.assert_close(costs, costs_p, rtol=COST_TOL, atol=COST_TOL)
    torch.testing.assert_close(vis, vis_p, rtol=0.0, atol=VIS_ATOL)
    fw = FusedWorldStep(w.built, w.engine)
    g = torch.Generator().manual_seed(2)
    rows, rows_p = emu_world_steps(emu, fw, w.built, st,
                                   lambda: torch.rand(w.built.scene.ndof, generator=g) * 4 - 2, 3)
    torch.testing.assert_close(rows, rows_p, rtol=STATE_TOL, atol=STATE_TOL)


def test_resting_boxer_kernels_match_plain(emu):
    cfg, w = world("boxer_push")
    st = w.state.map(lambda x: x[0])
    fr, inputs = rollout_inputs(cfg, w, MobilePushObjective(cfg, "boxer", "ee_link"), st, 7, 1.0)
    costs, vis = emu_rollout(emu, fr, *inputs)
    costs_p, vis_p = fr.plain(*inputs)
    b = chip_smoke.BOXER_BOUNDS["initial"]
    torch.testing.assert_close(costs, costs_p, rtol=0.0, atol=b["k1_max"])
    torch.testing.assert_close(vis, vis_p, rtol=0.0, atol=VIS_ATOL)
    fw = FusedWorldStep(w.built, w.engine, impulse_sweeps=cfg.isaacgym.fused_world_sweeps)
    g = torch.Generator().manual_seed(8)

    def tgt():
        u = torch.rand(fw.ks.nu, generator=g) * 2 - 1
        return w.built.cmd_map.apply(u[None], st.q[None])[0]

    rows, rows_p = emu_world_steps(emu, fw, w.built, st, tgt, 2)
    torch.testing.assert_close(rows, rows_p, rtol=0.0, atol=max(b["pose"], b["vel"], b["lam"]))
    assert float(rows_p[fw.ks.n_state_rows:].abs().max()) > 0.0, "no λ row carried an impulse"


def test_pick_settled_block_kernels_match_plain(emu):
    cfg, w = world("panda_pick")
    fw = FusedWorldStep(w.built, w.engine, impulse_sweeps=cfg.isaacgym.fused_world_sweeps)
    params = ModelParams(torch.ones(w.scene.nbody), torch.ones(w.scene.ngeom))
    st = w.state.map(lambda x: x[0])
    hold = st.q.clone()
    for _ in range(chip_smoke.SETTLE_STEPS):   # the block falls and settles on the table
        st = fw.step(st.replace(dof_target=hold), params)
    fr, inputs = rollout_inputs(cfg, w, PandaPickObjective(cfg), st, 4, 0.3)
    costs, vis = emu_rollout(emu, fr, *inputs)
    costs_p, vis_p = fr.plain(*inputs)
    torch.testing.assert_close(costs, costs_p, rtol=0.0, atol=PICK_COST_ATOL)
    torch.testing.assert_close(vis, vis_p, rtol=0.0, atol=VIS_ATOL)
    g = torch.Generator().manual_seed(5)
    rows, rows_p = emu_world_steps(
        emu, fw, w.built, st, lambda: st.q + torch.rand(w.scene.ndof, generator=g) * 0.4 - 0.2, 2)
    torch.testing.assert_close(rows, rows_p, rtol=0.0, atol=PICK_STATE_ATOL)
    assert float(rows_p[fw.ks.n_state_rows:].abs().max()) > 0.0, "no λ row carried an impulse"


def test_grasp_scene_kernels_match_plain(emu):
    """The mini-gripper closing on a ball and holding it (tests/test_torch_cuda.py's
    grasp scene): couple terms, Ψ, two-way sweeps, λ warm start and snap live;
    K2 for 5 steps, then K1 from the held grasp."""
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
    st = built.initial_state(engine, "cpu")
    st = engine.refresh(st.replace(q=torch.full_like(st.q, 0.034)))
    tgt = built.cmd_map.apply(torch.full((2,), -1.0), st.q)
    rows, rows_p = emu_world_steps(emu, fw, built, st, lambda: tgt, 5)
    torch.testing.assert_close(rows, rows_p, rtol=STATE_TOL, atol=STATE_TOL)
    ks = fw.ks
    couple = [bi for bi in range(ks.nblk) if int(ks.blk_flags[bi]) & tfp.F_SWEPT
              and int(ks.blk_flags[bi]) & (tfp.F_A_ART | tfp.F_B_ART)]
    assert couple and float(rows_p[ks.n_state_rows:].abs().max()) > 0.0, "no couple impulse"
    ball = built.scene.actor_index("ball")
    spec = tfp.CostSpec(task=tfp.TASK_PANDA_PICK, ee_body=built.scene.body_offset[ball] - 1,
                        goal_actor=0, w_dist=1.0, w_ori=0.5, block_actor=ball,
                        force_body0=built.scene.body_offset[ball], force_nbody=1, w_block=2.0,
                        w_force=0.01)
    fr = FusedRollout(built, engine, spec, H, K, vis_body=built.scene.body_offset[ball])
    A, D, NS = ks.nactor, ks.ndof, ks.n_state_rows
    held = st.with_root_state(rows[:13 * A].reshape(A, 13)).replace(
        q=rows[13 * A:13 * A + D], qd=rows[13 * A + D:13 * A + 2 * D])
    lam = held.contact_lam.clone()
    lam[torch.as_tensor(fw.fc_idx)] = rows[NS:].reshape(-1, 4)
    g = torch.Generator().manual_seed(6)
    V = torch.rand(K, H, fr.nu, generator=g) * 2 - 1
    pm = ModelParams(torch.ones(K, built.scene.nbody), torch.ones(K, built.scene.ngeom))
    inputs = fr.pack(broadcast_state(held.replace(contact_lam=lam), K), pm, V)
    costs, vis = emu_rollout(emu, fr, *inputs)
    costs_p, vis_p = fr.plain(*inputs)
    torch.testing.assert_close(costs, costs_p, rtol=COST_TOL, atol=COST_TOL)
    torch.testing.assert_close(vis, vis_p, rtol=0.0, atol=VIS_ATOL)


def _row_groups(ks, d):
    """max |d| of a rows vector by chip_smoke.py's row groups."""
    A, D, NS = ks.nactor, ks.ndof, ks.n_state_rows
    root = d[: 13 * A].reshape(A, 13)
    return dict(pose=max(root[:, :7].max().item(), d[13 * A:13 * A + D].max().item()),
                vel=max(root[:, 7:].max().item(), d[13 * A + D:NS].max().item()),
                lam=d[NS:].max().item())


def test_stick_first_touch_kernels_match_plain(emu):
    """The stick's first touch of the block (STICK_TOUCH): K1 on the first
    N_TOUCH samples of chip_smoke.py's hold controls and K2 over 5 world
    steps with its hold targets, under STICK_BOUNDS["touching"] (K1 by the
    first step and the median over samples, as chip_smoke.py holds it).
    At this impact the plain version's own float32-vs-float64 drift is
    about 14× the median bound on the CPU: the bounds hold the device code's
    summation orders against the plain version's in the same float32
    arithmetic (g++ contracts no multiply-add here)."""
    cfg, w = world("panda_stick_push")
    b = w.built
    st = SimState(**torch.load(STICK_TOUCH))
    bound = chip_smoke.STICK_BOUNDS["touching"]
    fr = chip_smoke.rollout_for(cfg, PandaStickPushObjective(cfg), b, w.engine, K=N_TOUCH)
    g = torch.Generator().manual_seed(chip_smoke.SEED)
    V = chip_smoke.hold_controls("panda_stick_push", cfg, g,
                                 (cfg.mppi.num_samples, cfg.mppi.horizon, fr.nu))[:N_TOUCH]
    pm = ModelParams(torch.ones(N_TOUCH, b.scene.nbody), torch.ones(N_TOUCH, b.scene.ngeom))
    inputs = fr.pack(broadcast_state(st, N_TOUCH), pm, V)
    assert float(inputs[0][fr.ks.n_state_rows:].abs().max()) > 0.0, "no stick–block impulse"
    (costs, vis), (costs_p, vis_p) = emu_rollout(emu, fr, *inputs), fr.plain(*inputs)
    d = (costs - costs_p).abs()
    assert d[:, 0].max() <= bound["k1_first"], d[:, 0].max()
    assert d.max(1).values.median() <= bound["k1_median"], d.max(1).values.median()
    dv = (vis - vis_p).abs().amax(2)
    assert dv[0].max() <= VIS_ATOL and dv.amax(0).median() <= VIS_ATOL
    fw = FusedWorldStep(b, w.engine, impulse_sweeps=cfg.isaacgym.fused_world_sweeps)

    def tgt():
        u = chip_smoke.hold_controls("panda_stick_push", cfg, g, (fr.nu,))
        return b.cmd_map.apply(u[None], st.q[None])[0]

    rows, rows_p = emu_world_steps(emu, fw, b, st, tgt, 5)
    for k, e in _row_groups(fw.ks, (rows - rows_p).abs()).items():
        assert e <= bound[k], (k, e)


@pytest.mark.parametrize("task", SHIPPED)
def test_lane_orders_and_launch_geometry(task):
    """Every chunk holds whole blocks (the contact chunks grouped by kind, the
    swept chunks in block order), every swept candidate
    names its block, the levels list every body after its parent, the
    layout's state arrays are the rows in order, and the shipped config's K
    spreads over 132 SMs with W warps of the sample's region beside the
    tables in 227 KB."""
    cfg, w = world(task)
    ks = tfp.KernelScene.build(w.built, w.engine, None)
    t = fro._SceneTablesC.from_buffer_copy(fro.pack_tables(ks))
    flags = ks.blk_flags.astype(np.int64)
    for lanes_name, lane0_name, n_name, mask in (
            ("ck_blk", "blk_lane0", "n_ck", tfp.F_EMIT_A | tfp.F_EMIT_B | tfp.F_SWEPT),
            ("sw_blk", "blk_swlane0", "n_sw", tfp.F_SWEPT)):
        lanes = np.array(getattr(t, lanes_name), np.int64).reshape(fro.MAX_CHUNKS, 32)
        blocks = [bi for bi in range(ks.nblk) if flags[bi] & mask]
        seen = [int(b) for b in lanes[: getattr(t, n_name)].reshape(-1) if b != 255]
        if n_name == "n_ck":
            blocks = sorted(blocks, key=lambda bi: (int(ks.blk_kind[bi]), bi))
        assert seen == [bi for bi in blocks for _ in range(int(ks.blk_S[bi]))]
        for bi in blocks:
            ch = [c for c in range(getattr(t, n_name)) if bi in lanes[c]]
            assert len(ch) == 1
            l0 = getattr(t, lane0_name)[bi]
            assert (lanes[ch[0], l0:l0 + int(ks.blk_S[bi])] == bi).all()
    for bi in range(ks.nblk):
        if flags[bi] & tfp.F_SWEPT:
            c0 = int(ks.blk_c0[bi])
            assert list(t.cand_blk[c0:c0 + int(ks.blk_S[bi])]) == [bi] * int(ks.blk_S[bi])
    order = list(t.lvl_body[: ks.nbody])
    assert sorted(order) == list(range(ks.nbody))
    assert all(order.index(int(ks.body_parent[g])) < order.index(g)
               for g in range(ks.nbody) if ks.body_parent[g] >= 0)
    lay = list(t.lay)
    NS = ks.n_state_rows
    assert lay[: 5] == [0, 13 * ks.nactor, 13 * ks.nactor + ks.ndof, 13 * ks.nactor + 2 * ks.ndof, NS]
    W, nbytes = fro.launch_geometry(ks, cfg.mppi.num_samples, 132)
    assert nbytes == 4 * t.warp_words and max(lay) < t.warp_words
    assert 1 <= W <= fro.MAX_WARPS and ctypes.sizeof(t) + W * nbytes <= fro.SMEM_BYTES
    # the samples spread over the 132 SMs, one block each
    assert W == min(fro.MAX_WARPS, -(-cfg.mppi.num_samples // 132)), f"{task}: {W} warps per block"
