"""The profiling ablations of the device code, emulated on the CPU
(csrc/emu/, built with -DABLATE as ops/native.py builds the card's ablation
library), against the ablated plain twin, on the mini-gripper holding a ball
beside a far ball whose blocks the broadphase gate turns off (couple
blocks, Ψ, the two-way sweeps, the λ warm start and the snap live):

* K1 at each instantiated mask (nocost, nocontact, fkonly, one-way sweeps,
  no gate) against `FusedRollout(profile=...).plain`, K=4, H=2; fkonly
  from the same state with every root given a seeded velocity, since its
  output (q[0], and vis the sum of the roots) sees nothing else it computes;
* K2 at each of its masks (one-way sweeps, no gate) over 3 world steps
  against `FusedWorldStep(profile=...).plain`;
* K1 and K2 with the gate off bit for bit the default build's gated
  kernels, at the held ball and with the ball moved so that only one
  finger's gate is open, with K1's Ψ column counters: the gated build
  solves the columns of the Ψ slots whose blocks the plain `block_gate`
  lets through, fewer than the slots hold, and the gate-off build all;
* a mask that is not instantiated refused.

Tolerances as tests/test_torch_device_emu.py holds the grasp scene: costs
and states 1e-4 (float32 sums in the device code's order against the
plain version's).
"""
import ctypes

import pytest
import torch

from mppiisaac_tpu_torch.ops import fused_rollout as fro
from mppiisaac_tpu_torch.ops.fused_contacts import (F_A_ART, F_A_STA, F_B_ART, F_B_STA, F_SWEPT,
                                                    block_gate)
from mppiisaac_tpu_torch.ops.fused_rollout import FusedRollout, FusedWorldStep
from mppiisaac_tpu_torch.runtime.sim import broadcast_state
from test_torch_ablations import _gripper_and_far_ball, gripper_inputs
from test_torch_device_emu import COST_TOL, STATE_TOL, VIS_ATOL, _bytes, build_emu, emu_rollout

torch.set_num_threads(1)
K, H = 4, 2
PROFILES = {4: {"zero_cost": True}, 1: {"skip_contacts": True},
            7: {"skip_contacts": True, "skip_dynamics": True, "zero_cost": True},
            8: {"two_way_sweeps": False}, 16: {"broadphase_gate": False}}
EMU_NO_VARIANT = 5


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    return build_emu(tmp_path_factory), build_emu(tmp_path_factory, "ABLATE")


@pytest.fixture(scope="module")
def scene():
    built, engine = _gripper_and_far_ball()
    st, spec, k1 = gripper_inputs(built, engine, K, H, seed=11)
    return built, engine, st, spec, k1


def rollout_ablate(lib, mask, fr, rows, V, mass, fric):
    costs, vis = torch.empty(fr.K, fr.H), torch.empty(fr.H, fr.K, 3)
    tb = _bytes(fr._tables)
    rc = lib.emu_rollout_ablate(mask, tb.ctypes.data, rows.data_ptr(), V.data_ptr(),
                                mass.data_ptr(), fric.data_ptr(), costs.data_ptr(),
                                vis.data_ptr(), fr.K, fr.H, fr.substeps, fr.dt_sub,
                                fr.impulse_sweeps, int(fr.world_fidelity), fr.warp_bytes)
    return rc, costs, vis


def world_steps(step, fw, rows, tgt, built, n):
    ones_b, ones_g = torch.ones(built.scene.nbody), torch.ones(built.scene.ngeom)
    for _ in range(n):
        rows = step(fw, rows.contiguous(), tgt.contiguous(), ones_b, ones_g)
    return rows


def emu_step(lib, mask):
    def step(fw, rows, tgt, mass, fric):
        out = torch.empty_like(rows)
        tb = _bytes(fw._tables)
        args = (tb.ctypes.data, rows.data_ptr(), tgt.data_ptr(), mass.data_ptr(),
                fric.data_ptr(), out.data_ptr(), None, 1, fw.substeps, fw.dt_sub,
                fw.impulse_sweeps, fw.warp_bytes)
        rc = lib.emu_world_step_ablate(mask, *args) if mask else lib.emu_world_step(*args)
        assert rc == 0, rc
        return out
    return step


@pytest.mark.parametrize("mask", fro.K1_MASKS)
def test_ablated_rollout_matches_ablated_plain(libs, scene, mask):
    _, ab = libs
    built, engine, _, spec, (sK, pm, V) = scene
    fr = FusedRollout(built, engine, spec, H, K, profile=PROFILES[mask])
    assert fr.mask == mask
    if mask == 7:
        # fkonly keeps every dof, so only the roots' drift reaches its output
        g = torch.Generator().manual_seed(12)
        sK = sK.replace(root_linvel=torch.rand(sK.root_linvel.shape, generator=g) - 0.5)
    inputs = fr.pack(sK, pm, V)
    rc, costs, vis = rollout_ablate(ab, mask, fr, *inputs)
    assert rc == 0
    costs_p, vis_p = fr.plain(*inputs)
    torch.testing.assert_close(costs, costs_p, rtol=COST_TOL, atol=COST_TOL)
    if fr.profile["zero_cost"]:      # vis: the sum of the roots, unrounded
        torch.testing.assert_close(vis, vis_p, rtol=COST_TOL, atol=COST_TOL)
        assert float((vis[-1] - sK.root_pos.sum(1)).abs().max()) > 10 * COST_TOL, \
            "the roots did not move"
    else:
        torch.testing.assert_close(vis, vis_p, rtol=0.0, atol=VIS_ATOL)
    full = FusedRollout(built, engine, spec, H, K).plain(*inputs)[0]
    if mask != 16:
        assert float((costs_p - full).abs().max()) > 10 * COST_TOL, "the ablation changed nothing"


@pytest.mark.parametrize("mask", fro.K2_MASKS)
def test_ablated_world_step_matches_ablated_plain(libs, scene, mask):
    _, ab = libs
    built, engine, st, _, _ = scene
    fw = FusedWorldStep(built, engine, profile=PROFILES[mask])
    tgt = built.cmd_map.apply(torch.full((1, 2), -1.0), st.q[None])[0]
    rows = fw.pack(st)
    got = world_steps(emu_step(ab, mask), fw, rows, tgt, built, 3)
    ref = world_steps(lambda w, *a: w.plain(*a), fw, rows, tgt, built, 3)
    torch.testing.assert_close(got, ref, rtol=STATE_TOL, atol=STATE_TOL)


def psi_columns(lib):
    """K1's Ψ column counters of an emulation library: (solved, held)."""
    out = (ctypes.c_ulonglong * 2)()
    lib.emu_psi_columns.restype = None
    lib.emu_psi_columns(out)
    return int(out[0]), int(out[1])


def live_slots(ks, sK):
    """(K,) the Ψ slots per sample with a two-way block that the plain
    broadphase gate lets through at sK's body poses, and the slots."""
    pos, quat = sK.body_pos.transpose(0, 1), sK.body_quat.transpose(0, 1)
    n = int(ks.body_psi.max()) + 1
    live = torch.zeros(sK.body_pos.shape[0], n, dtype=torch.bool)
    for bi, fl in enumerate(int(f) for f in ks.blk_flags):
        if fl & F_SWEPT and fl & (F_A_ART | F_B_ART | F_A_STA | F_B_STA):
            art = ks.blk_ba[bi] if fl & (F_A_ART | F_A_STA) else ks.blk_bb[bi]
            live[:, int(ks.body_psi[art])] |= block_gate(ks, bi, pos, quat)
    return live.sum(1), n


# the ball as held, and moved 1 cm toward the first finger, out of the
# second finger's gate; the palm's gate is shut in both
MOVES = {"held": None, "one_finger": [0.0, 0.01, 0.0]}


@pytest.mark.parametrize("move", MOVES)
def test_gate_off_kernels_are_bit_for_bit_the_gated_kernels(libs, scene, move):
    lib, ab = libs
    built, engine, st, spec, (sK, pm, V) = scene
    if MOVES[move] is not None:
        ball = built.scene.actor_index("ball")
        rp = st.root_pos.clone()
        rp[ball] += torch.tensor(MOVES[move])
        st = engine.refresh(st.replace(root_pos=rp))
        sK = broadcast_state(st, K)
    fr = FusedRollout(built, engine, spec, H, K)
    inputs = fr.pack(sK, pm, V)
    live, n_slots = live_slots(fr.ks, sK)
    assert 0 < int(live.min()) and int(live.max()) < n_slots
    on0, off0 = psi_columns(lib), psi_columns(ab)
    costs, vis = emu_rollout(lib, fr, *inputs)
    rc, costs_off, vis_off = rollout_ablate(ab, 16, fr, *inputs)
    assert rc == 0 and torch.equal(costs, costs_off) and torch.equal(vis, vis_off)
    (on1, held), off1 = psi_columns(lib), psi_columns(ab)
    held -= on0[1]
    assert held == 6 * n_slots * K * H * fr.substeps
    assert 0 < on1 - on0[0] < held and (on1 - on0[0]) % 6 == 0
    assert (off1[0] - off0[0], off1[1] - off0[1]) == (held, held)
    # one step of one substep: the gates of the packed state alone
    c1, v1, tb = torch.empty(K, 1), torch.empty(1, K, 3), _bytes(fr._tables)
    on0 = psi_columns(lib)
    assert lib.emu_rollout(tb.ctypes.data, *(t.data_ptr() for t in inputs), c1.data_ptr(),
                           v1.data_ptr(), K, 1, 1, fr.dt_sub, fr.impulse_sweeps,
                           int(fr.world_fidelity), fr.warp_bytes) == 0
    on1 = psi_columns(lib)
    assert (on1[0] - on0[0], on1[1] - on0[1]) == (6 * int(live.sum()), 6 * n_slots * K)
    fw = FusedWorldStep(built, engine)
    tgt = built.cmd_map.apply(torch.full((1, 2), -1.0), st.q[None])[0]
    rows = fw.pack(st)
    on = world_steps(emu_step(lib, 0), fw, rows, tgt, built, 3)
    off = world_steps(emu_step(ab, 16), fw, rows, tgt, built, 3)
    assert torch.equal(on, off)
    assert float(on[fw.ks.n_state_rows:].abs().max()) > 0.0, "no couple impulse"


def test_masks_not_instantiated_are_refused(libs, scene):
    lib, ab = libs
    built, engine, _, spec, (sK, pm, V) = scene
    fr = FusedRollout(built, engine, spec, H, K)
    inputs = fr.pack(sK, pm, V)
    for mask in (2, 3, 12):                      # skip_dynamics alone, ...: not in AB_K1_MASKS
        assert rollout_ablate(ab, mask, fr, *inputs)[0] == EMU_NO_VARIANT
    fw = FusedWorldStep(built, engine)
    rows = fw.pack(built.initial_state(engine, "cpu")).contiguous()
    out = torch.empty_like(rows)
    ones_b, ones_g = torch.ones(built.scene.nbody), torch.ones(built.scene.ngeom)
    tb = _bytes(fw._tables)
    tgt = torch.zeros(built.scene.ndof)
    assert ab.emu_world_step_ablate(4, tb.ctypes.data, rows.data_ptr(), tgt.data_ptr(),
                                    ones_b.data_ptr(), ones_g.data_ptr(), out.data_ptr(), None, 1,
                                    fw.substeps, fw.dt_sub, fw.impulse_sweeps,
                                    fw.warp_bytes) == EMU_NO_VARIANT
