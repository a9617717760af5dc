"""The device code's stick-push first touch of the block, emulated on the
CPU against the kernels' plain versions: the test of
tests/test_torch_device_emu.py's emulation that takes longest, in a file of
its own so that a worker of its own runs it.

The state is the stick's first touch of the block in chip_smoke.py phase
11's panda_stick_push loop on the card (step 73), as that run saved it.
"""
import os

import torch

import chip_smoke
from mppiisaac_tpu_torch.ops.fused_rollout import FusedWorldStep
from mppiisaac_tpu_torch.physics.types import ModelParams, SimState
from mppiisaac_tpu_torch.runtime.sim import broadcast_state
from mppiisaac_tpu_torch.tasks.panda_stick_push import PandaStickPushObjective
from test_torch_device_emu import VIS_ATOL, emu, emu_rollout, emu_world_steps, world  # noqa: F401

torch.set_num_threads(1)
STICK_TOUCH = os.path.join(os.path.dirname(__file__), "data", "panda_stick_push_first_touch.pt")
N_TOUCH = 32


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
    for k, e in chip_smoke._groups(fw.ks, (rows - rows_p).abs()).items():
        assert e <= bound[k], (k, e)
