"""The port's plain K1 and K2 against the JAX package's Pallas kernels in
interpret mode on a pushing contact of the floating-base boxer: a 5 kg sphere
pressed 5.8 mm into the boxer's left wheel (the sphere on the ground, the
wheel on its stiction contacts) while the boxer drives slowly forward and
turns left, so that its left side moves into the sphere; the wheel shoves the
sphere away within the first world step.

Live here at once: capsule–capsule (cc) blocks between the wheel and the
sphere and between a caster and the sphere — couple blocks on a floating
actor, so the implicit couple terms and Ψ run over the 6 base coordinates as
well as the wheel dof — the capsule–box block of the sphere against the
chassis, the five stiction blocks, the two-way sweeps that fold impulses back
through the shared floating base, and the stiction snap of the free sphere.

K2 over several world steps under the drive command, contact_lam included;
K1 at K=4, H=3 from the pushing state with a TASK_MOBILE_PUSH cost (the
sphere as the block). Tolerances as in test_torch_mobile.py, except for the
world step's λ rows (atol 2e-3, λ up to 0.78) and net contact forces (atol
0.1 N, up to 147 N): the stiff couple contact turns float32 rounding into
differences of up to 4.9e-4 and 3.0e-2 N between the two packages (both in
float32), steady over the steps. Both are far below the twin's own
float32-vs-float64 difference from this state, 0.09 in λ: the wheels start
at exactly zero depth, where float64 and float32 disagree on which
contacts are active.
"""
import numpy as np
import torch

from test_torch_mobile import (
    H,
    K,
    assert_states,
    rollouts,
    scenes,
    world_steps,
)

from mppiisaac_tpu_torch.ops import fused_contacts as tfc
from mppiisaac_tpu_torch.ops import fused_physics as tfp

torch.set_num_threads(1)
PUSH_TOLS = {"contact_lam": 2e-3, "net_contact_force": 0.1}
# the sphere 5.8 mm into the left wheel (wheel at y = 0.247, radius 0.08,
# half-width 0.005; the sphere's radius 0.15)
SPHERE = dict(type="sphere", name="obst1", size=[0.15], mass=5.0, init_pos=[0.157, 0.465, 0.15],
              friction=0.8)
PUSH = np.array([0.2, 0.5], np.float32)       # (v, ω): the left wheel moves into the sphere


def _scene():
    return scenes(["boxer"], [SPHERE])


def test_push_tables():
    """cc couple blocks on the floating actor: the wheel and its caster
    against the sphere; the boxer's links get a Ψ for their couple and
    stiction blocks alike."""
    _, _, tb, te = _scene()
    ks = tfp.KernelScene.build(tb, te)
    cc = [i for i, k in enumerate(ks.blk_kind) if k == tfc.KIND_CC]
    assert len(cc) == 4
    assert all(int(ks.blk_flags[i]) & tfc.F_A_ART for i in cc)
    assert ks.actor_base.tolist() == [6, 0] and ks.n_fc == 25
    assert sorted(np.flatnonzero(ks.body_psi >= 0).tolist()) == [0, 1, 2, 3, 4]


def test_push_world_step_matches_pallas():
    jb, je, tb, te = _scene()
    js = jb.initial_state(je)
    for i, (js, ts) in enumerate(world_steps(jb, je, tb, te, js, 4, lambda i: PUSH)):
        assert_states(js, ts, f"step {i}", PUSH_TOLS)
        if i == 0:
            v = np.asarray(js.root_linvel[1])
            assert v[1] > 0.02 and v[0] > 0.01, "the wheel did not push the sphere"
    assert np.abs(np.asarray(js.contact_lam)).max() > 1e-3, "no stiction impulse carried"


def test_push_rollout_matches_pallas():
    """K1 from the sphere pressed into the wheel: the cc couple contact acts
    in the rollout's first substeps."""
    jb, je, tb, te = _scene()
    js = jb.initial_state(je)
    s = tb.scene
    ball = s.actor_index("obst1")
    cost = tfp.CostSpec(task=tfp.TASK_MOBILE_PUSH, ee_body=s.body_index("ee_link", "boxer"),
                        goal_actor=-1, w_dist=0.1, w_ori=3.0, block_actor=ball, goal_x=2.0,
                        goal_y=2.0, w_block=2.0, w_align=0.6, w_vel=0.5,
                        force_body0=s.body_offset[ball], force_nbody=1, force_dims=2, w_force=0.01)
    V = np.random.RandomState(3).uniform(-1, 1, (K, H, tb.cmd_map.nu)).astype(np.float32)
    costs = rollouts(jb, je, tb, te, js, cost, V, s.body_offset[ball])
    assert np.ptp(costs[:, -1]) > 1e-4, "every sample rolled out the same"
