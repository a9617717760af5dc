"""The port's plain K1 and K2 against the JAX package's Pallas kernels in
interpret mode on a mesh-fitted robot: the jackal alone on the ground, every
collision element of its URDF an OBJ mesh fit to a sphere, capsule or box
(scene/assets.py), its floating base on four wheels through the diff-drive
map. The wheels and the chassis against the ground are stiction blocks.

K2 over 3 world steps from rest under a drive command, contact_lam
included; K1 at K=4, H=2 from the state after them (the wheels' λ live) with
a TASK_MOBILE_REACH cost. Tolerances as in tests/test_torch_mobile.py.
"""
import numpy as np
import torch

from test_torch_mobile import DRIVE, K, assert_states, rollouts, scenes, world_steps

from mppiisaac_tpu_torch.ops import fused_physics as tfp
from mppiisaac_tpu_torch.physics.urdf import GEOM_BOX, GEOM_CAPSULE, GEOM_SPHERE

torch.set_num_threads(1)


def test_jackal_tables():
    """Every geom comes from a mesh fit; the floating base has 6 + 4
    velocity coordinates and every block is a stiction block."""
    jb, _, tb, te = scenes(["jackal"])
    kinds = set(np.asarray(tb.scene.geom_type).tolist())
    assert kinds <= {GEOM_SPHERE, GEOM_CAPSULE, GEOM_BOX}
    np.testing.assert_array_equal(np.asarray(tb.scene.geom_size), np.asarray(jb.scene.geom_size))
    np.testing.assert_array_equal(np.asarray(tb.scene.geom_pos), np.asarray(jb.scene.geom_pos))
    ks = tfp.KernelScene.build(tb, te)
    assert ks.actor_base.tolist() == [6] and ks.nv == 10
    sta = [(int(f) & (tfp.F_A_STA | tfp.F_B_STA)) != 0 for f in ks.blk_flags]
    assert all(sta) and ks.n_fc > 0


def test_jackal_world_step_and_rollout_match_pallas():
    jb, je, tb, te = scenes(["jackal"])
    js = jb.initial_state(je)
    for i, (js, ts) in enumerate(world_steps(jb, je, tb, te, js, 3, lambda i: DRIVE)):
        assert_states(js, ts, f"step {i}")
    assert np.abs(np.asarray(js.contact_lam)).max() > 1e-6, "no stiction impulse carried"
    cost = tfp.CostSpec(task=tfp.TASK_MOBILE_REACH, ee_body=-1, goal_actor=-1, w_dist=1.0,
                        w_ori=0.0, xy_actor=0, goal_x=2.0, goal_y=1.0, force_body0=0,
                        force_nbody=tb.scene.actors[0].nbody, force_dims=2, w_force=1e-3)
    V = np.random.RandomState(6).uniform(-1, 1, (K, 3, tb.cmd_map.nu)).astype(np.float32)
    costs = rollouts(jb, je, tb, te, js, cost, V, tb.scene.body_index("ee_link", "jackal"))
    assert np.ptp(costs[:, -1]) > 1e-4, "every sample rolled out the same"
