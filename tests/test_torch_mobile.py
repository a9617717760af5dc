"""The port's plain K1 and K2 (the twin of the CUDA kernels) against the JAX
package's Pallas kernels in interpret mode, on the scenes of the mobile-robot
slice:

* the `boxer` alone on the ground: a floating-base articulation (6 base
  coordinates + 2 wheel dofs through the diff-drive map) resting on its
  wheels and casters — 4 cp blocks and the chassis' bp block, all five
  stiction (sta) blocks: Ψ of the floating base, the friction-only sweeps,
  the fold-back through the base coordinates and the deferred integration of
  the root;
* the boxer driving into the wall of boxer_reach, its chassis 5 mm into the
  wall's face: the capsule–box and box–box blocks of a floating actor
  against a static box, beside the stiction wheels, and the wall's contact
  force in the TASK_MOBILE_REACH cost;
* two free spheres pressed together in the air (gravity off), one sliding
  past the other: the free–free capsule–capsule (cc) block (a sphere is a
  capsule of zero length) with its normal and friction impulses, which push
  the spheres apart within the first world step; K1 adds a point robot with
  its collision off, so that the rollout has controls.

K2: `FusedWorldStep(interpret=True)` against the port's `FusedWorldStep.step`
over several world steps under a drive command, contact_lam included. K1:
`FusedRollout(interpret=True, world_fidelity=True, impulse_sweeps=2)` at
K=4, H=3 against the port's `FusedRollout.rollout` from a world state with
live contacts (the boxer's contact_lam live), with a cost of the
TASK_MOBILE_REACH or
TASK_MOBILE_PUSH form (written out in lanes form for the JAX side).

Tolerances: world states atol 1e-4 (float32 sums in another order), root
angular velocities atol 1e-3 (a resting body's ω is the difference of
nearly equal contact impulses), net contact forces atol 1e-3 N (they reach
130 N on a wheel, and float32 sums in another order move them by ~2e-6 of
that; 1e-2 N against the wall, whose force reaches 230 N), costs rtol
1e-4 / atol 1e-4. The JAX cost
takes the block's yaw from a polynomial atan whose error against atan2 is
below 2e-6 rad (measured in test_torch_slice.py), far inside the bound.
"""
import jax.numpy as jnp
import numpy as np
import torch

from mppiisaac_tpu.ops.pallas import lanes as JL
from mppiisaac_tpu.ops.pallas.fused_rollout import FusedRollout as JRollout
from mppiisaac_tpu.ops.pallas.fused_rollout import FusedWorldStep as JWorld
from mppiisaac_tpu.physics.step import Engine as JEngine
from mppiisaac_tpu.runtime.sim import broadcast_state as j_broadcast
from mppiisaac_tpu.runtime.sim import sample_model_params as j_params
from mppiisaac_tpu.scene.actor import ActorSpec as JSpec
from mppiisaac_tpu.scene.actor import load_actor_cfgs as j_actors
from mppiisaac_tpu.scene.builder import SimConfig as JSimConfig
from mppiisaac_tpu.scene.builder import build_scene as j_build
from mppiisaac_tpu.utils.config_store import actors_conf_dir as j_actor_dir

from mppiisaac_tpu_torch.convert import model_params_from_jax, sim_state_from_jax
from mppiisaac_tpu_torch.ops import fused_physics as tfp
from mppiisaac_tpu_torch.ops.fused_contacts import KIND_CC
from mppiisaac_tpu_torch.ops.fused_rollout import FusedRollout, FusedWorldStep
from mppiisaac_tpu_torch.physics.step import Engine as TEngine
from mppiisaac_tpu_torch.scene.actor import ActorSpec as TSpec
from mppiisaac_tpu_torch.scene.actor import load_actor_cfgs as t_actors
from mppiisaac_tpu_torch.scene.builder import SimConfig as TSimConfig
from mppiisaac_tpu_torch.scene.builder import build_scene as t_build
from mppiisaac_tpu_torch.utils.config_store import actors_conf_dir

torch.set_num_threads(1)
K, H = 4, 3
COST_RTOL, COST_ATOL = 1e-4, 1e-4
STATE_ATOL = 1e-4
ANGVEL_ATOL = 1e-3
FORCE_ATOL = 1e-3
DRIVE = np.array([1.0, 0.3], np.float32)          # (v, ω) through the diff-drive map

SPHERES = [
    dict(type="sphere", name="obst1", size=[0.15], mass=5.0, init_pos=[0.0, 0.0, 1.0], friction=0.8,
         gravity=False),
    dict(type="sphere", name="obst2", size=[0.15], mass=2.0, init_pos=[0.295, 0.02, 1.0],
         friction=0.8, gravity=False),
]
POINT_ROBOT = dict(type="robot", name="point_robot", urdf_file="point_robot.urdf", fixed=True,
                   collision=False, init_pos=[2.0, 2.0, 0.0])


def scenes(names=(), specs=(), dt=0.05, substeps=2):
    """(JAX built, engine, port built, engine) of conf actors `names` (with
    their conf poses) followed by the actor dicts `specs`."""
    cfg = dict(dt=dt, substeps=substeps)
    js = j_actors(list(names), j_actor_dir()) + [JSpec(**s) for s in specs]
    ts = t_actors(list(names), actors_conf_dir()) + [TSpec(**s) for s in specs]
    jb, tb = j_build(js, JSimConfig(**cfg)), t_build(ts, TSimConfig(**cfg))
    return jb, JEngine(jb.scene), tb, TEngine(tb.scene)


def sliding_spheres(jb, je):
    """The SPHERES state with obst2 moving past obst1 at 0.4 m/s."""
    js = jb.initial_state(je)
    b = jb.scene.actor_index("obst2")
    return je.refresh(js._replace(root_linvel=js.root_linvel.at[b].set(jnp.array([0.0, 0.4, 0.0]))))


def world_steps(jb, je, tb, te, js, n, u_of, jw=None):
    """n world steps of both packages from the same JAX state (the JAX
    package's through `jw`, by default its FusedWorldStep in interpret
    mode); yields the pair of states after each."""
    jw, tw = jw or JWorld(jb, je, interpret=True), FusedWorldStep(tb, te)
    jp = je.default_params()
    ts, tp = sim_state_from_jax(js), model_params_from_jax(jp)
    for i in range(n):
        if jb.scene.ndof:
            tgt = jb.cmd_map.apply(jnp.asarray(u_of(i)), js.q)
            js = js._replace(dof_target=tgt)
            ts = ts.replace(dof_target=torch.as_tensor(np.array(tgt)))
        js, ts = jw.step(js, jp), tw.step(ts, tp)
        yield js, ts


def assert_states(js, ts, where, tols=None):
    tols = dict({"root_angvel": ANGVEL_ATOL, "net_contact_force": FORCE_ATOL}, **(tols or {}))
    for f in ("root_pos", "root_quat", "root_linvel", "root_angvel", "q", "qd",
              "net_contact_force", "contact_lam"):
        ref = np.asarray(getattr(js, f))
        if ref.size:
            tol = tols.get(f, STATE_ATOL)
            np.testing.assert_allclose(getattr(ts, f).numpy(), ref, atol=tol, err_msg=f"{where}: {f}")


def jax_cost(c: tfp.CostSpec):
    """The TASK_MOBILE_REACH / TASK_MOBILE_PUSH form of a CostSpec as a JAX
    lanes cost (the form of the JAX tasks' kernel_cost)."""

    def force(view):
        out = 0.0
        for b0, n in ((c.force_body0, c.force_nbody), (c.force2_body0, c.force2_nbody)):
            f = (0.0, 0.0, 0.0)
            for b in range(b0, b0 + n):
                f = JL.add3(f, view._ncf[b])
            out = out + sum(jnp.abs(f[i]) for i in range(c.force_dims))
        return out

    def fn(view, t):
        if c.task == tfp.TASK_MOBILE_REACH:
            if c.xy_dof >= 0:
                x, y = view.q[c.xy_dof], view.q[c.xy_dof + 1]
            else:
                p = view.actor_pos_by_index(c.xy_actor)
                x, y = p[0], p[1]
            dx, dy = x - c.goal_x, y - c.goal_y
            return c.w_dist * jnp.sqrt(dx * dx + dy * dy + 1e-12) + c.w_force * force(view)
        r = view._pos[c.ee_body]
        block = view.actor_pos_by_index(c.block_actor)
        bq, bv = view._root_quat[c.block_actor], view._root_linv[c.block_actor]
        rbx, rby = r[0] - block[0], r[1] - block[1]
        bgx, bgy = c.goal_x - block[0], c.goal_y - block[1]
        d_rb = jnp.sqrt(rbx * rbx + rby * rby + 1e-12)
        d_bg = jnp.sqrt(bgx * bgx + bgy * bgy + 1e-12)
        align = (rbx * bgx + rby * bgy) / jnp.maximum(d_rb * d_bg, 1e-6) + 1.0
        vel = jnp.sqrt(bv[0] * bv[0] + bv[1] * bv[1] + 1e-12)
        return (c.w_dist * d_rb + c.w_block * d_bg + c.w_ori * jnp.abs(JL.yaw_of(bq) - c.goal_yaw)
                + c.w_align * align + c.w_force * force(view) + c.w_vel * vel)

    return fn


def rollouts(jb, je, tb, te, js, cost, V, vis_body):
    """K1 of both packages from the JAX world state js (broadcast K-wide,
    randomized params); asserts costs and vis agree, returns the costs."""
    sK = j_broadcast(js, K)
    pK = j_params(jb, je, K, seed=3)
    jf = JRollout(jb, je, cost_fn=jax_cost(cost), H=H, K=K, vis_body=vis_body, interpret=True,
                  impulse_sweeps=2, world_fidelity=True)
    cj, vj = jf.rollout(sK, pK, jnp.asarray(V))
    fr = FusedRollout(tb, te, cost, H=H, K=K, vis_body=vis_body, impulse_sweeps=2)
    ct, vt = fr.rollout(sim_state_from_jax(sK), model_params_from_jax(pK), torch.as_tensor(V))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=COST_RTOL, atol=COST_ATOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=4e-3)
    return np.asarray(cj)


def test_boxer_tables():
    """The boxer's kernel tables: one floating-base actor of 8 velocity
    coordinates (6 base + 2 wheels), 5 stiction blocks whose links all get a
    Ψ slot, the diff-drive map as cmd_W."""
    _, _, tb, te = scenes(["boxer"])
    ks = tfp.KernelScene.build(tb, te)
    assert ks.actor_dynamic.tolist() == [tfp.ACTOR_ARTICULATED]
    assert ks.actor_base.tolist() == [6] and ks.nv == 8 and ks.ndof == 2
    assert ks.v_body.tolist() == [0] * 6 + [1, 3]
    sta = [(int(f) & (tfp.F_A_STA | tfp.F_B_STA)) != 0 for f in ks.blk_flags]
    assert sum(sta) == 5 and ks.n_fc == 16
    assert sorted(np.flatnonzero(ks.body_psi >= 0).tolist()) == [0, 1, 2, 3, 4]
    # every coordinate moves the chassis' subtree; a wheel dof only its wheel
    assert ks.body_vmask.tolist()[:5] == [0x3F, 0x7F, 0x3F, 0xBF, 0x3F]
    assert np.allclose(ks.cmd_W, tb.cmd_map.W)


def test_boxer_world_step_matches_pallas():
    """Drive forward and turn from rest for 6 world steps: the floating base
    on its five stiction contacts."""
    jb, je, tb, te = scenes(["boxer"])
    js = jb.initial_state(je)
    last = None
    for i, (js, ts) in enumerate(world_steps(jb, je, tb, te, js, 6, lambda i: DRIVE)):
        assert_states(js, ts, f"step {i}")
        last = js
    assert np.abs(np.asarray(last.contact_lam)).max() > 1e-6, "no friction impulse carried"
    assert float(last.root_linvel[0, 0]) > 0.05, "the boxer did not drive"


def test_boxer_rollout_matches_pallas():
    """K1 from the driving boxer (its stiction λ live): random (v, ω)."""
    jb, je, tb, te = scenes(["boxer"])
    js = jb.initial_state(je)
    for js, _ in world_steps(jb, je, tb, te, js, 2, lambda i: DRIVE):
        pass
    s = tb.scene
    cost = tfp.CostSpec(task=tfp.TASK_MOBILE_REACH, ee_body=-1, goal_actor=-1, w_dist=1.0,
                        w_ori=0.0, xy_actor=0, goal_x=2.0, goal_y=1.0, force_body0=0,
                        force_nbody=s.actors[0].nbody, force_dims=2, w_force=1e-3)
    V = np.random.RandomState(1).uniform(-1, 1, (K, H, tb.cmd_map.nu)).astype(np.float32)
    costs = rollouts(jb, je, tb, te, js, cost, V, s.body_index("ee_link", "boxer"))
    assert np.ptp(costs[:, -1]) > 1e-3, "every sample rolled out the same"


def boxer_at_wall(jb, je):
    """The boxer facing the wall (+y) at x = 1, its chassis 5 mm into the
    wall's face (contact starts at y = 0.625)."""
    js = jb.initial_state(je)
    q = jnp.array([0.0, 0.0, np.sin(np.pi / 4), np.cos(np.pi / 4)], jnp.float32)
    return je.refresh(js._replace(root_pos=js.root_pos.at[0, :2].set(jnp.array([1.0, 0.63])),
                                  root_quat=js.root_quat.at[0].set(q)))


def test_boxer_wall_world_step_matches_pallas():
    """Drive on into the wall for 3 world steps."""
    jb, je, tb, te = scenes(["boxer", "wall"])
    wall = tb.scene.body_offset[tb.scene.actor_index("wall")]
    steps = world_steps(jb, je, tb, te, boxer_at_wall(jb, je), 3,
                        lambda i: np.array([0.5, 0.0], np.float32))
    for i, (js, ts) in enumerate(steps):
        assert_states(js, ts, f"step {i}", {"net_contact_force": 1e-2})
        assert abs(float(js.net_contact_force[wall, 1])) > 100.0, "the boxer left the wall"


def test_boxer_wall_rollout_matches_pallas():
    """K1 from the boxer pressed into the wall, with the wall's force in the
    cost (TASK_MOBILE_REACH at the weight boxer_reach gives it)."""
    jb, je, tb, te = scenes(["boxer", "wall"])
    s = tb.scene
    cost = tfp.CostSpec(task=tfp.TASK_MOBILE_REACH, ee_body=-1, goal_actor=-1, w_dist=1.0,
                        w_ori=0.0, xy_actor=0, goal_x=2.0, goal_y=2.0,
                        force_body0=s.body_offset[s.actor_index("wall")], force_nbody=1,
                        force_dims=2, w_force=0.1)
    V = np.random.RandomState(4).uniform(-1, 1, (K, H, tb.cmd_map.nu)).astype(np.float32)
    costs = rollouts(jb, je, tb, te, boxer_at_wall(jb, je), cost, V,
                     s.body_index("ee_link", "boxer"))
    assert costs[:, 0].max() > 10.0, "no wall force in the cost"


def test_free_spheres_world_step_matches_pallas():
    """Two free spheres pressed 5 mm into each other, one sliding past the
    other: the free–free cc block pushes them apart and drags obst1 along."""
    jb, je, tb, te = scenes(specs=SPHERES)
    ks = tfp.KernelScene.build(tb, te)
    assert ks.blk_kind.tolist().count(KIND_CC) == 1
    steps = list(world_steps(jb, je, tb, te, sliding_spheres(jb, je), 4, None))
    for i, (js, ts) in enumerate(steps):
        assert_states(js, ts, f"step {i}")
    js = steps[0][0]
    assert float(js.root_linvel[0, 1]) > 1e-3, "no friction impulse at the cc contact"
    assert float(js.root_linvel[0, 0]) < -1e-3, "no normal impulse at the cc contact"


def test_free_spheres_rollout_matches_pallas():
    """K1 from the overlapping, sliding spheres: the cc impulses act in the
    rollout's first substeps."""
    jb, je, tb, te = scenes(specs=SPHERES + [POINT_ROBOT])
    js = sliding_spheres(jb, je)
    s = tb.scene
    a, b = s.actor_index("obst1"), s.actor_index("obst2")
    cost = tfp.CostSpec(task=tfp.TASK_MOBILE_PUSH, ee_body=s.body_offset[a], goal_actor=-1,
                        w_dist=0.1, w_ori=3.0, block_actor=b, goal_x=2.0, goal_y=2.0, w_block=2.0,
                        w_align=0.6, w_vel=0.5, force_body0=s.body_offset[a], force_nbody=1,
                        force2_body0=s.body_offset[b], force2_nbody=1, force_dims=2, w_force=0.01)
    V = np.random.RandomState(2).uniform(-1, 1, (K, H, tb.cmd_map.nu)).astype(np.float32)
    rollouts(jb, je, tb, te, js, cost, V, s.body_offset[b])
