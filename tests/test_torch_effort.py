"""The effort drives, the effort-finger motor and the finger force gate: the
port's plain K1 and K2 (the twin of the CUDA kernels) against the JAX
package's Pallas kernels in interpret mode, on three scenes:

* `panda_effort` (the shipped conf: 7 effort-driven arm joints, cp blocks
  only): K2 over several world steps under random efforts, and K1 at K=8,
  H=2 from the state they reach, with its TASK_PANDA_REACH cost at
  `panda_link7`;
* the `mini_gripper` in effort mode holding a ball: both fingers are
  effort-driven with the motor curve and the spindle stiction, squeezing a
  ball through couple contacts (swept blocks, Ψ, sweeps, λ warm start);
* the same gripper with velocity-driven fingers (its drive modes set by
  hand: no shipped conf has one, since the model turns non-effort fingers
  into position drives): closing on a fixed post pushes a finger's contact
  force past `grip_force_gate` (10 N), and the gate stops that finger's
  closing target.

Tolerances: world states atol 1e-4, except a free body's angular velocity
atol 1e-3 (the difference of nearly equal contact impulses: a 1e-7 change in
one moves it by ~1e-4 rad/s); K1 costs rtol 1e-4 / atol 1e-5. The two agree
to ~1e-6 in float32 where no contact switches.
"""
import jax.numpy as jnp
import numpy as np
import torch

from mppiisaac_tpu.ops.pallas import lanes as JL
from mppiisaac_tpu.ops.pallas.fused_rollout import FusedRollout as JRollout
from mppiisaac_tpu.ops.pallas.fused_rollout import FusedWorldStep as JWorld
from mppiisaac_tpu.physics.model import DRIVE_VELOCITY as J_DRIVE_VELOCITY
from mppiisaac_tpu.physics.step import Engine as JEngine
from mppiisaac_tpu.runtime.sim import broadcast_state as j_broadcast
from mppiisaac_tpu.runtime.sim import sample_model_params as j_params
from mppiisaac_tpu.scene.actor import ActorSpec as JSpec
from mppiisaac_tpu.scene.actor import load_actor_cfgs as j_actors
from mppiisaac_tpu.scene.builder import SimConfig as JSimConfig
from mppiisaac_tpu.scene.builder import build_scene as j_build
from mppiisaac_tpu.tasks.panda_reach import PandaReachObjective as JReach
from mppiisaac_tpu.utils.config_store import actors_conf_dir as j_actor_dir
from mppiisaac_tpu.utils.config_store import load_config as j_load

from mppiisaac_tpu_torch.convert import model_params_from_jax, sim_state_from_jax
from mppiisaac_tpu_torch.ops import fused_physics as tfp
from mppiisaac_tpu_torch.ops.fused_rollout import FusedRollout, FusedWorldStep
from mppiisaac_tpu_torch.physics.model import DRIVE_EFFORT, DRIVE_VELOCITY
from mppiisaac_tpu_torch.physics.step import Engine as TEngine
from mppiisaac_tpu_torch.scene.actor import ActorSpec as TSpec
from mppiisaac_tpu_torch.scene.actor import load_actor_cfgs as t_actors
from mppiisaac_tpu_torch.scene.builder import SimConfig as TSimConfig
from mppiisaac_tpu_torch.scene.builder import build_scene as t_build
from mppiisaac_tpu_torch.tasks.panda_reach import PandaReachObjective
from mppiisaac_tpu_torch.utils.config_store import actors_conf_dir
from mppiisaac_tpu_torch.utils.config_store import load_config as t_load

torch.set_num_threads(1)
STATE_ATOL, ANGVEL_ATOL = 1e-4, 1e-3
COST_RTOL, COST_ATOL = 1e-4, 1e-5


GRIPPER = dict(type="robot", name="mini_gripper", fixed=True, init_pos=[0.0, 0.0, 0.5])
BALL = dict(type="sphere", name="ball", size=[0.02], mass=0.005, init_pos=[0.0, 0.0, 0.53],
            friction=1.0)
# a fixed post between the fingers: a finger's contact with a static geom is
# a penalty contact that reports its force on the finger's link (the
# articulated side of a couple contact with a free body reports none)
POST = dict(type="box", name="post", size=[0.04, 0.04, 0.04], fixed=True, init_pos=[0.0, 0.0, 0.53])


def _spec_scenes(specs, velocity_fingers=False):
    cfg = dict(dt=0.05, substeps=2)
    jb = j_build([JSpec(**s) for s in specs], JSimConfig(**cfg))
    tb = t_build([TSpec(**s) for s in specs], TSimConfig(**cfg))
    if velocity_fingers:
        # the model makes non-effort fingers position drives: set velocity
        # drives with the velocity mode's gain by hand, on both sides alike.
        # The contact stiffness scales with the finger's mass, and a 15 g
        # finger's penalty force stays near 2 N at any depth: at 1 kg it
        # passes the 10 N gate.
        for art, mode in ((jb.scene.actors[0], J_DRIVE_VELOCITY), (tb.scene.actors[0], DRIVE_VELOCITY)):
            art.drive_mode[:] = mode
            art.drive_kp[:] = 0.0
            art.drive_kd[:] = 600.0
            art.mass[1:] = 1.0
    return jb, JEngine(jb.scene), tb, TEngine(tb.scene)


def _conf_scenes(task):
    jc, tc = j_load(f"tasks/{task}"), t_load(f"tasks/{task}")
    jb = j_build(j_actors(jc.actors, j_actor_dir()), jc.isaacgym, jc.initial_actor_positions)
    tb = t_build(t_actors(tc.actors, actors_conf_dir()), tc.isaacgym, tc.initial_actor_positions)
    return jc, tc, jb, JEngine(jb.scene), tb, TEngine(tb.scene)


def _world_steps(jb, je, tb, te, js, n, u_of):
    """n world steps of both packages from the same JAX state (dof targets
    = the command map of u_of(i)); yields the pair of states after each."""
    jw, tw = JWorld(jb, je, interpret=True), FusedWorldStep(tb, te)
    jp = je.default_params()
    ts, tp = sim_state_from_jax(js), model_params_from_jax(jp)
    for i in range(n):
        tgt = jb.cmd_map.apply(jnp.asarray(u_of(i)), js.q)
        js = js._replace(dof_target=tgt)
        ts = ts.replace(dof_target=torch.as_tensor(np.asarray(tgt)))
        js, ts = jw.step(js, jp), tw.step(ts, tp)
        yield js, ts


def _assert_states(js, ts, where):
    for f in ("root_pos", "root_quat", "root_linvel", "root_angvel", "q", "qd",
              "net_contact_force", "contact_lam"):
        ref = np.asarray(getattr(js, f))
        if ref.size:
            tol = ANGVEL_ATOL if f == "root_angvel" else STATE_ATOL
            np.testing.assert_allclose(getattr(ts, f).numpy(), ref, atol=tol, err_msg=f"{where}: {f}")


# finger opening at which each inner face presses 1 mm into the ball (its
# 2 cm radius plus the finger's 0.6 cm half-thickness): the effort fingers
# close slowly under their motor curve, and the ball falls free under
# gravity unless they grip it from the first substep
Q_TOUCH = 0.025


def _gripper_open_state(jb, je, q=0.034):
    st = jb.initial_state(je)
    return je.refresh(st._replace(q=jnp.full_like(st.q, q)))


def test_panda_effort_kernels_match_pallas():
    """panda_effort: every arm dof effort-driven (τ = clip(u, ±effort), the
    passive damping 10). K2 over 4 world steps under random efforts at 0.3
    of the limits, then K1 from the state they reach."""
    jc, tc, jb, je, tb, te = _conf_scenes("panda_effort")
    ks = tfp.KernelScene.build(tb, te)
    assert (ks.dof_mode == DRIVE_EFFORT).all() and np.allclose(ks.dof_kd, 10.0)
    assert not ks.dof_motor.any() and (ks.dof_gate_body < 0).all()
    umax = np.asarray(jc.mppi.u_max, np.float32)
    rng = np.random.RandomState(0)
    js = jb.initial_state(je)
    def efforts(i):
        return rng.uniform(-0.3, 0.3, 7).astype(np.float32) * umax

    for i, (js, ts) in enumerate(_world_steps(jb, je, tb, te, js, 4, efforts)):
        _assert_states(js, ts, f"step {i}")
    assert float(np.abs(np.asarray(js.qd)).max()) > 0.1, "the efforts moved nothing"
    K, H = 8, 2
    sK, pK = j_broadcast(js, K), j_params(jb, je, K, seed=3)
    V = (rng.uniform(-0.5, 0.5, (K, H, 7)) * umax).astype(np.float32)
    jf = JRollout(jb, je, cost_fn=JReach(jc, "panda_link7").kernel_cost(jb.scene), H=H, K=K,
                  vis_body=jb.visualize_bodies[0], interpret=True, world_fidelity=True)
    cj, vj = jf.rollout(sK, pK, jnp.asarray(V))
    fr = FusedRollout(tb, te, PandaReachObjective(tc, "panda_link7").kernel_cost(tb), H=H, K=K,
                      vis_body=tb.visualize_bodies[0])
    ct, vt = fr.rollout(sim_state_from_jax(sK), model_params_from_jax(pK), torch.as_tensor(V))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=COST_RTOL, atol=COST_ATOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=4e-3)


def _squeeze(i):
    """Close with 3 N on each finger for three steps, then hold with 1 N."""
    return np.full(2, -3.0 if i < 3 else -1.0, np.float32)


def test_effort_gripper_world_step_matches_pallas():
    """The effort gripper squeezes the ball and holds it: the motor curve
    |τ|/v_max and the spindle stiction μ_s|τ|/(|q̇| + 0.02) damp both
    fingers against the couple contacts."""
    jb, je, tb, te = _spec_scenes([dict(GRIPPER, dof_mode="effort"), BALL])
    ks = tfp.KernelScene.build(tb, te)
    assert ks.dof_mode.tolist() == [DRIVE_EFFORT] * 2 and ks.dof_motor.tolist() == [1, 1]
    ball = jb.scene.actor_index("ball")
    js = _gripper_open_state(jb, je, Q_TOUCH)
    for i, (js, ts) in enumerate(_world_steps(jb, je, tb, te, js, 5, _squeeze)):
        _assert_states(js, ts, f"step {i}")
    assert np.abs(np.asarray(js.contact_lam)).max() > 1e-5, "the grasp carried no impulse"
    assert float(ts.root_pos[ball, 2]) > 0.5, "the ball fell out of the grasp"


def _ball_cost(tb):
    s = tb.scene
    ball = s.actor_index("ball")
    return tfp.CostSpec(task=tfp.TASK_PANDA_PICK, ee_body=s.body_offset[ball] - 1, goal_actor=0,
                        w_dist=1.0, w_ori=0.5, block_actor=ball, force_body0=s.body_offset[ball],
                        force_nbody=1, w_block=2.0, w_force=0.01)


def _jax_cost(c):
    """The TASK_PANDA_PICK form of a CostSpec as a JAX lanes cost."""

    def fn(view, t):
        r, rq = view._pos[c.ee_body], view._quat[c.ee_body]
        block, goal = view.actor_pos_by_index(c.block_actor), view.actor_pos_by_index(c.goal_actor)
        tf = view._ncf[c.force_body0]
        _, p, y = JL.euler_zyx(rq)
        return (c.w_dist * JL.norm3(JL.sub3(r, block), eps=1e-12)
                + c.w_block * JL.norm3(JL.sub3(block, goal), eps=1e-12)
                + c.w_force * (jnp.abs(tf[0]) + jnp.abs(tf[1]) + jnp.abs(tf[2]))
                + c.w_ori * jnp.sqrt(y * y + p * p + 1e-12))

    return fn


def test_effort_gripper_rollout_matches_pallas():
    """K1 (K=4, H=3, 2 sweeps) from the effort grasp: samples squeeze
    harder, ease off or open with efforts over ±6 N."""
    jb, je, tb, te = _spec_scenes([dict(GRIPPER, dof_mode="effort"), BALL])
    js = _gripper_open_state(jb, je, Q_TOUCH)
    for js, _ in _world_steps(jb, je, tb, te, js, 3, _squeeze):
        pass
    K, H = 4, 3
    c = _ball_cost(tb)
    sK, pK = j_broadcast(js, K), j_params(jb, je, K, seed=3)
    V = np.random.RandomState(1).uniform(-6.0, 6.0, (K, H, 2)).astype(np.float32)
    vb = tb.scene.body_offset[c.block_actor]
    jf = JRollout(jb, je, cost_fn=_jax_cost(c), H=H, K=K, vis_body=vb, interpret=True,
                  impulse_sweeps=2, world_fidelity=True)
    cj, vj = jf.rollout(sK, pK, jnp.asarray(V))
    fr = FusedRollout(tb, te, c, H=H, K=K, vis_body=vb, impulse_sweeps=2)
    ct, vt = fr.rollout(sim_state_from_jax(sK), model_params_from_jax(pK), torch.as_tensor(V))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=COST_RTOL, atol=COST_ATOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=4e-3)
    assert np.ptp(np.asarray(cj)[:, -1]) > 1e-4, "every sample rolled out the same"


def test_finger_force_gate_matches_pallas():
    """Velocity-driven 1 kg fingers closing on a fixed post at -0.2 m/s with
    the velocity drive's gain: a finger's net contact force passes the 10 N gate,
    the gate zeroes its closing target for the next substeps, and the
    fingers chatter on the gate. Every step agrees with the Pallas kernel,
    and the gate is shown to act: the same steps without it (the gate
    threshold raised out of reach) end elsewhere."""
    jb, je, tb, te = _spec_scenes([GRIPPER, POST], velocity_fingers=True)
    ks = tfp.KernelScene.build(tb, te)
    fingers = [tb.scene.body_index("finger1"), tb.scene.body_index("finger2")]
    assert ks.dof_mode.tolist() == [DRIVE_VELOCITY] * 2 and ks.dof_gate_body.tolist() == fingers
    js = _gripper_open_state(jb, je, 0.03)
    fmax = 0.0
    for i, (js, ts) in enumerate(_world_steps(jb, je, tb, te, js, 4,
                                              lambda i: np.full(2, -0.2, np.float32))):
        _assert_states(js, ts, f"step {i}")
        fmax = max(fmax, float(ts.net_contact_force[fingers].norm(dim=-1).max()))
    assert fmax > tb.scene.grip_force_gate, f"no finger force passed the gate ({fmax:.3f} N)"
    fw = FusedWorldStep(tb, te)
    start = sim_state_from_jax(_gripper_open_state(jb, je, 0.03))
    tgt = torch.full((2,), -0.2)
    rows = fw.pack(start).contiguous()
    rows_off = rows.clone()
    fw_off = FusedWorldStep(tb, te)
    fw_off.ks.grip_force_gate = 1e9
    ones_b, ones_g = torch.ones(ks.nbody), torch.ones(ks.ngeom)
    for _ in range(4):
        rows = fw.plain(rows, tgt, ones_b, ones_g)
        rows_off = fw_off.plain(rows_off, tgt, ones_b, ones_g)
    assert float((rows - rows_off).abs().max()) > 1e-4, "the gate changed nothing"


def test_effort_gripper_bounds_cover_float64_drift():
    """The bounds tests/test_torch_cuda.py holds the effort gripper's K1 to
    on the card, at the first step and by the median over samples, are 10×
    (or more) the drift of its plain version in float32 from the same in
    float64 on the same inputs (that module's effort_gripper_hold, here on
    the CPU); the largest difference is not held, since some samples part
    by far more."""
    from test_torch_cuda import GRIPPER_K1_FIRST, GRIPPER_K1_MEDIAN, effort_gripper_hold

    from mppiisaac_tpu_torch.ops.fused_rollout import rollout_plain

    fr, (rows, V, mass, fric) = effort_gripper_hold("cpu")[4:]
    out = {dt: rollout_plain(fr.ks, rows.to(dt), V.to(dt), mass.to(dt), fric.to(dt), fr.H,
                             fr.substeps, fr.dt_sub, fr.vis_body, fr.impulse_sweeps)[0]
           for dt in (torch.float32, torch.float64)}
    d = (out[torch.float32].double() - out[torch.float64]).abs()
    first, median = d[:, 0].max().item(), d.max(1).values.median().item()
    print(f"float32 vs float64: first step {first:.3e}, median over samples {median:.3e}, "
          f"max {d.max().item():.3e} (costs up to {out[torch.float64].abs().max().item():.3f})")
    assert 10 * first <= GRIPPER_K1_FIRST and 10 * median <= GRIPPER_K1_MEDIAN, (first, median)
    assert d.max().item() > GRIPPER_K1_MEDIAN, "no sample parted: the state is not sensitive"
