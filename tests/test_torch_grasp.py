"""The port's plain K1 and K2 (the twin of the CUDA kernels) against the JAX
package's Pallas kernels in interpret mode, on two small scenes with swept
contact blocks:

* the `mini_gripper` (gripper binarize, band 0.12) holding a ball — cp, bp
  and cb blocks, 3 couple blocks, 11 impulse candidates: the implicit couple
  solve, Ψ, the two-way sweeps, the λ warm start and the stiction snap;
* a fixed box table with a free cube dropped onto it — bp and bbc
  free-body impulses, no articulation in contact (K1 adds a point robot with
  its collision off, so that the rollout has controls).

K1: `FusedRollout(interpret=True, world_fidelity=True, impulse_sweeps=2)`
against the port's `FusedRollout.plain` from a world state whose contact_lam
is live, with a cost of the TASK_PANDA_PICK form (written out in lanes form
for the JAX side). K2: `FusedWorldStep(interpret=True)` against the port's
`FusedWorldStep.step` over several world steps, contact_lam included.

Tolerances: costs rtol 1e-4 / atol 1e-5 and world states atol 1e-4 (float32
sums in another order; the two agree to ~1e-6 here), except a resting box's
angular velocity, atol 1e-3: it is the difference of nearly equal corner
impulses, and a 1e-7 change in one of them moves it by ~1e-4 rad/s.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppiisaac_tpu.ops.pallas import lanes as JL
from mppiisaac_tpu.ops.pallas.fused_rollout import FusedRollout as JRollout
from mppiisaac_tpu.ops.pallas.fused_rollout import FusedWorldStep as JWorld
from mppiisaac_tpu.physics.step import Engine as JEngine
from mppiisaac_tpu.runtime.sim import broadcast_state as j_broadcast
from mppiisaac_tpu.runtime.sim import sample_model_params as j_params
from mppiisaac_tpu.scene.actor import ActorSpec as JSpec
from mppiisaac_tpu.scene.builder import SimConfig as JSimConfig
from mppiisaac_tpu.scene.builder import build_scene as j_build

from mppiisaac_tpu_torch.convert import model_params_from_jax, sim_state_from_jax
from mppiisaac_tpu_torch.ops import fused_physics as tfp
from mppiisaac_tpu_torch.ops.fused_rollout import FusedRollout, FusedWorldStep
from mppiisaac_tpu_torch.physics.step import Engine as TEngine
from mppiisaac_tpu_torch.scene.actor import ActorSpec as TSpec
from mppiisaac_tpu_torch.scene.builder import SimConfig as TSimConfig
from mppiisaac_tpu_torch.scene.builder import build_scene as t_build

torch.set_num_threads(1)
K, H = 4, 3
COST_RTOL, COST_ATOL = 1e-4, 1e-5
STATE_ATOL = 1e-4
ANGVEL_ATOL = 1e-3

GRIPPER = [
    dict(type="robot", name="mini_gripper", fixed=True, gripper_binarize=True, init_pos=[0.0, 0.0, 0.5]),
    dict(type="sphere", name="ball", size=[0.02], mass=0.005, init_pos=[0.0, 0.0, 0.53], friction=1.0),
]
TABLE = [
    dict(type="box", name="table", size=[0.5, 0.5, 0.1], fixed=True, init_pos=[0.0, 0.0, 0.05]),
    dict(type="box", name="cube", size=[0.05, 0.05, 0.05], mass=0.2, init_pos=[0.02, 0.01, 0.13],
         init_ori=[0.0, 0.0, 0.2, 0.98], friction=0.8),
]
POINT_ROBOT = dict(type="robot", name="point_robot", urdf_file="point_robot.urdf", fixed=True,
                   collision=False, init_pos=[2.0, 2.0, 0.0])


def _scenes(specs):
    cfg = dict(dt=0.05, substeps=2)
    jb = j_build([JSpec(**s) for s in specs], JSimConfig(**cfg))
    tb = t_build([TSpec(**s) for s in specs], TSimConfig(**cfg))
    return jb, JEngine(jb.scene), tb, TEngine(tb.scene)


def _jax_cost(c: tfp.CostSpec):
    """The TASK_PANDA_PICK form of a CostSpec as a JAX lanes cost."""

    def fn(view, t):
        r, rq = view._pos[c.ee_body], view._quat[c.ee_body]
        block, goal = view.actor_pos_by_index(c.block_actor), view.actor_pos_by_index(c.goal_actor)
        tf = (0.0, 0.0, 0.0)
        for b in range(c.force_body0, c.force_body0 + c.force_nbody):
            tf = JL.add3(tf, view._ncf[b])
        d_rb = JL.norm3(JL.sub3(r, block), eps=1e-12)
        d_bg = JL.norm3(JL.sub3(block, goal), eps=1e-12)
        forces = jnp.abs(tf[0]) + jnp.abs(tf[1]) + jnp.abs(tf[2])
        _, p, y = JL.euler_zyx(rq)
        ori = jnp.sqrt(y * y + p * p + 1e-12)
        return c.w_dist * d_rb + c.w_block * d_bg + c.w_force * forces + c.w_ori * ori

    return fn


def _world_steps(jb, je, tb, te, js, n, u_of):
    """n world steps of both packages from the same JAX state; yields the
    pair of states after each."""
    jw, tw = JWorld(jb, je, interpret=True), FusedWorldStep(tb, te)
    jp = je.default_params()
    ts, tp = sim_state_from_jax(js), model_params_from_jax(jp)
    for i in range(n):
        if jb.scene.ndof:
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


def _gripper_open_state(jb, je):
    st = jb.initial_state(je)
    return je.refresh(st._replace(q=jnp.full_like(st.q, 0.034)))


def _close_then_open(i):
    return np.full(2, -1.0 if i < 3 else 1.0, np.float32)


def test_world_step_matches_pallas_gripper():
    """Close on the ball for three steps (the grasp holds: couple terms,
    sweeps, snap), then open and release it."""
    jb, je, tb, te = _scenes(GRIPPER)
    ball = jb.scene.actor_index("ball")
    for i, (js, ts) in enumerate(_world_steps(jb, je, tb, te, _gripper_open_state(jb, je), 5,
                                              _close_then_open)):
        _assert_states(js, ts, f"step {i}")
        if i == 2:
            assert np.abs(np.asarray(js.contact_lam)).max() > 1e-5, "the grasp carried no impulse"
            assert float(ts.root_pos[ball, 2]) > 0.5, "the ball fell out of the grasp"


def test_world_step_seeds_and_scatters_contact_lam():
    """K2 reads its λ rows from contact_lam[fc_idx] and writes them back
    there: from a state whose cache is live, every step's contact_lam
    matches the JAX world step, and rows outside fc_idx keep their values."""
    jb, je, tb, te = _scenes(TABLE)
    js = jb.initial_state(je)
    steps = list(_world_steps(jb, je, tb, te, js, 4, None))
    fw = FusedWorldStep(tb, te)
    seeded = steps[1][1]
    rng = np.random.RandomState(0)
    other = np.setdiff1d(np.arange(fw.ks.n_con), fw.fc_idx)
    lam = seeded.contact_lam.clone()
    lam[torch.as_tensor(other)] = torch.as_tensor(rng.uniform(size=(len(other), 4)), dtype=torch.float32)
    nxt = fw.step(seeded.replace(contact_lam=lam), model_params_from_jax(je.default_params()))
    np.testing.assert_array_equal(nxt.contact_lam[torch.as_tensor(other)].numpy(),
                                  lam[torch.as_tensor(other)].numpy())
    np.testing.assert_allclose(nxt.contact_lam.numpy()[fw.fc_idx],
                               np.asarray(steps[2][0].contact_lam)[fw.fc_idx], atol=STATE_ATOL)
    assert np.abs(nxt.contact_lam.numpy()[fw.fc_idx]).max() > 1e-4, "no impulse carried"
    zero = fw.step(seeded.replace(contact_lam=torch.zeros_like(lam)),
                   model_params_from_jax(je.default_params()))
    assert not torch.allclose(zero.root_linvel, nxt.root_linvel, atol=1e-7), \
        "the λ seed does not reach the sweeps"
    for i, (js, ts) in enumerate(steps):
        _assert_states(js, ts, f"step {i}")


def _rollouts(specs, cost_of, V_of, warm_steps, u_of):
    jb, je, tb, te = _scenes(specs)
    js = jb.initial_state(je)
    if "ball" in jb.scene.actor_names:
        js = _gripper_open_state(jb, je)
    for js, _ in _world_steps(jb, je, tb, te, js, warm_steps, u_of):
        pass
    assert np.abs(np.asarray(js.contact_lam)).max() > 1e-6, "the rollout starts from a cold cache"
    c = cost_of(tb)
    sK = j_broadcast(js, K)
    pK = j_params(jb, je, K, seed=3)
    V = V_of(np.random.RandomState(1), tb.cmd_map.nu)
    jf = JRollout(jb, je, cost_fn=_jax_cost(c), H=H, K=K, vis_body=jb.scene.body_offset[c.block_actor],
                  interpret=True, impulse_sweeps=2, world_fidelity=True)
    cj, vj = jf.rollout(sK, pK, jnp.asarray(V))
    fr = FusedRollout(tb, te, c, H=H, K=K, vis_body=tb.scene.body_offset[c.block_actor],
                      impulse_sweeps=2)
    ct, vt = fr.rollout(sim_state_from_jax(sK), model_params_from_jax(pK), torch.as_tensor(V))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=COST_RTOL, atol=COST_ATOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=4e-3)
    return np.asarray(cj)


def test_rollout_matches_pallas_gripper():
    """From a held grasp: half the samples keep closing, some command inside
    the binarize band (the latch holds), some open and drop the ball."""

    def cost_of(tb):
        s = tb.scene
        ball = s.actor_index("ball")
        return tfp.CostSpec(task=tfp.TASK_PANDA_PICK, ee_body=s.body_offset[ball] - 1,
                            goal_actor=0, w_dist=1.0, w_ori=0.5, block_actor=ball,
                            force_body0=s.body_offset[ball], force_nbody=1, w_block=2.0,
                            w_force=0.01)

    def V_of(rng, nu):
        sign = np.where(rng.uniform(size=(K, H, nu)) < 0.6, -1.0, 1.0)
        V = (sign * rng.uniform(0.05, 1.0, (K, H, nu))).astype(np.float32)
        V[1] = 0.05                                   # inside the band: hold
        return V

    costs = _rollouts(GRIPPER, cost_of, V_of, 3, _close_then_open)
    assert np.ptp(costs[:, -1]) > 1e-3, "every sample rolled out the same"


def test_rollout_matches_pallas_table():
    def cost_of(tb):
        s = tb.scene
        cube, table = s.actor_index("cube"), s.actor_index("table")
        return tfp.CostSpec(task=tfp.TASK_PANDA_PICK, ee_body=s.body_offset[cube],
                            goal_actor=table, w_dist=1.0, w_ori=0.5, block_actor=cube,
                            force_body0=s.body_offset[table], force_nbody=1, w_block=2.0,
                            w_force=0.01)

    def V_of(rng, nu):
        return rng.uniform(-1, 1, (K, H, nu)).astype(np.float32)

    _rollouts(TABLE + [POINT_ROBOT], cost_of, V_of, 2, lambda i: np.zeros(3, np.float32))


@pytest.mark.slow
def test_pick_rollout_matches_pallas_interpret():
    """The full panda_pick scene (38 pair blocks, 130 impulse candidates, the
    shipped config's 1 sweep): the port's plain K1 against the JAX package's
    FusedRollout in Pallas interpret mode, K=8, H=2, from the block resting
    on the table with the arm's λ cache cold and the block's live. Minutes on
    the CPU. Bound: costs rtol 1e-4 / atol 1e-3 (costs ~40; the float32 twin
    drifts from float64 by ~5e-5 from a settled block)."""
    from mppiisaac_tpu.scene.actor import load_actor_cfgs as j_actors
    from mppiisaac_tpu.tasks.panda_pick import PandaPickObjective as JPick
    from mppiisaac_tpu.utils.config_store import actors_conf_dir as j_actor_dir
    from mppiisaac_tpu.utils.config_store import load_config as j_load

    from mppiisaac_tpu_torch.scene.actor import load_actor_cfgs as t_actors
    from mppiisaac_tpu_torch.tasks.panda_pick import PandaPickObjective
    from mppiisaac_tpu_torch.utils.config_store import actors_conf_dir, load_config

    jc, tc = j_load("tasks/panda_pick"), load_config("tasks/panda_pick")
    jb = j_build(j_actors(jc.actors, j_actor_dir()), jc.isaacgym, jc.initial_actor_positions)
    tb = t_build(t_actors(tc.actors, actors_conf_dir()), tc.isaacgym, tc.initial_actor_positions)
    je, te = JEngine(jb.scene), TEngine(tb.scene)
    js = jb.initial_state(je)
    jw = JWorld(jb, je, interpret=True)
    jp = je.default_params()
    for _ in range(12):                                  # the block drops onto the table
        js = jw.step(js._replace(dof_target=js.q), jp)
    Kp, Hp = 8, 2
    sK, pK = j_broadcast(js, Kp), j_params(jb, je, Kp, seed=3)
    V = np.random.RandomState(2).uniform(-0.3, 0.3, (Kp, Hp, tb.cmd_map.nu)).astype(np.float32)
    vb = jb.visualize_bodies[0]
    jf = JRollout(jb, je, cost_fn=JPick(jc).kernel_cost(jb.scene), H=Hp, K=Kp, vis_body=vb,
                  interpret=True, impulse_sweeps=jc.mppi.rollout_sweeps, world_fidelity=True)
    cj, _ = jf.rollout(sK, pK, jnp.asarray(V))
    fr = FusedRollout(tb, te, PandaPickObjective(tc).kernel_cost(tb), H=Hp, K=Kp, vis_body=vb,
                      impulse_sweeps=tc.mppi.rollout_sweeps)
    ct, _ = fr.rollout(sim_state_from_jax(sK), model_params_from_jax(pK), torch.as_tensor(V))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-4, atol=1e-3)
