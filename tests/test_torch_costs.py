"""The kernels' cost hooks of the point-robot, multi-robot, stick-push and
omni-pick tasks (the twin's `task_cost`, with each task's CostSpec) against
the JAX objectives' `kernel_cost` closures on the same K states: random dof
and root poses, velocities and net contact forces, obstacles and robots
closer than their distances of interest.

Tolerance: rtol 1e-5 / atol 1e-5 plus, where the cost has an orientation
term, its weight times YAW_POLY_ERR (the JAX kernels take pitch and yaw from
a polynomial atan, the port from atan2; tests/test_torch_slice.py measures
its error). Where the kernel branch and the port objective's `compute_cost`
coincide (single-body force actors, the collision weight 0), the two are
held together to 1e-5 relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppiisaac_tpu.ops.pallas import fused_physics as jfp
from mppiisaac_tpu.runtime.sim import Simulation as JSim
from mppiisaac_tpu.scene.actor import ActorSpec as JSpec
from mppiisaac_tpu.scene.builder import SimConfig as JSimConfig
from mppiisaac_tpu.scene.builder import build_scene as j_build
from mppiisaac_tpu.utils.config_store import load_config as j_load

from mppiisaac_tpu_torch.ops import fused_physics as tfp
from mppiisaac_tpu_torch.physics.step import Engine as TEngine
from mppiisaac_tpu_torch.planner.observables import SimView
from mppiisaac_tpu_torch.runtime.sim import Simulation as TSim
from mppiisaac_tpu_torch.runtime.sim import broadcast_state
from mppiisaac_tpu_torch.scene.actor import ActorSpec as TSpec
from mppiisaac_tpu_torch.scene.builder import SimConfig as TSimConfig
from mppiisaac_tpu_torch.scene.builder import build_scene as t_build
from mppiisaac_tpu_torch.tasks import multi_robot, omni_panda_pick, panda_stick_push, point_robot
from mppiisaac_tpu_torch.utils.config_store import load_config as t_load

torch.set_num_threads(1)
K = 32
RTOL, ATOL = 1e-5, 1e-5
YAW_POLY_ERR = 2e-6


def _lane_view(jscene, ks, st):
    """The JAX lanes view (fk_lanes + LaneView) of the twin's K states."""

    def tiles(x):
        return tuple(jnp.asarray(x[..., i].numpy()) for i in range(x.shape[-1]))

    jst = {"root_pos": [tiles(st["root_pos"][:, a]) for a in range(ks.nactor)],
           "root_quat": [tiles(st["root_quat"][:, a]) for a in range(ks.nactor)],
           "root_linvel": [tiles(st["root_linvel"][:, a]) for a in range(ks.nactor)],
           "root_angvel": [tiles(st["root_angvel"][:, a]) for a in range(ks.nactor)],
           "q": list(tiles(st["q"])), "qd": list(tiles(st["qd"]))}
    jpos, jquat, jlinv, jangv, _ = jfp.fk_lanes(jscene, jst)
    return jfp.LaneView(jscene, jpos, jquat, jlinv, jangv,
                        [tiles(st["net_cf"][:, b]) for b in range(ks.nbody)], jst["q"], jst["qd"],
                        jst["root_pos"], jst["root_quat"], jst["root_linvel"])


def _random_states(tw, ks, rng, dq=1.0, dxy=1.5, dqd=1.0, force=20.0):
    """K states around the world's initial one: dofs, root xy, yaws,
    velocities and net contact forces drawn from `rng`."""
    s0 = tw.state.map(lambda x: x[0])
    q = s0.q + torch.as_tensor(rng.uniform(-dq, dq, (K, ks.ndof)), dtype=torch.float32)
    qd = torch.as_tensor(rng.uniform(-dqd, dqd, (K, ks.ndof)), dtype=torch.float32)
    root = s0.root_state.expand(K, -1, -1).clone()
    root[:, :, 0:2] += torch.as_tensor(rng.uniform(-dxy, dxy, (K, ks.nactor, 2)), dtype=torch.float32)
    ang = rng.uniform(-np.pi, np.pi, (K, ks.nactor))
    root[:, :, 3:7] = torch.as_tensor(np.stack([0 * ang, 0 * ang, np.sin(ang / 2), np.cos(ang / 2)], -1),
                                      dtype=torch.float32)
    st = tfp.rows_to_state(ks, tfp.state_to_rows(ks, root, q, qd))
    st["net_cf"] = torch.as_tensor(rng.uniform(-force, force, (K, ks.nbody, 3)), dtype=torch.float32)
    return s0, st


def _hold(tw, jscene, ks, st, jobj, atol=ATOL):
    pos, quat, _, _, _ = tfp.fk(ks, st)
    got = tfp.task_cost(ks, st, pos, quat)
    ref = np.asarray(jobj.kernel_cost(jscene)(_lane_view(jscene, ks, st), 0))
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=atol)
    return got


def _objective_cost(tw, s0, st, tobj):
    """The port objective's compute_cost on the same states."""
    state = broadcast_state(s0, K).map(torch.Tensor.clone).replace(
        q=st["q"], qd=st["qd"], root_pos=st["root_pos"], root_quat=st["root_quat"],
        root_linvel=st["root_linvel"], root_angvel=st["root_angvel"])
    state = tw.engine.refresh(state).replace(net_contact_force=st["net_cf"])
    return tobj.compute_cost(SimView(tw.built, state))


def _worlds(task, extra_actors=()):
    jc, tc = j_load(f"tasks/{task}"), t_load(f"tasks/{task}")
    for c in (jc, tc):
        c.actors = list(c.actors) + list(extra_actors)
    tw = TSim(tc.isaacgym, tc.actors, tc.initial_actor_positions, device="cpu")
    jw = JSim(cfg=jc.isaacgym, actors=jc.actors, init_positions=jc.initial_actor_positions)
    return jc, tc, jw, tw


def test_point_robot_cost_matches_jax_kernel_cost():
    """point_robot with `paper_obst1` (the sphere `obst1`) as its obstacle,
    the scene the JAX package's benchmark runner builds: the robot up to
    1.5 m from its start, four samples on top of the obstacle (the 1e-3
    floor of the distance), and the collision weight raised from 0 so that
    the force term counts."""
    from mppiisaac_tpu.tasks.point_robot import PointRobotObjective as JObj

    jc, tc, jw, tw = _worlds("point_robot", ["paper_obst1"])
    jobj, tobj = JObj(jc, ["obst1"]), point_robot.PointRobotObjective(tc, ["obst1"])
    s0 = tw.state.map(lambda x: x[0])
    ks = tfp.KernelScene.build(tw.built, tw.engine, tobj.kernel_cost(tw.built))
    obst = tw.scene.actor_index("obst1")
    assert ks.cost.xy_actors == (obst,)
    rng = np.random.RandomState(3)
    s0, st = _random_states(tw, ks, rng, dq=1.5, dxy=0.0)
    st["q"][:4, 0:2] = st["root_pos"][:4, obst, 0:2] + 1e-4 * torch.arange(4.0)[:, None]
    _hold(tw, jw.built.scene, ks, st, jobj)
    got_obj = _objective_cost(tw, s0, st, tobj)
    np.testing.assert_allclose(got_obj.numpy(), _hold(tw, jw.built.scene, ks, st, jobj).numpy(),
                               rtol=RTOL, atol=ATOL)
    for o in (jobj, tobj):
        o.weights["coll"] = 0.5
    ks = tfp.KernelScene.build(tw.built, tw.engine, tobj.kernel_cost(tw.built))
    _hold(tw, jw.built.scene, ks, st, jobj)


def test_multi_pointbot_cost_matches_jax_kernel_cost():
    """Two point robots, the second drawn around the first so that about
    half the samples are closer than min_sep (0.5 m)."""
    from mppiisaac_tpu.tasks.multi_robot import MultiPointbotObjective as JObj

    jc, tc, jw, tw = _worlds("multi_pointbot")
    jobj, tobj = JObj(jc), multi_robot.MultiPointbotObjective(tc)
    ks = tfp.KernelScene.build(tw.built, tw.engine, tobj.kernel_cost(tw.built))
    rng = np.random.RandomState(4)
    s0, st = _random_states(tw, ks, rng, dq=1.0)
    st["q"][:, 3:5] = st["q"][:, 0:2] + torch.as_tensor(rng.uniform(-0.6, 0.6, (K, 2)),
                                                        dtype=torch.float32)
    xy = st["q"][:, 0:2] - st["q"][:, 3:5]
    assert 4 < int((xy.norm(dim=-1) < 0.5).sum()) < K - 4
    got = _hold(tw, jw.built.scene, ks, st, jobj)
    np.testing.assert_allclose(_objective_cost(tw, s0, st, tobj).numpy(), got.numpy(),
                               rtol=RTOL, atol=ATOL)


def test_multi_robot_cost_from_actor_roots_matches_jax():
    """The hook's other form, each robot's xy its actor's root (multi_jackal
    reads its two jackals so): two free spheres named `jackal` against the
    JAX MultiJackalObjective's kernel cost."""
    from mppiisaac_tpu.tasks.multi_robot import MultiJackalObjective as JObj

    specs = [dict(type="sphere", name="jackal", size=[0.2], mass=1.0, init_pos=[0.0, 0.0, 0.2]),
             dict(type="sphere", name="jackal", size=[0.2], mass=1.0, init_pos=[1.0, 0.0, 0.2])]
    cfg = dict(dt=0.05, substeps=2)
    jb = j_build([JSpec(**s) for s in specs], JSimConfig(**cfg))
    tb = t_build([TSpec(**s) for s in specs], TSimConfig(**cfg))
    tobj = multi_robot.MultiJackalObjective()
    te = TEngine(tb.scene)
    ks = tfp.KernelScene.build(tb, te, tobj.kernel_cost(tb))
    assert ks.cost.xy_actors == (0, 1) and ks.cost.xy_dofs == (-1, -1)
    rng = np.random.RandomState(5)
    root = tb.initial_state(te, "cpu").root_state.expand(K, -1, -1).clone()
    root[:, :, 0:2] = torch.as_tensor(rng.uniform(-1.0, 1.0, (K, 2, 2)), dtype=torch.float32)
    q = torch.zeros(K, 0)
    st = tfp.rows_to_state(ks, tfp.state_to_rows(ks, root, q, q))
    pos, quat, _, _, _ = tfp.fk(ks, st)
    got = tfp.task_cost(ks, st, pos, quat)
    ref = np.asarray(JObj().kernel_cost(jb.scene)(_lane_view(jb.scene, ks, st), 0))
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
    d = (root[:, 0, 0:2] - root[:, 1, 0:2]).norm(dim=-1)
    assert int((d < 0.7).sum()) > 0


@pytest.mark.parametrize("task", ["panda_stick_push", "omni_panda_pick"])
def test_arm_cost_matches_jax_kernel_cost(task):
    """panda_stick_push and omni_panda_pick: random arm (and base) poses and
    velocities, block and goal roots moved in xy, the table's net contact
    force; for omni also EE heights below the 0.12 m floor (a quarter of
    the samples with the robot's root lowered by 0.8 m)."""
    if task == "panda_stick_push":
        from mppiisaac_tpu.tasks.panda_stick_push import PandaStickPushObjective as JObj

        tcls = panda_stick_push.PandaStickPushObjective
    else:
        from mppiisaac_tpu.tasks.omni_panda_pick import OmniPandaPickObjective as JObj

        tcls = omni_panda_pick.OmniPandaPickObjective
    jc, tc, jw, tw = _worlds(task)
    jobj, tobj = JObj(jc), tcls(tc)
    ks = tfp.KernelScene.build(tw.built, tw.engine, tobj.kernel_cost(tw.built))
    rng = np.random.RandomState(6)
    s0, st = _random_states(tw, ks, rng, dq=1.0, dxy=0.5, dqd=2.0)
    if task == "omni_panda_pick":
        st["root_pos"][: K // 4, tw.scene.actor_index("omnipanda"), 2] -= 0.8
        pos, _, _, _, _ = tfp.fk(ks, st)
        assert int((pos[ks.cost.ee_body][:, 2] < 0.12).sum()) > 0, "no EE below the height floor"
    got = _hold(tw, jw.built.scene, ks, st, jobj, atol=ATOL + ks.cost.w_ori * YAW_POLY_ERR)
    np.testing.assert_allclose(_objective_cost(tw, s0, st, tobj).numpy(), got.numpy(),
                               rtol=RTOL, atol=1e-4)


@pytest.mark.parametrize("task", ["albert", "anymal"])
def test_mesh_robot_cost_matches_jax_kernel_cost(task):
    """TASK_ALBERT and TASK_ANYMAL: random joint poses and velocities, base
    poses moved in xy with random yaws (albert's EE roll and pitch from
    its arm; anymal's base, face and knee heights from its legs, a quarter
    of the samples with the base lowered from its 1.2 m drop start by 0.9 m
    so that knees and body cross their target heights), the goal moved in
    xy."""
    from mppiisaac_tpu_torch.tasks import albert, anymal

    if task == "albert":
        from mppiisaac_tpu.tasks.albert import AlbertObjective as JObj

        tcls = albert.AlbertObjective
    else:
        from mppiisaac_tpu.tasks.anymal import AnymalObjective as JObj

        tcls = anymal.AnymalObjective
    jc, tc, jw, tw = _worlds(task)
    jobj, tobj = JObj(jc), tcls(tc)
    ks = tfp.KernelScene.build(tw.built, tw.engine, tobj.kernel_cost(tw.built))
    rng = np.random.RandomState(7)
    s0, st = _random_states(tw, ks, rng, dq=0.8, dxy=1.0)
    if task == "anymal":
        assert len(ks.cost.ht_body) == 7 and ks.cost.ht_w == (5.0,) * 7
        st["root_pos"][: K // 4, tw.scene.actor_index("anymal"), 2] -= 0.9
        pos, _, _, _, _ = tfp.fk(ks, st)
        z = torch.stack([pos[b][:, 2] for b in ks.cost.ht_body], 1)
        below = z < torch.as_tensor(ks.cost.ht_z)
        assert 0 < int(below.sum()) < below.numel(), "no height term crosses its target"
    got = _hold(tw, jw.built.scene, ks, st, jobj, atol=ATOL + ks.cost.w_ori * YAW_POLY_ERR)
    np.testing.assert_allclose(_objective_cost(tw, s0, st, tobj).numpy(), got.numpy(),
                               rtol=RTOL, atol=1e-4)
