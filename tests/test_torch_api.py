"""The state API of the port against the JAX package's, on the CPU:

* `Simulation`'s setters (dof and root states in every accepted shape, actor
  positions, the robot reset with its diff-drive branch, obstacle poses,
  root-state save and reset, `add_to_envs`) on a point-robot scene (the
  robot, the goal marker and the sphere paper_obst1) and a diff-drive scene
  (boxer, wall, goal), each followed by the body-cache refresh: every state
  field agrees to 1e-6 (float32 FK of the same poses); the save/restore and
  the reset to the initial poses are exact;
* every getter of `Simulation` and `SimView`, and `utils/conversions`, on
  those states, to 1e-6 (conversions 1e-5: float32 trigonometry);
* `MPPIisaacPlanner` on point_robot (K=8, H=4): `compute_action`,
  `compute_action_tensor`, `reset_rollout_from_state` + `command`
  (the rollout sims' states to 1e-6), `update_weights`, `update_mppi_params` and
  `add_to_env` against the JAX planner on its XLA rollout (`use_fused=False`)
  with the same injected noise, each control rounded through bf16 as the
  fused kernel rounds V (tests/test_torch_slice.py): actions to 1e-4, costs
  to 1e-5 relative (the reasoning of test_planner_command_matches_jax).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mppiisaac_tpu.planner.mppi_isaac import MPPIisaacPlanner as JPlanner
from mppiisaac_tpu.runtime.sim import Simulation as JSim
from mppiisaac_tpu.runtime.transport import bytes_to_jnp
from mppiisaac_tpu.tasks.point_robot import PointRobotObjective as JPointObjective
from mppiisaac_tpu.utils import conversions as jconv
from mppiisaac_tpu.utils.config_store import load_config as j_load

from mppiisaac_tpu_torch.physics.types import SIM_STATE_FIELDS
from mppiisaac_tpu_torch.planner.mppi_isaac import MPPIisaacPlanner as TPlanner
from mppiisaac_tpu_torch.runtime.sim import Simulation as TSim
from mppiisaac_tpu_torch.runtime.transport import bytes_to_torch, torch_to_bytes
from mppiisaac_tpu_torch.tasks.point_robot import PointRobotObjective as TPointObjective
from mppiisaac_tpu_torch.utils import conversions as tconv
from mppiisaac_tpu_torch.utils.config_store import load_config as t_load

torch.set_num_threads(1)
K_ENVS = 3
ATOL = 1e-6
SPHERE = {"type": "sphere", "name": "added_obstacle", "size": [0.3],
          "init_pos": [1.0, 0.0, 0.3], "mass": 1.0, "fixed": True}
SCENES = {
    # (task conf, actors, initial positions, a link and its actor)
    "point_robot": ("tasks/point_robot", ["point_robot", "goal", "paper_obst1"], None,
                    ("base_link", "point_robot")),
    "boxer": ("tasks/boxer_reach", ["boxer", "wall", "goal"], [[0.0, 0.0, 0.0]],
              ("ee_link", "boxer")),
}


def _sims(scene):
    conf, actors, init, _ = SCENES[scene]
    jc, tc = j_load(conf), t_load(conf)
    js = JSim(cfg=jc.isaacgym, actors=actors, init_positions=init, num_envs=K_ENVS)
    ts = TSim(tc.isaacgym, actors, init, num_envs=K_ENVS, device="cpu")
    return js, ts


def _same(js, ts, what, atol=ATOL):
    for f in SIM_STATE_FIELDS:
        j, t = getattr(js.state, f), getattr(ts.state, f)
        if j is None or t is None:
            assert j is None and t is None, f
            continue
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, err_msg=f"{what}: {f}")


def _exact(a, b):
    for f in SIM_STATE_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None and y is None) or torch.equal(x, y), f


def _root(rng, shape):
    pos = rng.uniform(-1.0, 1.0, shape + (3,))
    quat = rng.normal(size=shape + (4,))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    vel = rng.uniform(-0.5, 0.5, shape + (6,))
    return np.concatenate([pos, quat, vel], -1).astype(np.float32)


def _robot_q(ts, rng):
    """Flat (q, qdot) of every robot in the reset's layout."""
    n = 0
    for spec, art in zip(ts.built.specs, ts.scene.actors):
        if spec.type == "robot":
            n += 3 + art.ndof - int(spec.wheel_count or 2) if spec.differential_drive else art.ndof
    return (rng.uniform(-0.8, 0.8, n).astype(np.float32),
            rng.uniform(-0.4, 0.4, n).astype(np.float32))


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_simulation_setters_match_jax(scene):
    js, ts = _sims(scene)
    _same(js, ts, "initial")
    initial = ts.save_state()
    rng = np.random.RandomState(11)
    A, D = ts.scene.nactor, ts.scene.ndof
    steps = [
        ("set_dof_state (D,2)", "set_dof_state", (rng.uniform(-0.5, 0.5, (D, 2)).astype(np.float32),)),
        ("set_dof_state (K,D,2)", "set_dof_state",
         (rng.uniform(-0.5, 0.5, (K_ENVS, D, 2)).astype(np.float32),)),
        ("set_dof_state (2D,)", "set_dof_state", (rng.uniform(-0.5, 0.5, 2 * D).astype(np.float32),)),
        ("set_root_state (A,13)", "set_root_state", (_root(rng, (A,)),)),
        ("set_root_state (K,A,13)", "set_root_state", (_root(rng, (K_ENVS, A)),)),
        ("set_actor_position_by_name", "set_actor_position_by_name",
         ("goal", rng.uniform(-1, 1, 3).astype(np.float32))),
        ("reset_robot_state", "reset_robot_state", _robot_q(ts, rng)),
        ("update_root_state_by_obstacles", "update_root_state_by_obstacles",
         ([(rng.uniform(-1, 1, 3).astype(np.float32), rng.uniform(-1, 1, 3).astype(np.float32))],)),
    ]
    for what, name, args in steps:
        getattr(js, name)(*args)
        getattr(ts, name)(*args)
        _same(js, ts, what)
    if scene == "boxer":
        # the diff-drive branch: x, y and yaw went into the boxer's root pose
        q, _ = _robot_q(ts, np.random.RandomState(3))
        ts.reset_robot_state(q, np.zeros_like(q))
        yaw = tconv.quaternion_to_yaw(ts.get_actor_orientation_by_name("boxer"))
        np.testing.assert_allclose(ts.get_actor_position_by_name("boxer")[:, :2].numpy(),
                                   np.broadcast_to(q[:2], (K_ENVS, 2)), atol=ATOL)
        np.testing.assert_allclose(yaw.numpy(), np.full(K_ENVS, q[2]), atol=1e-6)
        js.reset_robot_state(q, np.zeros_like(q))
        _same(js, ts, "diff-drive reset")

    # root-state save and reset
    js.save_root_state()
    ts.save_root_state()
    saved = ts.state
    r = _root(rng, (A,))
    js.set_root_state(r)
    ts.set_root_state(r)
    js.reset_root_state()
    ts.reset_root_state()
    _same(js, ts, "reset_root_state")
    for f in ("root_pos", "root_quat", "root_linvel", "root_angvel"):
        assert torch.equal(getattr(ts.state, f), getattr(saved, f)), f

    # whole-state save / restore and the initial poses: exact
    snap = ts.save_state()
    ts.set_dof_state(rng.uniform(-0.5, 0.5, (D, 2)).astype(np.float32))
    ts.restore_state(snap)
    _exact(ts.state, snap)
    ts.reset_to_initial_poses()
    js.reset_to_initial_poses()
    _exact(ts.state, initial)
    _same(js, ts, "reset_to_initial_poses")

    # add_to_envs keeps the poses of the actors already there
    r = _root(rng, (A,))
    js.set_root_state(r)
    ts.set_root_state(r)
    js.add_to_envs([dict(SPHERE)])
    ts.add_to_envs([dict(SPHERE)])
    assert ts.scene.nactor == A + 1 and "added_obstacle" in ts.scene.actor_names
    _same(js, ts, "add_to_envs")
    np.testing.assert_allclose(ts.state.root_pos[:, :A].numpy(),
                               np.broadcast_to(r[:, :3], (K_ENVS, A, 3)), atol=ATOL)


def _check(name, got, ref, atol=ATOL):
    if isinstance(ref, (int, str)):
        assert got == ref, name
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol, err_msg=name)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_getters_match_jax(scene):
    js, ts = _sims(scene)
    rng = np.random.RandomState(5)
    A, D = ts.scene.nactor, ts.scene.ndof
    for sim in (js, ts):
        sim.set_root_state(_root(np.random.RandomState(6), (K_ENVS, A)))
        sim.set_dof_state(np.random.RandomState(7).uniform(-0.5, 0.5, (K_ENVS, D, 2)).astype(np.float32))
    link, actor = SCENES[scene][3]
    for name in ("root_state", "dof_state", "rigid_body_state", "net_cf", "num_bodies", "nu"):
        _check(f"Simulation.{name}", getattr(ts, name), getattr(js, name))
    for a in ts.scene.actor_names:
        for name in ("get_actor_position_by_name", "get_actor_orientation_by_name",
                     "get_actor_velocity_by_name"):
            _check(f"Simulation.{name}({a})", getattr(ts, name)(a), getattr(js, name)(a))
    _check("Simulation.get_actor_link_by_name", ts.get_actor_link_by_name(link, actor),
           js.get_actor_link_by_name(link, actor))

    tv, jv = ts.view, js.view
    for name in ("root_state", "dof_state", "rigid_body_state", "net_cf", "num_bodies",
                 "robot_name"):
        _check(f"SimView.{name}", getattr(tv, name), getattr(jv, name))
    for a in ts.scene.actor_names:
        for name in ("actor_position", "actor_orientation", "actor_linvel", "actor_angvel",
                     "get_actor_position_by_name", "get_actor_orientation_by_name",
                     "get_actor_velocity_by_name", "actor_q", "actor_qd"):
            _check(f"SimView.{name}({a})", getattr(tv, name)(a), getattr(jv, name)(a))
    for name in ("link_position", "link_orientation", "link_velocity", "link_state"):
        _check(f"SimView.{name}", getattr(tv, name)(link, actor), getattr(jv, name)(link, actor))
    _check("SimView.get_actor_link_by_name", tv.get_actor_link_by_name(actor, link),
           jv.get_actor_link_by_name(actor, link))
    _check("SimView.get_dof_state", tv.get_dof_state(), jv.get_dof_state())
    if ts.built.visualize_bodies:
        _check("SimView.ee_position", tv.ee_position(), jv.ee_position())

    # conversions, on random unit quaternions (float32 trigonometry: 1e-5)
    quat = rng.normal(size=(16, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    tq, jq = torch.as_tensor(quat), jnp.asarray(quat)
    _check("quaternion_to_yaw", tconv.quaternion_to_yaw(tq), jconv.quaternion_to_yaw(jq), 1e-5)
    for i, (t, j) in enumerate(zip(tconv.quat_to_euler_zyx(tq), jconv.quat_to_euler_zyx(jq))):
        _check(f"quat_to_euler_zyx[{i}]", t, j, 1e-5)
    tm, jm = tconv.quaternion_to_matrix(tq), jconv.quaternion_to_matrix(jq)
    _check("quaternion_to_matrix", tm, jm, 1e-5)
    _check("matrix_to_quaternion", tconv.matrix_to_quaternion(tm),
           jconv.matrix_to_quaternion(jnp.asarray(tm.numpy())), 1e-5)


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------
OVERRIDES = ["mppi.num_samples=8", "mppi.horizon=4"]


def _inject(jp, tp, seed):
    """The same (K,H,nu) noise into both solvers, and the JAX rollout's
    controls rounded through bf16 as the fused kernel rounds V. Set before
    each solver's first command (the JAX command traces it then)."""
    c = tp.mppi.cfg
    eps = np.random.RandomState(seed).uniform(
        -0.8, 0.8, (c.num_samples, c.horizon, tp.mppi.nu)).astype(np.float32)
    jp.mppi._sample_noise = lambda key, sigma: jnp.asarray(eps)
    tp.mppi.noise = lambda draw, sigma: torch.as_tensor(eps)
    dynamics = jp.mppi.dynamics
    jp.mppi.dynamics = lambda st, u, t: dynamics(st, u.astype(jnp.bfloat16).astype(jnp.float32), t)
    jp.mppi.retrace()


def _planners():
    jc, tc = j_load("tasks/point_robot", OVERRIDES), t_load("tasks/point_robot", OVERRIDES)
    jp = JPlanner(jc, JPointObjective(jc), use_fused=False)
    tp = TPlanner(tc, TPointObjective(tc), device="cpu")
    _inject(jp, tp, 0)
    return jp, tp


def _act(jp, tp, q, qd, atol=1e-4):
    a_j, a_t = jp.compute_action(q, qd), tp.compute_action(q, qd)
    assert a_t.shape == a_j.shape
    np.testing.assert_allclose(a_t, a_j, atol=atol)
    np.testing.assert_allclose(tp.mppi.last_info["costs"].numpy(),
                               np.asarray(jp.mppi.last_info["costs"]), rtol=1e-5, atol=1e-5)
    return a_t


def test_planner_direct_and_rpc_entry_points_match_jax():
    jp, tp = _planners()
    q, qd = np.array([0.3, -0.2, 0.1]), np.array([0.1, 0.0, -0.2])
    a0 = _act(jp, tp, q, qd)
    _act(jp, tp, q + 0.1, qd)              # a second command from the saved root state
    # the RPC entry from a world's state bytes
    world = TSim(t_load("tasks/point_robot").isaacgym, ["point_robot"], device="cpu")
    world.set_dof_state(np.array([[0.5, 0.2], [-0.4, 0.1], [0.2, 0.0]], np.float32))
    dof, root = torch_to_bytes(world.dof_state[0]), torch_to_bytes(world.root_state[0])
    b_t, b_j = tp.compute_action_tensor(dof, root), jp.compute_action_tensor(dof, root)
    assert isinstance(b_t, bytes)
    np.testing.assert_allclose(bytes_to_torch(b_t).numpy(), np.asarray(bytes_to_jnp(b_j)), atol=1e-4)
    _same(jp.sim, tp.sim, "reset_rollout_sim")
    np.testing.assert_allclose(bytes_to_torch(tp.command()).numpy(),
                               np.asarray(bytes_to_jnp(jp.command())), atol=1e-4)
    # the in-process entry: a 1-env world state broadcast K-wide, then command
    jworld = JSim(cfg=j_load("tasks/point_robot").isaacgym, actors=["point_robot"])
    jworld.set_dof_state(np.array([[-0.3, 0.1], [0.6, -0.2], [0.0, 0.3]], np.float32))
    world.set_dof_state(np.array([[-0.3, 0.1], [0.6, -0.2], [0.0, 0.3]], np.float32))
    jp.reset_rollout_from_state(jworld.state)
    tp.reset_rollout_from_state(world.state)
    _same(jp.sim, tp.sim, "reset_rollout_from_state")
    np.testing.assert_allclose(bytes_to_torch(tp.command()).numpy(),
                               np.asarray(bytes_to_jnp(jp.command())), atol=1e-4)
    # rollouts: point_robot has no visualize link → the (1,1,1) zero tensor
    assert tuple(bytes_to_torch(tp.get_rollouts()).shape) == tuple(bytes_to_jnp(jp.get_rollouts()).shape)
    assert a0.shape == (3,)
    # a root state of another actor count: the JAX message
    bad = torch_to_bytes(torch.zeros(2, 13))
    with pytest.raises(ValueError, match="root_state covers 2 actors but the planner scene has 1"):
        tp.reset_rollout_sim(dof, bad)


def test_update_weights_repacks_the_same_rollout():
    """New weights change the costs as in the JAX package, through the same
    FusedRollout (no new build) with re-packed table bytes."""
    jp, tp = _planners()
    q, qd = np.array([0.3, -0.2, 0.1]), np.zeros(3)
    _act(jp, tp, q, qd)
    fr, old = tp.mppi.fused, tp.mppi.fused._tables._bytes
    costs0 = tp.mppi.last_info["costs"].clone()
    w = {"nav": 3.0, "obstacle": 0.5, "coll": 0.2}
    jp.update_weights(dict(w))
    tp.update_weights(dict(w))
    assert tp.mppi.fused is fr and fr._tables._bytes != old
    assert fr.ks.cost.w_dist == 3.0 and fr.ks.cost.w_force == pytest.approx(0.2)
    _act(jp, tp, q, qd)
    assert not torch.allclose(tp.mppi.last_info["costs"], costs0)
    # update_objective: a new goal into the same rollout
    jc, tc = j_load("tasks/point_robot", OVERRIDES + ["goal=[-1.0,0.5]"]), \
        t_load("tasks/point_robot", OVERRIDES + ["goal=[-1.0,0.5]"])
    jp.update_objective(JPointObjective(jc))
    tp.update_objective(TPointObjective(tc))
    assert tp.mppi.fused is fr and fr.ks.cost.goal_x == -1.0
    _act(jp, tp, q, qd)


def test_update_mppi_params_matches_jax():
    """A non-structural key mirrored onto the solver's config (bounds), then
    structural keys with noise_sigma rebuild the solver and the rollout
    (port of tests/test_scene_features.py:117-138), against the JAX planner."""
    jp, tp = _planners()
    q, qd = np.array([0.3, -0.2, 0.1]), np.zeros(3)
    _act(jp, tp, q, qd)
    fr = tp.mppi.fused
    bounds = {"u_min": [-0.3], "u_max": [0.3]}
    jp.update_mppi_params(dict(bounds))
    tp.update_mppi_params(dict(bounds))
    assert tp.mppi.fused is fr and tp.mppi.cfg.u_max == [0.3]
    a = _act(jp, tp, q, qd)
    assert np.abs(a).max() <= 0.3 + 1e-6
    sigma = (np.eye(3) * 0.4).tolist()
    new = {"horizon": 6, "num_samples": 16, "noise_sigma": sigma}
    jp.update_mppi_params(dict(new))
    tp.update_mppi_params(dict(new))
    assert tp.mppi.cfg.horizon == 6 and tp.mppi.cfg.num_samples == 16
    assert tp.mppi.carry.U.shape[0] == 6 and tp.sim.num_envs == 16
    assert tp.mppi.fused is not fr and tp.mppi.fused.K == 16 and tp.mppi.fused.H == 6
    np.testing.assert_allclose(tp.mppi.carry.sigma.numpy(), np.eye(3) * 0.4, atol=1e-6)
    _inject(jp, tp, 1)
    _act(jp, tp, q, qd)


def test_add_to_env_matches_jax():
    """Port of tests/test_scene_features.py:88-114: the rollout scene gains
    the actor, cfg.actors follows, and the planner plans over the new scene
    as the JAX planner does."""
    jp, tp = _planners()
    q, qd = np.array([0.3, -0.2, 0.1]), np.zeros(3)
    a0 = _act(jp, tp, q, qd)
    n_actors = len(tp.sim.built.specs)
    jp.add_to_env([dict(SPHERE)])
    tp.add_to_env([dict(SPHERE)])
    assert len(tp.sim.built.specs) == n_actors + 1
    assert any(getattr(a, "name", None) == "added_obstacle" for a in tp.cfg.actors)
    assert tp.mppi.fused.ks.nactor == n_actors + 1
    _inject(jp, tp, 2)
    a1 = _act(jp, tp, q, qd)
    assert np.all(np.isfinite(a1)) and a1.shape == a0.shape
