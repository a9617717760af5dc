"""The panda reach, panda pick, mobile-robot, effort and point-robot slices
end to end: one planner command of the port against the JAX planner from
the same world state with the same injected noise (panda reach on the XLA
rollout; the mini-gripper grasp scene on the fused Pallas rollout in
interpret mode), the pick, mobile reach and mobile push cost hooks against
the JAX objectives' kernel costs (the newer hooks are in
tests/test_torch_costs.py), short control loops of every ported task on the
CPU, the planner and world wiring of the rollout and world-step settings,
the refusal of unported cost hooks, the entry points' device defaults, and
the port running without JAX or PyYAML installed."""
import inspect
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

import pytest

from mppiisaac_tpu.ops.pallas import fused_physics as jfp
from mppiisaac_tpu.ops.pallas import lanes as JL
from mppiisaac_tpu.planner.mppi_isaac import MPPIisaacPlanner as JPlanner
from mppiisaac_tpu.runtime.sim import Simulation as JSim
from mppiisaac_tpu.scene.actor import ActorSpec as JSpec
from mppiisaac_tpu.tasks.panda_pick import PandaPickObjective as JPickObjective
from mppiisaac_tpu.tasks.panda_reach import PandaReachObjective as JObjective
from mppiisaac_tpu.utils.config_store import load_config as j_load

from mppiisaac_tpu_torch.convert import carry_from_jax, sim_state_from_jax
from mppiisaac_tpu_torch.ops import fused_physics as tfp
from mppiisaac_tpu_torch.ops.fused_rollout import FusedRollout, FusedWorldStep
from mppiisaac_tpu_torch.planner.mppi_isaac import MPPIisaacPlanner as TPlanner
from mppiisaac_tpu_torch.planner.objective import Objective
from mppiisaac_tpu_torch.planner.observables import SimView
from mppiisaac_tpu_torch.runtime.loop import run_task
from mppiisaac_tpu_torch.runtime.sim import Simulation as TSim
from mppiisaac_tpu_torch.runtime.sim import broadcast_state
from mppiisaac_tpu_torch.scene.actor import ActorSpec as TSpec
from mppiisaac_tpu_torch.tasks import (
    albert,
    anymal,
    mobile_push,
    mobile_reach,
    multi_robot,
    omni_panda_pick,
    panda_pick,
    panda_reach,
    panda_stick_push,
    point_robot,
)
from mppiisaac_tpu_torch.tasks.common import split_cli
from mppiisaac_tpu_torch.tasks.panda_reach import PandaReachObjective, success_fn
from mppiisaac_tpu_torch.utils.config_store import load_config as t_load

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# panda conf cut to K=64, H=8 (H stays above the Savitzky–Golay window of 7)
OVERRIDES = ["mppi.num_samples=64", "mppi.horizon=8"]


def test_planner_command_matches_jax():
    """Action and the next nominal U of one command, same world state, same ε.

    The JAX side rolls out on its XLA engine (the Pallas kernel in interpret
    mode is too slow here) with each control rounded through bf16 first, as
    the fused kernel rounds V (fused_rollout.py:366) — without that rounding
    the two differ by ~1e-3 in cost. Bound 1e-4 on the action: the costs
    agree to ~1e-6, and λ = 0.05 turns a cost error δ in a sample's
    discounted sum S (8 steps) into a relative weight error of δ/λ = 20δ; the
    update is a weighted mean of noise clipped to ±2, so the action may move
    by up to ~2·20·8·1e-6 ≈ 3e-4 in the worst case and far less in practice."""
    jc, tc = j_load("tasks/panda", OVERRIDES), t_load("tasks/panda", OVERRIDES)
    world = JSim(cfg=jc.isaacgym, actors=jc.actors, init_positions=jc.initial_actor_positions)
    gp = np.asarray(world.get_actor_position_by_name("goal"))[0].astype(np.float64)
    gp[:3] = jc.goal
    world.set_actor_position_by_name("goal", gp)
    rng = np.random.RandomState(4)
    for _ in range(3):
        world.apply_robot_cmd(rng.uniform(-1, 1, 7).astype(np.float32))
        world.step()
    jp = JPlanner(jc, JObjective(jc), use_fused=False)
    dynamics = jp.mppi.dynamics
    jp.mppi.dynamics = lambda st, u, t: dynamics(st, u.astype(jnp.bfloat16).astype(jnp.float32), t)
    carry = jp.mppi.carry
    _, sub = jax.random.split(carry.key)
    eps = np.array(jp.mppi._sample_noise(sub, carry.sigma))
    a_j, c_j, info_j = jp._full_command(carry, world.state)

    tp = TPlanner(tc, PandaReachObjective(tc), device="cpu")
    a_t, c_t, info_t = tp._full(carry_from_jax(carry), sim_state_from_jax(world.state),
                                eps=torch.tensor(eps))
    np.testing.assert_allclose(info_t["costs"].numpy(), np.asarray(info_j["costs"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), atol=1e-4)
    np.testing.assert_allclose(c_t.U.numpy(), np.asarray(c_j.U), atol=1e-4)
    vis_j = np.asarray(info_j["vis"])
    assert info_t["vis"].shape == vis_j.shape == (8, 64, 3)
    np.testing.assert_allclose(info_t["vis"].numpy(), vis_j, atol=4e-3)


def test_run_task_short_cpu_loop():
    cfg = t_load("tasks/panda", ["mppi.num_samples=32", "mppi.horizon=4"])
    seen = []
    m = run_task(cfg, PandaReachObjective(cfg), n_steps=3, success_fn=success_fn(),
                 observer=lambda step, world, action: seen.append((step, tuple(action.shape))),
                 device="cpu")
    assert m.steps == 3 and len(m.solver_time) == 3
    assert seen == [(0, (7,)), (1, (7,)), (2, (7,))]
    assert m.final_state_finite
    assert m.path_length == 0.0          # the fixed arm's root does not move


def test_pick_cost_matches_jax_kernel_cost():
    """The kernels' TASK_PANDA_PICK branch (the twin's task_cost) against
    PandaPickObjective.kernel_cost of the JAX package on the same K states,
    net contact forces included. Bound 1e-5 relative: the JAX kernel takes its
    pitch and yaw from a ~1e-6 rad polynomial atan, the port from atan2."""
    jc, tc = j_load("tasks/panda_pick"), t_load("tasks/panda_pick")
    tw = TSim(tc.isaacgym, tc.actors, tc.initial_actor_positions, device="cpu")
    jw = JSim(cfg=jc.isaacgym, actors=jc.actors, init_positions=jc.initial_actor_positions)
    ks = tfp.KernelScene.build(tw.built, tw.engine, panda_pick.PandaPickObjective(tc).kernel_cost(tw.built))
    rng = np.random.RandomState(7)
    K = 16
    s0 = tw.state.map(lambda x: x[0])
    q = (s0.q + torch.as_tensor(rng.uniform(-0.5, 0.5, (K, ks.ndof)), dtype=torch.float32))
    root = s0.root_state.expand(K, -1, -1).clone()
    root[:, :, 0:3] += torch.as_tensor(rng.uniform(-0.2, 0.2, (K, ks.nactor, 3)), dtype=torch.float32)
    st = tfp.rows_to_state(ks, tfp.state_to_rows(ks, root, q, torch.zeros_like(q)))
    st["net_cf"] = torch.as_tensor(rng.uniform(-50, 50, (K, ks.nbody, 3)), dtype=torch.float32)
    pos, quat, _, _, _ = tfp.fk(ks, st)
    got = tfp.task_cost(ks, st, pos, quat)
    view = _lane_view(jw.built.scene, ks, st)
    ref = np.asarray(JPickObjective(jc).kernel_cost(jw.built.scene)(view, 0))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


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


# the JAX kernel costs take a yaw from the polynomial atan (lanes
# atan2_tiles); its largest error against atan2 over random quaternions
YAW_POLY_ERR = 2e-6


def test_yaw_polynomial_error():
    """The error of the JAX kernels' polynomial yaw against atan2, which the
    port's kernels and twin use: below YAW_POLY_ERR rad (measured 1.3e-6 at
    this seed)."""
    rng = np.random.RandomState(11)
    q = rng.normal(size=(4096, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    got = np.asarray(JL.yaw_of(tuple(jnp.asarray(q[:, i]) for i in range(4))))
    ref = np.asarray(tfp.quat_to_yaw(torch.as_tensor(q)))
    err = np.abs(got - ref)
    err = np.minimum(err, 2 * np.pi - err)
    assert err.max() < YAW_POLY_ERR, err.max()


MOBILE = [("boxer_reach", "reach", "boxer"), ("heijn_reach", "reach", "heijn"),
          ("boxer_push", "push", "boxer"), ("heijn_push", "push", "heijn")]


def _objectives(kind, robot, jc, tc):
    from mppiisaac_tpu.tasks.mobile_push import MobilePushObjective as JPush
    from mppiisaac_tpu.tasks.mobile_reach import MobileReachObjective as JReach

    if kind == "reach":
        return JReach(jc, robot), mobile_reach.MobileReachObjective(tc, robot)
    ee = mobile_push.EE_LINK[robot]
    return JPush(jc, robot, ee), mobile_push.MobilePushObjective(tc, robot, ee)


@pytest.mark.parametrize("task,kind,robot", MOBILE)
def test_mobile_cost_matches_jax_kernel_cost(task, kind, robot):
    """The kernels' TASK_MOBILE_REACH / TASK_MOBILE_PUSH branches (the twin's
    task_cost, with each task's CostSpec) against the JAX objectives'
    kernel_cost on the same K states: random base and dof poses, block yaws
    over the whole circle, block velocities and net contact forces. Bound:
    rtol 1e-5 with atol 3·YAW_POLY_ERR + 1e-5 (the yaw term's weight is 3)."""
    jc, tc = j_load(f"tasks/{task}"), t_load(f"tasks/{task}")
    tw = TSim(tc.isaacgym, tc.actors, tc.initial_actor_positions, device="cpu")
    jw = JSim(cfg=jc.isaacgym, actors=jc.actors, init_positions=jc.initial_actor_positions)
    jobj, tobj = _objectives(kind, robot, jc, tc)
    ks = tfp.KernelScene.build(tw.built, tw.engine, tobj.kernel_cost(tw.built))
    rng = np.random.RandomState(8)
    K = 32
    s0 = tw.state.map(lambda x: x[0])
    q = s0.q + torch.as_tensor(rng.uniform(-1.0, 1.0, (K, ks.ndof)), dtype=torch.float32)
    root = s0.root_state.expand(K, -1, -1).clone()
    root[:, :, 0:2] += torch.as_tensor(rng.uniform(-1.5, 1.5, (K, ks.nactor, 2)), dtype=torch.float32)
    ang = rng.uniform(-np.pi, np.pi, (K, ks.nactor))
    root[:, :, 3:7] = torch.as_tensor(np.stack([0 * ang, 0 * ang, np.sin(ang / 2), np.cos(ang / 2)], -1),
                                      dtype=torch.float32)
    root[:, :, 7:13] = torch.as_tensor(rng.uniform(-1, 1, (K, ks.nactor, 6)), dtype=torch.float32)
    st = tfp.rows_to_state(ks, tfp.state_to_rows(ks, root, q, torch.zeros_like(q)))
    st["net_cf"] = torch.as_tensor(rng.uniform(-20, 20, (K, ks.nbody, 3)), dtype=torch.float32)
    pos, quat, _, _, _ = tfp.fk(ks, st)
    got = tfp.task_cost(ks, st, pos, quat)
    ref = np.asarray(jobj.kernel_cost(jw.built.scene)(_lane_view(jw.built.scene, ks, st), 0))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=3 * YAW_POLY_ERR + 1e-5)
    # the kernel branch is the objective's own cost where the two coincide
    # (single-body force actors, heijn's xy from its dofs)
    state = broadcast_state(s0, K).map(torch.Tensor.clone).replace(
        q=q, qd=torch.zeros_like(q), root_pos=st["root_pos"], root_quat=st["root_quat"],
        root_linvel=st["root_linvel"], root_angvel=st["root_angvel"])
    state = tw.engine.refresh(state).replace(net_contact_force=st["net_cf"])
    view = SimView(tw.built, state)
    np.testing.assert_allclose(tobj.compute_cost(view).numpy(), got.numpy(), rtol=1e-5, atol=1e-4)


def test_entry_points_default_to_cuda():
    """run_task, run_task_episodes, Simulation, MPPIisaacPlanner, the MPPI
    solver (MPPIPlanner), every task's run, the two-process examples' main
    (and their world loops) and the validate twin default to the card; a task CLI without device= asks
    for the card too, and on a machine without one it fails instead of
    falling back to the CPU."""
    from mppiisaac_tpu_torch import validate
    from mppiisaac_tpu_torch.examples import common as ex_common
    from mppiisaac_tpu_torch.examples.panda_pick import planner as pick_planner
    from mppiisaac_tpu_torch.examples.panda_pick import world as pick_world
    from mppiisaac_tpu_torch.examples.point_robot import planner as pr_planner
    from mppiisaac_tpu_torch.examples.point_robot import world as pr_world
    from mppiisaac_tpu_torch.mppi.solver import MPPIPlanner as TSolver
    from mppiisaac_tpu_torch.runtime.loop import run_task_episodes

    for fn in (run_task, run_task_episodes, TSim.__init__, TPlanner.__init__, TSolver.__init__,
               panda_reach.run,
               panda_pick.run, mobile_reach.run, mobile_push.run, point_robot.run,
               multi_robot.run, panda_stick_push.run, omni_panda_pick.run, pick_planner.main,
               pick_world.main, pr_planner.main, pr_world.main, pick_world.run, pr_world.run,
               ex_common.serve, ex_common.run_world, validate.main):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__
    rest, opts = split_cli(["mppi.horizon=2", "robot=heijn"], {"robot": "boxer", "device": "cuda"})
    assert rest == ["mppi.horizon=2"] and opts == {"robot": "heijn", "device": "cuda"}
    if not torch.cuda.is_available():
        proc = subprocess.run([sys.executable, "-m", "mppiisaac_tpu_torch.tasks.mobile_reach",
                               "mppi.num_samples=4", "mppi.horizon=2", "n_steps=1"],
                              cwd=REPO, capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0 and "CUDA" in proc.stderr, proc.stderr[-2000:]


def test_run_task_short_boxer_push_cpu_loop():
    """Two control steps of boxer_push on the CPU at K=8, H=2: the plain
    versions run the floating base, the stiction, couple and cc blocks (no
    kernel launch is counted), the boxer drives, the state stays finite and
    λ rows reach contact_lam."""
    cfg = t_load("tasks/boxer_push", ["mppi.num_samples=8", "mppi.horizon=2"])
    n1, n2 = FusedRollout.launches, FusedWorldStep.launches
    seen = []
    obj = mobile_push.MobilePushObjective(cfg, "boxer", "ee_link")
    m = run_task(cfg, obj, n_steps=2, success_fn=mobile_push.success_fn(obj.goal),
                 observer=lambda step, world, action: seen.append(
                     (step, tuple(action.shape), world.state.contact_lam.clone())),
                 device="cpu")
    assert m.steps == 2 and m.final_state_finite and m.success_step is None
    assert [x[:2] for x in seen] == [(0, (2,)), (1, (2,))]
    assert float(seen[-1][2].abs().max()) > 0.0, "no λ row reached contact_lam"
    assert (FusedRollout.launches, FusedWorldStep.launches) == (n1, n2)


def test_run_task_short_pick_cpu_loop():
    """Two control steps of panda_pick on the CPU at K=8, H=2: the plain
    versions run (no kernel launch is counted), the state stays finite and
    λ rows reach contact_lam."""
    cfg = t_load("tasks/panda_pick", ["mppi.num_samples=8", "mppi.horizon=2"])
    n1, n2 = FusedRollout.launches, FusedWorldStep.launches
    seen = []
    m = run_task(cfg, panda_pick.PandaPickObjective(cfg), n_steps=2,
                 success_fn=panda_pick.success_fn(),
                 observer=lambda step, world, action: seen.append(
                     (step, tuple(action.shape), world.state.contact_lam.shape)),
                 device="cpu")
    assert m.steps == 2 and m.final_state_finite and m.success_step is None
    assert [x[:2] for x in seen] == [(0, (9,)), (1, (9,))]
    assert (FusedRollout.launches, FusedWorldStep.launches) == (n1, n2)


# the new slices' loops: each task's own run, and whether its world carries λ
# rows within three steps (anymal drops from 1.2 m and lands later)
NEW_LOOPS = {
    "albert": (albert.run, {}, True),
    "anymal": (anymal.run, {}, False),
    "multi_jackal": (multi_robot.run, {"task": "multi_jackal"}, True),
    "point_robot": (point_robot.run, {}, False),
    "multi_pointbot": (multi_robot.run, {}, False),
    "panda_effort": (panda_reach.run, {"task": "panda_effort"}, False),
    "panda_stick_push": (panda_stick_push.run, {}, True),
    "omni_panda_pick": (omni_panda_pick.run, {}, True),
}


@pytest.mark.parametrize("task", sorted(NEW_LOOPS))
def test_run_task_short_cpu_loops_of_the_new_tasks(task):
    """Three control steps of each task through its own `run` on the CPU at
    K=16, H=4: the plain versions run the effort drives, the finger motor,
    the mesh-fitted robots, anymal's tape prior and the new cost hooks (no
    kernel launch is counted), the robot moves, the state stays finite, and
    where blocks are swept their λ rows reach contact_lam."""
    run, kw, swept = NEW_LOOPS[task]
    seen = []
    n1, n2 = FusedRollout.launches, FusedWorldStep.launches
    m = run(["mppi.num_samples=16", "mppi.horizon=4"], device="cpu", n_steps=3,
            observer=lambda step, world, action: seen.append(
                (world.state.q.clone(), world.state.contact_lam)), **kw)
    assert m.steps == 3 and m.final_state_finite and len(seen) == 3
    assert float((seen[-1][0] - seen[0][0]).abs().max()) > 1e-4, "the robot did not move"
    if swept:
        assert float(seen[-1][1].abs().max()) > 0.0, "no λ row reached contact_lam"
    assert (FusedRollout.launches, FusedWorldStep.launches) == (n1, n2)


def test_fused_rollout_refuses_unported_cost_hooks():
    """A task id outside TASKS (the kernels' cost branches) is refused by
    name instead of computing another cost."""
    cfg = t_load("tasks/panda", ["mppi.num_samples=8", "mppi.horizon=2"])
    world = TSim(cfg.isaacgym, cfg.actors, cfg.initial_actor_positions, device="cpu")
    spec = tfp.CostSpec(task=max(tfp.TASKS) + 1, ee_body=0, goal_actor=1, w_dist=1.0, w_ori=0.0)
    with pytest.raises(NotImplementedError, match="no CUDA cost"):
        FusedRollout(world.built, world.engine, spec, H=2, K=8)


def test_planner_passes_rollout_and_world_settings():
    """The planner hands rollout_sweeps, the rollout fidelity and the
    rollout manifold to K1 (fast fidelity with the reduced manifold: no λ
    rows, the rollout's own 8-sample tables); the world hands
    fused_world_sweeps to K2."""
    cfg = t_load("tasks/panda", ["mppi.num_samples=8", "mppi.horizon=2", "mppi.rollout_sweeps=3"])
    planner = TPlanner(cfg, PandaReachObjective(cfg), device="cpu")
    assert planner.mppi.fused.impulse_sweeps == 3
    cfg.isaacgym.fused_world_sweeps = 5
    world = TSim(cfg.isaacgym, cfg.actors, cfg.initial_actor_positions, device="cpu")
    assert world._world_step.impulse_sweeps == 5
    assert planner.mppi.fused.world_fidelity and planner.mppi.fused.manifold == "full"
    cfg = t_load("tasks/panda_pick", ["mppi.num_samples=8", "mppi.horizon=2",
                                      "mppi.rollout_fidelity=fast", "mppi.rollout_manifold=reduced"])
    fused = TPlanner(cfg, panda_pick.PandaPickObjective(cfg), device="cpu").mppi.fused
    assert not fused.world_fidelity and fused.manifold == "reduced"
    assert fused.tables.bbc_samples == 8 and fused.n_rows == fused.ks.n_state_rows


def _jax_pick_form(c):
    """A TASK_PANDA_PICK CostSpec written out as a JAX lanes cost."""

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


class _SpecObjective(Objective):
    def __init__(self, spec, jax_form=False):
        self.spec, self.jax_form = spec, jax_form

    def kernel_cost(self, scene_or_built):
        return _jax_pick_form(self.spec) if self.jax_form else self.spec


def test_planner_command_matches_jax_gripper():
    """One command of the port's planner on the mini-gripper grasp scene (a
    held ball: swept blocks, couple terms, binarize) against the JAX planner
    on its fused rollout in Pallas interpret mode, same world state (its
    contact_lam live), same ε. Bounds as the panda reach command test."""
    kw = [dict(type="robot", name="mini_gripper", fixed=True, gripper_binarize=True,
               init_pos=[0.0, 0.0, 0.5]),
          dict(type="sphere", name="ball", size=[0.02], mass=0.005, init_pos=[0.0, 0.0, 0.53],
               friction=1.0)]
    ov = ["mppi.num_samples=8", "mppi.horizon=8", "mppi.rollout_sweeps=2"]
    jc, tc = j_load("tasks/panda_pick", ov), t_load("tasks/panda_pick", ov)
    for c, spec in ((jc, JSpec), (tc, TSpec)):
        c.actors = [spec(**k) for k in kw]
        c.initial_actor_positions = None
        c.mppi.noise_sigma = [[0.5, 0.0], [0.0, 0.5]]
        c.mppi.u_min, c.mppi.u_max = [-1.0], [1.0]
    world = JSim(cfg=jc.isaacgym, actors=jc.actors, init_positions=None)
    ds = np.zeros((2, 2), np.float32)
    ds[:, 0] = 0.034
    world.set_dof_state(ds)
    for _ in range(3):
        world.apply_robot_cmd(np.array([-1.0, -1.0], np.float32))
        world.step()
    assert np.abs(np.asarray(world.state.contact_lam)).max() > 1e-6
    s = TSim(tc.isaacgym, tc.actors, None, device="cpu").scene
    ball = s.actor_index("ball")
    spec = tfp.CostSpec(task=tfp.TASK_PANDA_PICK, ee_body=s.body_offset[ball] - 1, goal_actor=0,
                        w_dist=1.0, w_ori=0.5, block_actor=ball, force_body0=s.body_offset[ball],
                        force_nbody=1, w_block=2.0, w_force=0.01)
    tp = TPlanner(tc, _SpecObjective(spec), device="cpu")
    jp = JPlanner(jc, _SpecObjective(spec, jax_form=True), use_fused=True)
    carry = jp.mppi.carry
    _, sub = jax.random.split(carry.key)
    eps = np.array(jp.mppi._sample_noise(sub, carry.sigma))
    a_j, c_j, info_j = jp._full_command(carry, world.state)
    a_t, c_t, info_t = tp._full(carry_from_jax(carry), sim_state_from_jax(world.state),
                                eps=torch.tensor(eps))
    np.testing.assert_allclose(info_t["costs"].numpy(), np.asarray(info_j["costs"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), atol=1e-4)
    np.testing.assert_allclose(c_t.U.numpy(), np.asarray(c_j.U), atol=1e-4)


_NO_JAX = r"""
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "yaml", "mppiisaac_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import torch
torch.set_num_threads(1)
from mppiisaac_tpu_torch.utils.config_store import load_config
from mppiisaac_tpu_torch.runtime.sim import Simulation
from mppiisaac_tpu_torch.planner.mppi_isaac import MPPIisaacPlanner
from mppiisaac_tpu_torch.tasks.panda_reach import PandaReachObjective
cfg = load_config("tasks/panda", ["mppi.num_samples=16", "mppi.horizon=2"])
world = Simulation(cfg.isaacgym, cfg.actors, cfg.initial_actor_positions, device="cpu")
planner = MPPIisaacPlanner(cfg, PandaReachObjective(cfg), device="cpu")
action = planner.compute_action_from_state(world.state)
world.apply_robot_cmd(action)
world.step()
assert not any(m.split(".")[0] in ("jax", "yaml", "mppiisaac_tpu") for m in sys.modules)
print("ACTION", tuple(action.shape), bool(torch.isfinite(action).all()))
"""


def test_port_runs_without_jax_or_yaml():
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ACTION (7,) True" in proc.stdout


def test_port_sources_import_no_jax():
    pat = re.compile(r"^\s*(import|from) (jax|mppiisaac_tpu)\b")
    hits = []
    for dirpath, _, files in os.walk(os.path.join(REPO, "mppiisaac_tpu_torch")):
        for fn in files:
            if fn.endswith(".py"):
                with open(os.path.join(dirpath, fn)) as f:
                    hits += [f"{fn}:{i}" for i, line in enumerate(f, 1) if pat.match(line)]
    assert not hits, hits
