"""The panda reach and panda pick slices end to end: one planner command of
the port against the JAX planner from the same world state with the same
injected noise (panda reach on the XLA rollout; the mini-gripper grasp scene
on the fused Pallas rollout in interpret mode), the pick cost hook against
the JAX objective's kernel cost, short control loops of the port on the CPU,
the planner and world wiring of the rollout and world-step settings, and the
port running without JAX or PyYAML installed."""
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
from mppiisaac_tpu_torch.runtime.loop import run_task
from mppiisaac_tpu_torch.runtime.sim import Simulation as TSim
from mppiisaac_tpu_torch.scene.actor import ActorSpec as TSpec
from mppiisaac_tpu_torch.tasks import panda_pick
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

    tp = TPlanner(tc, PandaReachObjective(tc))
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
    tw = TSim(tc.isaacgym, tc.actors, tc.initial_actor_positions)
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

    def tiles(x):
        return tuple(jnp.asarray(x[..., i].numpy()) for i in range(x.shape[-1]))

    jst = {"root_pos": [tiles(st["root_pos"][:, a]) for a in range(ks.nactor)],
           "root_quat": [tiles(st["root_quat"][:, a]) for a in range(ks.nactor)],
           "root_linvel": [tiles(st["root_linvel"][:, a]) for a in range(ks.nactor)],
           "root_angvel": [tiles(st["root_angvel"][:, a]) for a in range(ks.nactor)],
           "q": list(tiles(st["q"])), "qd": list(tiles(st["qd"]))}
    jpos, jquat, jlinv, jangv, _ = jfp.fk_lanes(jw.built.scene, jst)
    view = jfp.LaneView(jw.built.scene, jpos, jquat, jlinv, jangv,
                        [tiles(st["net_cf"][:, b]) for b in range(ks.nbody)], jst["q"], jst["qd"],
                        jst["root_pos"], jst["root_quat"], jst["root_linvel"])
    ref = np.asarray(JPickObjective(jc).kernel_cost(jw.built.scene)(view, 0))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


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


def test_planner_passes_rollout_and_world_settings():
    """The planner hands rollout_sweeps to K1 and refuses fast fidelity by
    name; the world hands fused_world_sweeps to K2."""
    cfg = t_load("tasks/panda", ["mppi.num_samples=8", "mppi.horizon=2", "mppi.rollout_sweeps=3"])
    planner = TPlanner(cfg, PandaReachObjective(cfg))
    assert planner.mppi.fused.impulse_sweeps == 3
    cfg.isaacgym.fused_world_sweeps = 5
    world = TSim(cfg.isaacgym, cfg.actors, cfg.initial_actor_positions)
    assert world._world_step.impulse_sweeps == 5
    cfg = t_load("tasks/panda", ["mppi.num_samples=8", "mppi.horizon=2", "mppi.rollout_fidelity=fast"])
    with pytest.raises(NotImplementedError, match="fast"):
        TPlanner(cfg, PandaReachObjective(cfg))


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
    s = TSim(tc.isaacgym, tc.actors, None).scene
    ball = s.actor_index("ball")
    spec = tfp.CostSpec(task=tfp.TASK_PANDA_PICK, ee_body=s.body_offset[ball] - 1, goal_actor=0,
                        w_dist=1.0, w_ori=0.5, block_actor=ball, force_body0=s.body_offset[ball],
                        force_nbody=1, w_block=2.0, w_force=0.01)
    tp = TPlanner(tc, _SpecObjective(spec))
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
