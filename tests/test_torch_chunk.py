"""The chunked control loop of the port (`runtime/loop.DeviceChunk`,
`run_task(device_steps=N)`, `run_task_episodes(device_steps=N)`) and the
capturable solver pieces it rests on, on the CPU (where the chunk runs its
step eagerly):

* the chunk against the per-step loop, bit for bit: world states, actions,
  steps, path length and success step, with a success inside a chunk and
  the world rewound to it;
* the chunk against the JAX package's `_build_chunk` from the same state
  and seed (the JAX planner on its XLA rollout, controls rounded through
  bf16 as the fused kernel rounds them);
* the gait tape from the solver's device step clock against an int clock
  and against the JAX prior; the Savitzky–Golay matrix against the JAX
  loop; a chunk's draws made ahead against per-command draws and
  `jax.random`;
* ports of tests/test_end_to_end.py:15-47, episodes at device_steps=4
  against device_steps=1, `update_weights` seen by the next chunk, and a
  structural `update_mppi_params` refused by the old chunk;
* device_steps reaching `run_task` from every task's run.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppiisaac_tpu.mppi.solver import MPPIPlanner as JSolver
from mppiisaac_tpu.planner.mppi_isaac import MPPIisaacPlanner as JPlanner
from mppiisaac_tpu.planner.observables import SimView as JView
from mppiisaac_tpu.planner.priors import QuadrupedGaitPrior as JPrior
from mppiisaac_tpu.runtime import loop as jloop
from mppiisaac_tpu.runtime.sim import Simulation as JSim
from mppiisaac_tpu.tasks.point_robot import PointRobotObjective as JPointObjective
from mppiisaac_tpu.utils.config_store import load_config as j_load

from mppiisaac_tpu_torch.convert import sim_state_from_jax
from mppiisaac_tpu_torch.mppi import prng
from mppiisaac_tpu_torch.mppi.solver import MPPIPlanner as TSolver
from mppiisaac_tpu_torch.physics.types import SIM_STATE_FIELDS
from mppiisaac_tpu_torch.planner.mppi_isaac import MPPIisaacPlanner as TPlanner
from mppiisaac_tpu_torch.planner.observables import SimView as TView
from mppiisaac_tpu_torch.planner.priors import QuadrupedGaitPrior as TPrior
from mppiisaac_tpu_torch.runtime import loop as tloop
from mppiisaac_tpu_torch.runtime.loop import (DeviceChunk, _run_chunked, goal_world, run_steps,
                                              run_task, run_task_episodes)
from mppiisaac_tpu_torch.tasks import point_robot
from mppiisaac_tpu_torch.tasks.point_robot import PointRobotObjective
from mppiisaac_tpu_torch.utils.config_store import load_config as t_load

from test_torch_prior import STATES, TAPE_ATOL, _state, _worlds
from test_torch_solver import _JStub, _TStub

torch.set_num_threads(1)
SMALL = ["mppi.num_samples=16", "mppi.horizon=4"]
# the port's chunk against the JAX package's: actions and world q, qd per
# step, as tests/test_torch_slice.py holds one command (1e-4); measured over
# these 12 steps: actions 2.9e-5, q 4.5e-6, qd 2.9e-5
JAX_CHUNK_ATOL = 1e-4


def _equal_states(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in SIM_STATE_FIELDS if getattr(a, f) is not None)


def _build(cfg):
    world = goal_world(cfg, "cpu")
    return world, TPlanner(cfg, PointRobotObjective(cfg), randomize=False, device="cpu")


def _success_at(step):
    """A success test that holds at its (step + 1)-th call, keeping the
    states it saw."""
    seen = []

    def success(world):
        seen.append(world.state.map(torch.Tensor.clone))
        return len(seen) == step + 1

    return success, seen


@pytest.mark.parametrize("success_step", [None, 6])
def test_chunk_equals_the_per_step_loop(success_step):
    """point_robot at K=16, H=4: chunks of 4 over 12 steps against the
    per-step loop. With a success at step 6 (inside the second chunk) both
    stop there, and the chunk's world is rewound from step 7 to step 6."""
    cfg = t_load("tasks/point_robot", SMALL)
    runs = {}
    for n in (1, 4):
        world, planner = _build(cfg)
        succ, seen = _success_at(-1 if success_step is None else success_step)
        acts = []
        if n == 1:
            m = run_steps(world, planner.compute_action_from_state, 12, cfg.isaacgym.dt,
                          success_fn=succ, observer=lambda s, w, a: acts.append(a.clone()))
        else:
            m = _run_chunked(DeviceChunk(world, planner, n), 12, cfg.isaacgym.dt,
                             success_fn=succ,
                             chunk_observer=lambda s, w, a: acts.append(torch.from_numpy(a)))
        runs[n] = (m, seen, acts, world.state)
    (m1, s1, a1, w1), (m4, s4, a4, w4) = runs[1], runs[4]
    assert (m1.steps, m1.success_step, m1.path_length) == (m4.steps, m4.success_step,
                                                           m4.path_length)
    assert m1.steps == (12 if success_step is None else success_step + 1)
    assert len(s1) == len(s4) == m1.steps
    assert all(_equal_states(a, b) for a, b in zip(s1, s4))
    assert all(torch.equal(a, b) for a, b in zip(a1, a4[:len(a1)]))
    assert _equal_states(w1, w4)
    # a chunk runs to its end: 8 commands for a success at step 6
    assert m4.commands == (12 if success_step is None else 8) and m1.commands == m1.steps
    assert not all(torch.equal(x.q, s1[0].q) for x in s1[1:])     # the robot moves


def test_chunk_matches_jax_build_chunk():
    """Three chunks of 4 from the same world state and seed: the port's
    DeviceChunk against the JAX package's `_build_chunk` (its planner at
    use_fused=False on its XLA rollout and world step)."""
    jc, tc = j_load("tasks/point_robot", SMALL), t_load("tasks/point_robot", SMALL)
    jworld = JSim(cfg=jc.isaacgym, actors=jc.actors, init_positions=jc.initial_actor_positions)
    jp = JPlanner(jc, JPointObjective(jc), randomize=False, use_fused=False)
    dynamics = jp.mppi.dynamics
    jp.mppi.dynamics = lambda st, u, t: dynamics(st, u.astype(jnp.bfloat16).astype(jnp.float32), t)
    jp.mppi.retrace()
    chunk, unpack = jloop._build_chunk(jc, jworld, jp, 4)
    world, planner = _build(tc)
    world.state = sim_state_from_jax(jworld.state)
    tchunk = DeviceChunk(world, planner, 4)
    carry, wstate = jp.mppi.carry, jworld.state
    worst = {"action": 0.0, "q": 0.0, "qd": 0.0}
    for _ in range(3):
        carry, wstate, packed = chunk(carry, wstate)
        j_states, j_acts = unpack(np.asarray(packed))
        t_states, t_acts = tchunk.run(4)
        np.testing.assert_array_equal(planner.mppi.carry.key, np.asarray(carry.key))
        for js, ts, ja, ta in zip(j_states, t_states, j_acts, t_acts):
            worst["action"] = max(worst["action"], float(np.abs(ta - ja).max()))
            worst["q"] = max(worst["q"], float(np.abs(ts.q.numpy() - np.asarray(js.q)).max()))
            worst["qd"] = max(worst["qd"], float(np.abs(ts.qd.numpy() - np.asarray(js.qd)).max()))
    assert max(worst.values()) <= JAX_CHUNK_ATOL, worst
    assert int(planner.mppi.carry.t0) == int(carry.t0) == 12


@pytest.mark.parametrize("case", range(len(STATES)))
def test_tape_from_the_device_clock(case):
    """The gait tape from the solver's 0-d int64 step clock equals the tape
    from an int clock, bit for bit, and the JAX prior's."""
    jc, jw, tb = _worlds()
    base_xy, yaw, goal_xy, t0 = STATES[case]
    js = _state(jw, np.random.RandomState(case), base_xy, yaw, goal_xy)
    kw = dict(H=jc.mppi.horizon, dt=jc.isaacgym.dt)
    prior, view = TPrior(**kw), TView(tb, sim_state_from_jax(js))
    got = prior.tape(view, torch.tensor(t0, dtype=torch.int64))
    assert torch.equal(got, prior.tape(view, t0))
    ref = np.asarray(JPrior(**kw).tape(JView(jw.built, js), jnp.asarray(t0, jnp.int32)))
    np.testing.assert_allclose(got.numpy(), ref, atol=TAPE_ATOL)


@pytest.mark.parametrize("task", ["panda", "point_robot", "albert"])
def test_savgol_matrix_matches_the_jax_loop(task):
    """The solver's (H, H) Savitzky–Golay matrix against the JAX solver's
    loop over the edge-padded sequence (solver.py:272-282), atol 1e-6, at
    H = 12, 20 and 8 (windows 9, 9 and 7)."""
    jc, tc = j_load(f"tasks/{task}"), t_load(f"tasks/{task}")
    jp = JSolver(jc.mppi, jc.nx, dynamics=None, running_cost=None, fused=_JStub())
    tp = TSolver(tc.mppi, tc.nx, fused=_TStub(), device="cpu")
    H, nu = tp.cfg.horizon, tp.nu
    assert jp._sg is not None and tp._sg.shape == (H, H)
    U = jnp.asarray(np.random.RandomState(3).uniform(-1, 1, (H, nu)), jnp.float32)
    half = jp._sg.shape[0] // 2
    Upad = jnp.concatenate([U[:1].repeat(half, 0), U, U[-1:].repeat(half, 0)], 0)
    ref = jnp.stack([jnp.einsum("w,wn->n", jp._sg,
                                jax.lax.dynamic_slice_in_dim(Upad, t, jp._sg.shape[0], 0))
                     for t in range(H)])
    got = tp._sg @ torch.as_tensor(np.array(U))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("overrides", [[], ["mppi.sampling_method=random"]])
def test_draws_ahead_equal_per_command_draws(overrides):
    """A chunk's draws, made ahead on the host, against the draws of
    commands one by one: the same bits, the same noise, the same key after,
    and JAX's key chain and uniforms."""
    tc = t_load("tasks/point_robot", SMALL + overrides)
    tp = TSolver(tc.mppi, tc.nx, fused=_TStub(), device="cpu")
    key0 = tp.carry.key
    key, draws = tp.draws(key0, 5)
    k, jk = key0, jax.random.PRNGKey(int(tc.mppi.seed_val))
    for i in range(5):
        k, sub = prng.split(k)
        jk, jsub = jax.random.split(jk)
        np.testing.assert_array_equal(draws[i], tp._draw_np(sub))
        assert torch.equal(tp.noise(torch.from_numpy(draws[i]), tp.carry.sigma),
                           tp.noise(torch.from_numpy(tp._draw_np(sub)), tp.carry.sigma))
        if tp.cfg.sampling_method == "halton":
            np.testing.assert_array_equal(draws[i], np.asarray(
                jax.random.uniform(jsub, (tp._sample_dims,))))
    np.testing.assert_array_equal(key, k)
    np.testing.assert_array_equal(key, np.asarray(jk))


def test_point_robot_reaches_the_goal_chunked():
    """Port of test_end_to_end.py:15-25 (H cut to 6, as
    tests/test_torch_episodes.py, to keep the plain rollout short)."""
    m = point_robot.run(overrides=["mppi.num_samples=64", "mppi.horizon=6", "n_steps=60"],
                        randomize=False, device_steps=8, device="cpu")
    assert m.success_step is not None and m.final_state_finite, m.summary()


def test_chunk_observer_sees_every_step():
    """Port of test_end_to_end.py:28-47: the chunk observer gets steps 0-15
    with a Simulation-like view pinned to each post-step state."""
    cfg = t_load("tasks/point_robot", ["mppi.num_samples=32", "mppi.horizon=6"])
    seen = []

    def obs(step, world, action):
        q = world.view.actor_q("point_robot")[0]
        seen.append((step, float(q[0]), np.asarray(action).shape))

    m = run_task(cfg, PointRobotObjective(cfg), n_steps=16, randomize=False, device_steps=8,
                 chunk_observer=obs, device="cpu")
    assert m.steps == 16 and [s for s, _, _ in seen] == list(range(16))
    assert all(shape == (3,) for _, _, shape in seen)
    assert abs(seen[-1][1] - seen[0][1]) > 1e-4


def test_episodes_chunked_equal_per_step():
    """run_task_episodes at device_steps=4 against device_steps=1, seeds
    [0, 1]: the same metrics and world states, step by step."""
    cfg = t_load("tasks/point_robot", SMALL)
    out = {}
    for n in (1, 4):
        states = []

        def record(world, states=states):
            states.append(world.state.map(torch.Tensor.clone))
            return False

        rs = run_task_episodes(cfg, PointRobotObjective(cfg), seeds=[0, 1], n_steps=6,
                               success_fn=record, randomize=False, device_steps=n, device="cpu")
        out[n] = (rs, states)
    (r1, s1), (r4, s4) = out[1], out[4]
    for seed in (0, 1):
        assert r1[seed].summary() | {"mean_fps": 0, "mean_rt": 0, "mean_solver_time_ms": 0} \
            == r4[seed].summary() | {"mean_fps": 0, "mean_rt": 0, "mean_solver_time_ms": 0}
    assert len(s1) == len(s4) == 12 and all(_equal_states(a, b) for a, b in zip(s1, s4))
    assert not _equal_states(s1[5], s1[11])      # the seeds differ


def test_update_weights_reaches_the_next_chunk_and_a_rebuild_refuses_it():
    cfg = t_load("tasks/point_robot", SMALL)
    world, planner = _build(cfg)
    chunk = DeviceChunk(world, planner, 4)
    chunk.run(4)
    carry, state = planner.mppi.carry, world.state

    def from_saved():
        planner.mppi.carry, world.state = carry, state
        return chunk.run(4)[1]

    a = from_saved()
    assert np.array_equal(a, from_saved())
    planner.update_weights({"nav": 0.1, "obstacle": 0.5, "coll": 0.2})
    b = from_saved()
    assert not np.allclose(a, b)
    planner.update_mppi_params({"horizon": 3})
    with pytest.raises(RuntimeError, match="rebuilt"):
        chunk.run(4)


def test_device_steps_reaches_run_task_from_every_task(monkeypatch):
    """Each of the 14 task configs' `run` passes device_steps on to
    `run_task`."""
    from mppiisaac_tpu_torch.tasks import (albert, anymal, mobile_push, mobile_reach, multi_robot,
                                           omni_panda_pick, panda_pick, panda_reach,
                                           panda_stick_push)

    got = []
    monkeypatch.setattr(tloop, "run_task", lambda *a, **kw: got.append(kw["device_steps"]))
    runs = [(point_robot.run, {}), (multi_robot.run, {}),
            (multi_robot.run, {"task": "multi_jackal"}), (panda_reach.run, {}),
            (panda_reach.run, {"task": "panda_effort"}), (panda_pick.run, {}),
            (omni_panda_pick.run, {}), (panda_stick_push.run, {}), (albert.run, {}),
            (anymal.run, {})]
    runs += [(fn, {"robot": r}) for fn in (mobile_reach.run, mobile_push.run)
             for r in ("heijn", "boxer")]
    for i, (fn, kw) in enumerate(runs):
        fn(device="cpu", device_steps=i + 2, **kw)
    assert len(runs) == 14 and got == [i + 2 for i in range(14)]


def test_solver_carry_clock_and_reset():
    """The carry's step clock is a 0-d int64 tensor on the solver's device,
    advanced by u_per_command per command; `reset` gives a fresh carry."""
    tc = t_load("tasks/point_robot", SMALL)
    tp = TSolver(tc.mppi, tc.nx, fused=_TStub(), device="cpu")
    assert tp.carry.t0.dtype == torch.int64 and tp.carry.t0.shape == ()
    for _ in range(3):
        _, tp.carry, _ = tp._command_impl(tp.carry, (None, None))
    assert int(tp.carry.t0) == 3 * tp.cfg.u_per_command
    tp.reset()
    assert int(tp.carry.t0) == 0 and np.array_equal(tp.carry.key, prng.prng_key(tc.mppi.seed_val))
    assert dataclasses.fields(tp.carry)[3].name == "t0"
