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
* the next chunk's draws made during this chunk's replays against draws
  made on the spot, bit for bit across chunks and a new episode, and the
  cases that must draw on the spot: a new key, a replaced carry, a changed
  solver config, no next chunk;
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
from torch.profiler import ProfilerActivity, profile

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
from mppiisaac_tpu_torch.utils import profiling
from mppiisaac_tpu_torch.utils.config_store import load_config as t_load
from mppiisaac_tpu_torch.utils.profiling import spans

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
    stop there, and the chunk's world is rewound from step 7 to step 6.
    Without one, the planner's rollout sim also ends equal: the state the
    last command planned from, broadcast K-wide."""
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
        runs[n] = (m, seen, acts, world.state, planner.sim.state)
    (m1, s1, a1, w1, p1), (m4, s4, a4, w4, p4) = runs[1], runs[4]
    assert (m1.steps, m1.success_step, m1.path_length) == (m4.steps, m4.success_step,
                                                           m4.path_length)
    assert m1.steps == (12 if success_step is None else success_step + 1)
    assert len(s1) == len(s4) == m1.steps
    assert all(_equal_states(a, b) for a, b in zip(s1, s4))
    assert all(torch.equal(a, b) for a, b in zip(a1, a4[:len(a1)]))
    assert _equal_states(w1, w4)
    if success_step is None:
        assert _equal_states(p1, p4)
    # a chunk runs to its end: 8 commands for a success at step 6
    assert m4.commands == (12 if success_step is None else 8) and m1.commands == m1.steps
    assert not all(torch.equal(x.q, s1[0].q) for x in s1[1:])     # the robot moves


def test_a_later_run_leaves_what_a_run_handed_out():
    """The world state a run stores and the post-step states and actions
    it returns belong to no buffer of the chunk: a second run, which moves
    the world on, changes none of them."""
    cfg = t_load("tasks/point_robot", SMALL)
    world, planner = _build(cfg)
    chunk = DeviceChunk(world, planner, 4)
    states, actions = chunk.run(8)
    stored = world.state
    kept = ([s.map(torch.Tensor.clone) for s in states], stored.map(torch.Tensor.clone),
            actions.copy())
    chunk.run(4)
    assert not _equal_states(world.state, stored)
    assert all(_equal_states(a, b) for a, b in zip(states, kept[0], strict=True))
    assert _equal_states(stored, kept[1]) and np.array_equal(actions, kept[2])


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


def _spot(chunk):
    """A run that draws on the spot: whatever was drawn ahead is dropped."""

    def run(n_steps):
        chunk._ahead = None
        return chunk.run(n_steps)

    return run


def _runs(cfg, plan, spot):
    """point_robot in chunks of 4 through `plan`, a list of (seed, n_steps):
    a seed starts a new episode (the initial state, a carry keyed by it).
    → per run (states, actions, key, draws buffer, U), and the chunk."""
    world, planner = _build(cfg)
    initial, chunk = world.state, DeviceChunk(world, planner, 4)
    run = _spot(chunk) if spot else chunk.run
    out = []
    for seed, n_steps in plan:
        if seed is not None:
            world.state = initial
            planner.mppi.carry = dataclasses.replace(planner.mppi.init_carry(),
                                                     key=prng.prng_key(seed))
        states, actions = run(n_steps)
        c = planner.mppi.carry
        out.append((states, actions, c.key.copy(), chunk._draws.clone(), c.U.clone()))
    return out, chunk


def _equal_runs(a, b):
    for (sa, aa, ka, da, ua), (sb, ab, kb, db, ub) in zip(a, b, strict=True):
        assert len(sa) == len(sb) and all(_equal_states(x, y) for x, y in zip(sa, sb))
        assert np.array_equal(aa, ab) and np.array_equal(ka, kb)
        assert torch.equal(da, db) and torch.equal(ua, ub)


@pytest.mark.parametrize("overrides", [[], ["mppi.sampling_method=random"]])
def test_draws_ahead_equal_draws_on_the_spot(overrides):
    """Three chunks of an episode, then a new episode (another seed) of two:
    the chunk that draws the next chunk's noise during the replays against
    one that draws every chunk's on the spot, bit for bit (states, actions,
    the carry's key, the draw buffer, U). The first chunk of each episode
    draws on the spot, the others use what was drawn ahead."""
    cfg = t_load("tasks/point_robot", SMALL + overrides)
    plan = [(3, 12), (None, 8), (None, 4), (5, 6), (None, 2)]
    ahead, chunk = _runs(cfg, plan, spot=False)
    spot, ref = _runs(cfg, plan, spot=True)
    _equal_runs(ahead, spot)
    assert (chunk.draws_ahead_hits, chunk.draws_ahead_misses) == (3, 2)
    assert (ref.draws_ahead_hits, ref.draws_ahead_misses) == (0, 5)
    assert chunk._ahead is None                 # the episode's last chunk draws none ahead
    assert [len(a) for _, a, *_ in ahead] == [4, 4, 4, 4, 2]
    assert not np.array_equal(ahead[0][2], ahead[3][2])    # the seeds differ


def test_replaced_carry_draws_on_the_spot():
    """A carry set between two runs (another key) misses what was drawn
    ahead from the old key; its chunk equals one drawn on the spot."""
    cfg = t_load("tasks/point_robot", SMALL)
    runs = {}
    for spot in (False, True):
        world, planner = _build(cfg)
        chunk = DeviceChunk(world, planner, 4)
        run = _spot(chunk) if spot else chunk.run
        run(8)
        assert chunk._ahead is not None          # the next 4 commands' draws
        planner.mppi.carry = dataclasses.replace(planner.mppi.carry, key=prng.prng_key(99))
        states, actions = run(4)
        runs[spot] = (states, actions, chunk._draws.clone(), planner.mppi.carry.key.copy())
        if not spot:
            assert (chunk.draws_ahead_hits, chunk.draws_ahead_misses) == (0, 2)
    (s0, a0, d0, k0), (s1, a1, d1, k1) = runs[False], runs[True]
    assert all(_equal_states(x, y) for x, y in zip(s0, s1, strict=True))
    assert np.array_equal(a0, a1) and torch.equal(d0, d1) and np.array_equal(k0, k1)
    key, draws = planner.mppi.draws(prng.prng_key(99), 4)
    assert torch.equal(d0, torch.from_numpy(draws)) and np.array_equal(k0, key)


def test_changed_config_draws_on_the_spot():
    """An `update_mppi_params` that changes the solver's config (not its
    structure) between two runs misses what was drawn ahead; the same key
    and count drawn under the same config hit."""
    cfg = t_load("tasks/point_robot", SMALL)
    world, planner = _build(cfg)
    chunk = DeviceChunk(world, planner, 4)
    chunk.run(12)
    chunk.run(8)
    assert (chunk.draws_ahead_hits, chunk.draws_ahead_misses) == (1, 1)
    planner.update_mppi_params({"noise_abs_cost": not cfg.mppi.noise_abs_cost})
    assert planner.mppi is chunk._mppi
    key = planner.mppi.carry.key.copy()
    chunk.run(4)
    assert (chunk.draws_ahead_hits, chunk.draws_ahead_misses) == (1, 2)
    assert torch.equal(chunk._draws, torch.from_numpy(planner.mppi.draws(key, 4)[1]))


@pytest.mark.parametrize("n_steps", [1, 3, 4])
def test_no_draws_ahead_without_a_next_chunk(n_steps):
    """A run of n_steps ≤ N (an episode's last chunk, the benchmark's warm
    run(3)) draws nothing ahead and records no `chunk.ahead` span; the run
    after it draws on the spot."""
    cfg = t_load("tasks/point_robot", SMALL)
    world, planner = _build(cfg)
    chunk = DeviceChunk(world, planner, 4)
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        chunk.run(n_steps)
        chunk.run(4)
    names = [(r.name, r.attrs) for r in spans()]
    profiling.clear()
    assert chunk._ahead is None and "chunk.ahead" not in {n for n, _ in names}
    assert [a for n, a in names if n == "chunk.draws"] == [{"ahead": 0}] * 2
    assert (chunk.draws_ahead_hits, chunk.draws_ahead_misses) == (0, 2)


def test_draws_ahead_counts_over_episodes():
    """`_run_chunked` over 10 steps in chunks of 4 (4, 4, 2), twice from a
    new key: per episode one miss and two hits, the `ahead` attribute of
    each `chunk.draws` span as counted, and the next chunk's draws under
    `chunk.ahead` inside the chunk's `loop.chunk`."""
    cfg = t_load("tasks/point_robot", SMALL)
    world, planner = _build(cfg)
    initial, chunk = world.state, DeviceChunk(world, planner, 4)
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for seed in (1, 2):
            world.state = initial
            planner.mppi.carry = dataclasses.replace(planner.mppi.init_carry(),
                                                     key=prng.prng_key(seed))
            m = _run_chunked(chunk, 10, cfg.isaacgym.dt)
            assert m.steps == 10 and m.commands == 10
    recs = spans()
    profiling.clear()
    assert (chunk.draws_ahead_hits, chunk.draws_ahead_misses) == (4, 2)
    assert [r.attrs["ahead"] for r in recs if r.name == "chunk.draws"] == [0, 1, 1] * 2
    ahead = [r for r in recs if r.name == "chunk.ahead"]
    assert len(ahead) == 4
    assert all(recs[r.parent].name == "loop.chunk" for r in ahead)


@pytest.mark.parametrize("workload, metric", [("panda_pick.chunked", "draws_ahead_pct"),
                                              ("anymal.chunked", "draws_ahead_pct"),
                                              ("panda_reach.chunked",
                                               "draws_ahead_pct.host_bound")])
def test_draws_ahead_pct_reads_the_program_spans(workload, metric):
    """The benchmark's reader over a profiled episode's spans: 10 steps in
    chunks of 4 read 2 of 3 chunks drawn ahead; spans without the `ahead`
    attribute (a program that draws on the spot) and a run without a trace
    read nothing."""
    from cellbench.profiling import Trace
    from cellbench.spec import load_cell

    cell = load_cell(workload)
    read = cell.reader(next(m for m in cell.per_layer if m.name == metric))
    assert metric in {m.name for m in cell.per_layer}
    cfg = t_load("tasks/point_robot", SMALL)
    world, planner = _build(cfg)
    profiling.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            _run_chunked(DeviceChunk(world, planner, 4), 10, cfg.isaacgym.dt)
        assert read({"trace": Trace()}) == pytest.approx(200 / 3)
        assert read({}) is None
        for r in spans():
            r.attrs.pop("ahead", None)
        assert read({"trace": Trace()}) is None
    finally:
        profiling.clear()
    assert read({"trace": Trace()}) is None
