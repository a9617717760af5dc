"""The port's batched world step (`Simulation.step` with num_envs > 1: one
launch of K2 over all envs, its plain version here on the CPU) against the
JAX package, and each env of a batch against its own one-env step.

* The balls demo's scene (4 spheres of radius 0.1 m, dt 0.02, 2 substeps) at
  N=3 against JAX's batched `Simulation` (its XLA engine under vmap): every
  ball height within 1e-5 m over the first 20 steps (measured 9e-8: both
  fall, land and rest the same way) and every root position within 2 cm at
  each of 100 steps (the documented gap between the Pallas device code and
  the XLA engine with sweeps on, tests/test_impulse_parity.py; measured
  1.2e-3 m, the landed balls rolling apart in x).
* A randomized point_robot / block / goal batch (N=4, per-env mass and
  friction) with a command pushing the robot into the block: every field
  of every env equals the one-env step of that env's state and params, bit
  for bit, at every step.
* tests/test_runtime.py's `test_sim_wrapper_api` and
  tests/test_scene_features.py's `test_add_to_envs_rebuild` on the port,
  against the JAX results.

tests/test_torch_balls.py holds the balls batch against the Pallas kernel
and the demo against the JAX demo.
"""
import numpy as np
import torch

from mppiisaac_tpu.runtime.sim import Simulation as JSim
from mppiisaac_tpu.scene.actor import ActorSpec as JActor
from mppiisaac_tpu.scene.builder import SimConfig as JConfig

from mppiisaac_tpu_torch.examples import balls_demo
from mppiisaac_tpu_torch.physics.types import SIM_STATE_FIELDS
from mppiisaac_tpu_torch.runtime.sim import Simulation as TSim
from mppiisaac_tpu_torch.scene.builder import SimConfig as TConfig

torch.set_num_threads(1)
N_ENVS = 3
HEIGHT_ATOL, HEIGHT_STEPS = 1e-5, 20
POS_ATOL, POS_STEPS = 2e-2, 100
# tests/test_runtime.py and test_scene_features.py, each on 1 substep: the
# point robot's joints and every root position (the added box, resting at
# zero depth for one step, measured 2.4e-7 m apart)
RUNTIME_ATOL = 1e-5


def jax_balls(num_envs):
    actors = [JActor(**vars(a)) for a in balls_demo.ball_actors(4)]
    return JSim(JConfig(**balls_demo.BALLS_CONFIG), actors, num_envs=num_envs)


def test_balls_batch_matches_jax_batched_sim():
    js = jax_balls(N_ENVS)
    ts = balls_demo.balls_sim(N_ENVS, 4, device="cpu")
    worst_z, worst_pos = 0.0, 0.0
    for step in range(POS_STEPS):
        js.step()
        ts.step()
        d = np.abs(np.asarray(js.state.root_pos) - ts.state.root_pos.numpy())
        if step < HEIGHT_STEPS:
            worst_z = max(worst_z, float(d[..., 2].max()))
            assert worst_z <= HEIGHT_ATOL, (step, worst_z)
        worst_pos = max(worst_pos, float(d.max()))
        assert worst_pos <= POS_ATOL, (step, worst_pos)
    assert np.all(ts.state.root_pos[..., 2].numpy() < 0.11), "the balls did not land"


def test_batch_equals_one_env_steps_bit_for_bit():
    """Here the plain version steps the batch; below one SIMD vector of
    envs (N < 8) torch runs the same scalar loops on the batch as on one env,
    so the bits agree (from 16 envs its vectorized kernels may round
    differently in the last bit). The kernel on the card runs the same warp
    code for every env at any N: chip_smoke.py phase 17e and
    tests/test_torch_cuda.py hold its batches bit for bit."""
    sim = TSim(TConfig(dt=0.05, substeps=1), ["point_robot", "block", "goal"], num_envs=4,
               randomize=True, seed=3, device="cpu")
    assert float(sim.params.body_mass_scale.std(0).max()) > 0.01, "envs' params do not differ"
    sim.set_actor_position_by_name("block", [0.45, 0.0, 0.1])    # in front of the robot
    u = np.random.RandomState(0).uniform(-1, 1, (4, 3)).astype(np.float32)
    u[:, 0] = 1.0                                                # push along +x
    sim.apply_robot_cmd(u)
    fw = sim._world_step
    start = sim.state.root_pos[:, 1, 0].clone()
    for step in range(6):
        before = sim.state
        sim.step()
        for e in range(4):
            one = fw.step(before.map(lambda x: x[e]), sim.params.map(lambda x: x[e]))
            for f in SIM_STATE_FIELDS:
                a = getattr(one, f)
                if a is not None:
                    assert torch.equal(a, getattr(sim.state, f)[e]), (step, e, f)
    assert float(sim.state.contact_lam.abs().max()) > 0.0, "no λ row carried an impulse"
    assert float((sim.state.root_pos[:, 1, 0] - start).abs().max()) > 1e-3, "the block never moved"


def test_sim_wrapper_api_matches_jax():
    """tests/test_runtime.py::test_sim_wrapper_api on the port, each result
    against the JAX package's."""
    sims = [cls(cfg(dt=0.05, substeps=1), actors=["point_robot", "goal"], num_envs=3, **kw)
            for cls, cfg, kw in ((JSim, JConfig, {}), (TSim, TConfig, {"device": "cpu"}))]
    for s in sims:
        assert tuple(s.dof_state.shape) == (3, 3, 2)
        assert tuple(s.root_state.shape[1:]) == (2, 13)
        s.apply_robot_cmd(np.array([1.0, 0.0, 0.0]))
        s.step()
    js, ts = sims
    assert float(ts.dof_state[0, 0, 1]) > 0.05          # moving +x
    np.testing.assert_allclose(ts.dof_state.numpy(), np.asarray(js.dof_state), rtol=0,
                               atol=RUNTIME_ATOL)
    assert tuple(ts.get_actor_position_by_name("goal").shape) == (3, 3)
    for s in sims:
        s.set_actor_position_by_name("goal", np.array([1.0, 2.0, 0.5]))
    np.testing.assert_allclose(ts.get_actor_position_by_name("goal").numpy()[0], [1, 2, 0.5])
    snaps = [s.save_state() for s in sims]
    for s in sims:
        for _ in range(3):
            s.step()
    moved = ts.dof_state.numpy().copy()
    np.testing.assert_allclose(moved, np.asarray(js.dof_state), rtol=0, atol=RUNTIME_ATOL)
    for s, snap in zip(sims, snaps):
        s.restore_state(snap)
    assert torch.equal(ts.dof_state, snaps[1].dof_state)
    assert not np.array_equal(moved, snaps[1].dof_state.numpy())
    for s in sims:
        s.reset_robot_state([0.5, 0.25, 0.1], [0, 0, 0])
    np.testing.assert_allclose(ts.dof_state.numpy()[:, :, 0], np.tile([0.5, 0.25, 0.1], (3, 1)),
                               atol=1e-6)
    np.testing.assert_allclose(ts.dof_state.numpy(), np.asarray(js.dof_state), rtol=0, atol=1e-6)


def test_add_to_envs_then_step_matches_jax():
    """tests/test_scene_features.py::test_add_to_envs_rebuild on the port,
    against the JAX package's states."""
    box = {"type": "box", "name": "new_obstacle", "size": [0.2, 0.2, 0.4],
           "init_pos": [1.5, 0.0, 0.2], "mass": 2.0}
    sims = [cls(cfg(dt=0.05, substeps=1), ["point_robot", "goal"], num_envs=2, **kw)
            for cls, cfg, kw in ((JSim, JConfig, {}), (TSim, TConfig, {"device": "cpu"}))]
    for s in sims:
        s.apply_robot_cmd(np.array([1.0, 0, 0]))
        for _ in range(5):
            s.step()
    js, ts = sims
    q_before = ts.state.q.clone()
    np.testing.assert_allclose(q_before.numpy(), np.asarray(js.state.q), rtol=0,
                               atol=RUNTIME_ATOL)
    n_actors = ts.root_state.shape[1]
    for s in sims:
        s.add_to_envs([dict(box)])
    assert ts.root_state.shape[1] == n_actors + 1
    torch.testing.assert_close(ts.state.q, q_before, rtol=0, atol=1e-6)
    for s in sims:
        s.step()                                        # the new scene steps
    assert bool(torch.isfinite(ts.root_state).all())
    np.testing.assert_allclose(ts.root_state.numpy()[..., :3], np.asarray(js.root_state)[..., :3],
                               rtol=0, atol=RUNTIME_ATOL)
    np.testing.assert_allclose(ts.state.q.numpy(), np.asarray(js.state.q), rtol=0,
                               atol=RUNTIME_ATOL)
