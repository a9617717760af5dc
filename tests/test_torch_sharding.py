"""K-sharding (`parallel/sharding.py`) on the CPU.

* `prng.fold_in` bit for bit against `jax.random.fold_in`;
* the sharded command over 2 and 4 gloo ranks, each a process of its own
  (`python -m mppiisaac_tpu_torch.parallel.sharding`, 120 s at most), on
  point_robot at K=16, H=2: against the one-device command of the same
  carry and state in the same run (the per-sample costs bit for bit: each
  sample's rollout is the same arithmetic on either layout; the action to
  1e-6, the softmax sums run in another order; Halton only: the random
  draws differ by rank, as in the JAX package), and against the JAX
  package's `sharded_command` on the conftest's virtual CPU devices with
  the same number of shards (the XLA rollout against the port's unfused
  one: costs and action to 1e-4), with Halton noise (one global table,
  sliced per rank) and with random noise (`fold_in(key, rank)` per rank);
  the fused rollout (`fused_factory`, its plain version on the CPU) over 4
  ranks against the one-device command.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mppiisaac_tpu.parallel.sharding import make_mesh, shard_batched_state, sharded_command
from mppiisaac_tpu.planner.mppi_isaac import MPPIisaacPlanner as JPlanner
from mppiisaac_tpu.runtime.sim import Simulation as JSim
from mppiisaac_tpu.tasks.point_robot import PointRobotObjective as JObj
from mppiisaac_tpu.utils.config_store import load_config as j_load

from mppiisaac_tpu_torch.mppi import prng
from mppiisaac_tpu_torch.parallel import sharding

K, H = 16, 2


def test_fold_in_matches_jax():
    for seed, data in [(0, 0), (0, 1), (7, 3), (123456, 2**31 - 1), (2**32 - 1, 2**32 - 1)]:
        ref = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), data), np.uint32)
        np.testing.assert_array_equal(prng.fold_in(prng.prng_key(seed), data), ref)
    # folded keys then split and draw as the JAX shards do
    k = prng.fold_in(prng.prng_key(5), 1)
    jk = jax.random.fold_in(jax.random.PRNGKey(5), 1)
    np.testing.assert_array_equal(prng.split(k), np.asarray(jax.random.split(jk), np.uint32))


def _overrides(sampling):
    return [f"mppi.num_samples={K}", f"mppi.horizon={H}", f"mppi.sampling_method={sampling}"]


def _port_sharded(tmp_path, ranks, sampling, use_fused):
    out = tmp_path / f"sharded_{ranks}_{sampling}_{use_fused}.json"
    rc = sharding.launch(ranks, ["task=point_robot", "device=cpu", "reps=1", f"out={out}",
                                 f"use_fused={str(use_fused).lower()}"] + _overrides(sampling),
                         timeout=120)
    assert rc == 0, f"the ranks failed (rc {rc})"
    return json.loads(out.read_text())


def _jax_sharded(ranks, sampling):
    """The JAX package's sharded command of the point_robot planner (XLA
    rollout) from its run_task world state, on `ranks` virtual devices."""
    jc = j_load("tasks/point_robot", _overrides(sampling))
    jp = JPlanner(jc, JObj(jc), use_fused=False)
    world = JSim(cfg=jc.isaacgym, actors=jc.actors, init_positions=jc.initial_actor_positions)
    state_K = jax.tree.map(lambda x: jnp.broadcast_to(x[0], (K,) + x.shape[1:]), world.state)
    mesh = make_mesh(ranks)
    run = sharded_command(jp.mppi, mesh)
    action, carry, info = run(jp.mppi.carry, shard_batched_state((state_K, jp._params_K), mesh))
    return np.asarray(action), np.asarray(info["costs"]), np.asarray(carry.key, np.uint32)


@pytest.mark.parametrize("ranks,sampling", [(2, "halton"), (4, "halton"), (2, "random")])
def test_sharded_unfused_command_matches_one_device_and_jax(tmp_path, ranks, sampling):
    if len(jax.devices()) < ranks:
        pytest.skip(f"needs {ranks} JAX devices")
    r = _port_sharded(tmp_path, ranks, sampling, use_fused=False)
    assert r["ranks"] == ranks and r["K_rank"] == K // ranks and not r["use_fused"]
    assert r["same_action_on_every_rank"]
    if sampling == "halton":
        # one global table: the sharded sample set is the one-device one (the
        # random draws differ by rank, as the JAX shards' do)
        np.testing.assert_array_equal(np.asarray(r["costs"]), np.asarray(r["costs_one"]))
        np.testing.assert_allclose(r["action"], r["action_one"], atol=1e-6)
    a_j, c_j, key_j = _jax_sharded(ranks, sampling)
    np.testing.assert_allclose(np.asarray(r["costs"]), c_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(r["action"]).reshape(a_j.shape), a_j, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(r["key_after"], np.uint32), key_j)
    assert np.abs(a_j).max() > 1e-3


def test_sharded_fused_command_matches_one_device(tmp_path):
    """fused_factory: every rank's FusedRollout over K/4 samples."""
    r = _port_sharded(tmp_path, 4, "halton", use_fused=True)
    assert r["use_fused"] and r["K_rank"] == K // 4 and r["same_action_on_every_rank"]
    np.testing.assert_array_equal(np.asarray(r["costs"]), np.asarray(r["costs_one"]))
    np.testing.assert_allclose(r["action"], r["action_one"], atol=1e-6)
