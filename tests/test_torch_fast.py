"""The port's plain K1 and K2 (the twin of the CUDA kernels) against the JAX
package's Pallas kernels in interpret mode on two free boxes in the air, the
top one (under gravity) pressed 5 mm onto the other (gravity off) and
sliding across it, with a point robot (collision off) giving the rollout its
controls (chip_smoke.BOX_PAIR, the scene of its phase 17, with its cost:
TASK_MOBILE_PUSH with the point robot's link as the EE and the top box as
the block); each box also has its box–plane block against the ground:

* K1 at fast fidelity with the reduced manifold (`rollout_fidelity: fast`,
  `rollout_manifold: reduced`): no λ rows, every substep's impulse sweeps
  start from zero, no stiction snap, and the rollout's own contact tables
  with 8 corner samples per box–box direction (the world's have 14);
* the full 26-sample box–box manifold (bbA: the first box's samples against
  the second, bbB: the second's against the first, its normal turned to
  a − b). No shipped table builder emits it, so both packages get the same
  hand-built tables: the scene's box pair moved from its two bbc
  directions into bb_a / bb_b (physics/contact.full_box_manifold, applied
  to each package's tables). K2 over several world steps, λ rows
  included, and K1 at world fidelity from the sliding state.

Tolerances as in tests/test_torch_mobile.py: world states atol 1e-4 (root
angular velocities and net contact forces 1e-3), costs rtol 1e-4 / atol
1e-4, vis 4e-3 (bf16).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import BOX_PAIR, BoxPairObjective
from test_torch_mobile import assert_states, jax_cost, scenes, world_steps

from mppiisaac_tpu.ops.pallas.fused_rollout import FusedRollout as JRollout
from mppiisaac_tpu.runtime.sim import broadcast_state as j_broadcast
from mppiisaac_tpu.runtime.sim import sample_model_params as j_params

from mppiisaac_tpu_torch.convert import model_params_from_jax, sim_state_from_jax
from mppiisaac_tpu_torch.ops import fused_physics as tfp
from mppiisaac_tpu_torch.ops.fused_contacts import KIND_BBA, KIND_BBB, KIND_BBC, KIND_BP
from mppiisaac_tpu_torch.ops.fused_rollout import FusedRollout
from mppiisaac_tpu_torch.physics.contact import N_BOX_SAMPLES, full_box_manifold

torch.set_num_threads(1)
K, H = 4, 3
COST_RTOL, COST_ATOL = 1e-4, 1e-4
def _scenes():
    return scenes(specs=BOX_PAIR)


def _sliding(jb, je):
    """The boxes' initial state with the top box moving across at 0.4 m/s."""
    js = jb.initial_state(je)
    t = jb.scene.actor_index("top_box")
    return je.refresh(js._replace(root_linvel=js.root_linvel.at[t].set(jnp.array([0.0, 0.4, 0.0]))))


def _cost(tb):
    return BoxPairObjective().kernel_cost(tb)


def _rollouts(jb, je, tb, te, js, world_fidelity, manifold, seed):
    """K1 of both packages from the JAX world state js; asserts costs and vis
    agree. → the port's FusedRollout and the costs."""
    s = tb.scene
    cost = _cost(tb)
    V = np.random.RandomState(seed).uniform(-1, 1, (K, H, tb.cmd_map.nu)).astype(np.float32)
    sK, pK = j_broadcast(js, K), j_params(jb, je, K, seed=3)
    vis = s.body_offset[s.actor_index("top_box")]
    jf = JRollout(jb, je, cost_fn=jax_cost(cost), H=H, K=K, vis_body=vis, interpret=True,
                  impulse_sweeps=2, world_fidelity=world_fidelity, manifold=manifold)
    cj, vj = jf.rollout(sK, pK, jnp.asarray(V))
    fr = FusedRollout(tb, te, cost, H=H, K=K, vis_body=vis, impulse_sweeps=2,
                      world_fidelity=world_fidelity, manifold=manifold)
    ct, vt = fr.rollout(sim_state_from_jax(sK), model_params_from_jax(pK), torch.as_tensor(V))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=COST_RTOL, atol=COST_ATOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=4e-3)
    return fr, np.asarray(cj)


def test_reduced_manifold_tables():
    """Fast fidelity with the reduced manifold packs its own tables: the two
    bbc directions at 8 corner samples (the world's 14), no λ rows; at world
    fidelity `manifold` changes nothing (the world's λ rows index the
    world's tables). Each box's bp block adds 8 candidates."""
    _, _, tb, te = _scenes()
    assert te.tables.bbc_samples == 14
    fast = FusedRollout(tb, te, _cost(tb), H=H, K=K, world_fidelity=False, manifold="reduced")
    kinds = fast.ks.blk_kind.tolist()
    assert kinds.count(KIND_BBC) == 2 and fast.ks.blk_S[kinds.index(KIND_BBC)] == 8
    assert fast.ks.n_fc == 16 + 16 and fast.n_rows == fast.ks.n_state_rows
    world = FusedRollout(tb, te, _cost(tb), H=H, K=K, manifold="reduced")
    assert world.ks.n_fc == 16 + 28 and world.n_rows == world.ks.n_state_rows + 4 * 44
    with pytest.raises(ValueError, match="manifold"):
        FusedRollout(tb, te, _cost(tb), H=H, K=K, manifold="coarse")


def test_fast_reduced_rollout_matches_pallas():
    """K1 at fast fidelity with the reduced manifold from the sliding boxes:
    the impulse sweeps start from zero in every substep."""
    jb, je, tb, te = _scenes()
    fr, costs = _rollouts(jb, je, tb, te, _sliding(jb, je), False, "reduced", seed=2)
    assert not fr.world_fidelity and fr.tables.bbc_samples == 8
    assert np.ptp(costs[:, -1]) > 1e-4, "every sample rolled out the same"


def _bb_scenes():
    jb, je, tb, te = _scenes()
    je.tables = full_box_manifold(je.tables)
    te.tables = full_box_manifold(te.tables)
    return jb, je, tb, te


def test_full_box_manifold_tables():
    """bbA and bbB blocks of 26 samples each after the two bp blocks, all
    swept (free bodies); the bbB block's box-sample constants are the second
    box's."""
    _, _, tb, te = _bb_scenes()
    ks = tfp.KernelScene.build(tb, te)
    assert ks.blk_kind.tolist() == [KIND_BP, KIND_BP, KIND_BBA, KIND_BBB]
    assert ks.blk_S.tolist()[2:] == [N_BOX_SAMPLES] * 2 and ks.n_fc == 16 + 2 * N_BOX_SAMPLES
    half = [np.asarray(tb.scene.geom_size[g], np.float32) for g in (ks.blk_ga[2], ks.blk_gb[2])]
    for bi, h in zip((2, 3), half):
        o = int(ks.blk_sc[bi])
        xs = ks.sconst[o: o + N_BOX_SAMPLES]
        assert np.isclose(np.abs(xs).max(), h[0])


def test_full_box_manifold_world_step_matches_pallas():
    """4 world steps of the sliding boxes on the bbA/bbB blocks: the top box
    presses the base box down and drags it along; the contact's λ rows
    carry impulses."""
    jb, je, tb, te = _bb_scenes()
    steps = list(world_steps(jb, je, tb, te, _sliding(jb, je), 4, lambda i: np.zeros(3, np.float32)))
    for i, (js, ts) in enumerate(steps):
        assert_states(js, ts, f"step {i}")
    js = steps[0][0]
    b = jb.scene.actor_index("base_box")
    assert float(js.root_linvel[b, 2]) < -1e-3, "no normal force at the box–box contact"
    assert float(js.root_linvel[b, 1]) > 1e-3, "no friction impulse at the box–box contact"
    assert np.abs(np.asarray(js.contact_lam)).max() > 1e-4


def test_full_box_manifold_rollout_matches_pallas():
    """K1 at world fidelity on the bbA/bbB blocks from the sliding boxes,
    the λ rows of all 52 candidates carried across the trajectory."""
    jb, je, tb, te = _bb_scenes()
    js = _sliding(jb, je)
    for js, _ in world_steps(jb, je, tb, te, js, 1, lambda i: np.zeros(3, np.float32)):
        pass
    fr, costs = _rollouts(jb, je, tb, te, js, True, "full", seed=5)
    assert fr.ks.n_fc == 16 + 2 * N_BOX_SAMPLES
    assert np.ptp(costs[:, -1]) > 1e-4, "every sample rolled out the same"
