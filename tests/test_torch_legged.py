"""The port's plain K1 and K2 against the JAX package's Pallas kernels in
interpret mode on the scenes of the shipped mesh-robot loops that no other
test holds there, each built from its task conf by both packages:

* two jackals (multi_jackal) pressed together, the second 0.455 m ahead of
  the first so that their front and rear wheels overlap by 3 mm, driven into
  each other: the penalty blocks between two floating articulated bases
  live, TASK_MULTI_ROBOT's cost;
* anymal after landing: the drop start (1.2 m) stepped by the port's plain
  K2 until the feet rest on the ground with the stiction blocks live, at the
  conf's dt 0.1 and 8 substeps, TASK_ANYMAL's cost;
* albert resting on its wheels under a drive command, TASK_ALBERT's cost.

K2 over 2 world steps (the jackals 1: their contact is chaotic in float32
after that) with 16 sweeps, contact_lam included, and K1 at K=4, H=1 (world
fidelity, 2 sweeps, the λ rows live) from the state after them. Tolerances
are those of tests/test_torch_mobile.py, or 3× the plain version's own
float32-vs-float64 drift where that is larger (see `check`); the costs of the
JAX objectives take orientation from a polynomial atan (error below 2e-6
rad, tests/test_torch_slice.py), far inside them.

The JAX kernels are jitted without XLA's fusion pass (INTERPRET_OPTIONS),
which halves their compile in interpret mode and changes no result. Even so
each of anymal's and albert's two kernels takes about four minutes to trace
and compile on one CPU core without the persistent cache (nv 18 and 15, 13
Ψ slots, all unrolled): their K2 holds run in tier-1, one file each
(tests/test_torch_legged_anymal.py, tests/test_torch_legged_albert.py),
and K2 with K1 here, marked slow as the full pick scene is (`-m slow`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_mobile import (ANGVEL_ATOL, COST_ATOL, COST_RTOL, FORCE_ATOL, STATE_ATOL,
                               assert_states, world_steps)

from mppiisaac_tpu.ops.pallas.fused_rollout import FusedRollout as JRollout
from mppiisaac_tpu.ops.pallas.fused_rollout import FusedWorldStep as JWorld
from mppiisaac_tpu.runtime.sim import Simulation as JSim
from mppiisaac_tpu.runtime.sim import broadcast_state as j_broadcast
from mppiisaac_tpu.runtime.sim import sample_model_params as j_params
from mppiisaac_tpu.utils.config_store import load_config as j_load

from mppiisaac_tpu_torch.convert import model_params_from_jax, sim_state_from_jax
from mppiisaac_tpu_torch.ops import fused_physics as tfp
from mppiisaac_tpu_torch.ops.fused_contacts import block_geometry
from mppiisaac_tpu_torch.ops.fused_rollout import FusedRollout, FusedWorldStep, world_step_plain
from mppiisaac_tpu_torch.physics.types import ModelParams
from mppiisaac_tpu_torch.runtime.sim import Simulation as TSim
from mppiisaac_tpu_torch.utils.config_store import load_config as t_load

torch.set_num_threads(1)
K, H = 4, 1
JACKAL_GAP = 0.455
LANDING_STEPS = 8
# XLA:CPU compile options of the JAX kernels in interpret mode
INTERPRET_OPTIONS = {"xla_disable_hlo_passes": "fusion"}


def interpreted(kernel):
    """A JAX package kernel object built with interpret=True, its call
    re-jitted with INTERPRET_OPTIONS."""
    kernel._run = jax.jit(kernel._build_call(), compiler_options=INTERPRET_OPTIONS)
    return kernel


def worlds(task, positions=None):
    """(JAX conf, port conf, JAX built, JAX engine, port Simulation) of a
    task conf's scene, its actors at `positions` (default: the conf's)."""
    jc, tc = j_load(f"tasks/{task}"), t_load(f"tasks/{task}")
    pos = positions or jc.initial_actor_positions
    jw = JSim(cfg=jc.isaacgym, actors=jc.actors, init_positions=pos)
    tw = TSim(tc.isaacgym, tc.actors, pos, device="cpu")
    return jc, tc, jw.built, jw.engine, tw


def to_jax(jb, je, ts):
    """The port's SimState of one env as the JAX package's."""
    js = jb.initial_state(je)
    return js._replace(**{f: None if getattr(ts, f) is None else jnp.asarray(getattr(ts, f).numpy())
                          for f in js._fields})


def rollouts(jb, je, tb, te, js, jcost, tcost, V, vis_body):
    """K1 of both packages from the JAX world state js (broadcast K-wide,
    randomized params); asserts costs and vis agree, returns the costs."""
    sK, pK = j_broadcast(js, K), j_params(jb, je, K, seed=3)
    jf = interpreted(JRollout(jb, je, cost_fn=jcost, H=H, K=K, vis_body=vis_body, interpret=True,
                              impulse_sweeps=2, world_fidelity=True))
    cj, vj = jf.rollout(sK, pK, jnp.asarray(V))
    fr = FusedRollout(tb, te, tcost, H=H, K=K, vis_body=vis_body, impulse_sweeps=2)
    ct, vt = fr.rollout(sim_state_from_jax(sK), model_params_from_jax(pK), torch.as_tensor(V))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=COST_RTOL, atol=COST_ATOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=4e-3)
    return np.asarray(cj)


FIELDS = ("root_pos", "root_quat", "root_linvel", "root_angvel", "q", "qd", "net_contact_force",
          "contact_lam")


def drift(ks, fw, ts, tgt, n):
    """Per SimState field, how far the port's plain K2 in float32 drifts from
    the same in float64 over n world steps from ts (the float32 rounding
    sensitivity of the state)."""
    A, D, B, NS = ks.nactor, ks.ndof, ks.nbody, ks.n_state_rows
    r = {dt: fw.pack(ts).to(dt) for dt in (torch.float32, torch.float64)}
    out = dict.fromkeys(FIELDS, 0.0)
    for _ in range(n):
        for dt in r:
            r[dt] = world_step_plain(ks, r[dt], tgt.to(dt), torch.ones(B, dtype=dt),
                                     torch.ones(ks.ngeom, dtype=dt), fw.substeps, fw.dt_sub,
                                     fw.impulse_sweeps)
        d = (r[torch.float32].double() - r[torch.float64]).abs()
        root = d[: 13 * A].reshape(A, 13)
        step = (root[:, 0:3], root[:, 3:7], root[:, 7:10], root[:, 10:13], d[13 * A:13 * A + D],
                d[13 * A + D:13 * A + 2 * D], d[13 * A + 2 * D:NS], d[NS:])
        for f, x in zip(FIELDS, step):
            out[f] = max(out[f], float(x.max()) if x.numel() else 0.0)
    return out


def check_world(jb, je, tb, te, js, drive, n=2):
    """n world steps of K2 under `drive` → the JAX state after them. Each
    field is held to the tolerance of tests/test_torch_mobile.py, or to 3×
    the plain version's own float32-vs-float64 drift (its largest over the
    same steps) where that is larger (stiff contacts: a rounding of the sum order moves
    the state by that much)."""
    fw = FusedWorldStep(tb, te)
    tgt = torch.as_tensor(np.array(jb.cmd_map.apply(jnp.asarray(drive), js.q)))
    dr = drift(fw.ks, fw, sim_state_from_jax(js).replace(dof_target=tgt), tgt, n)
    base = {"root_angvel": ANGVEL_ATOL, "net_contact_force": FORCE_ATOL}
    tols = {f: max(base.get(f, STATE_ATOL), 3.0 * dr[f]) for f in FIELDS}
    jw = interpreted(JWorld(jb, je, interpret=True))
    for i, (js, ts) in enumerate(world_steps(jb, je, tb, te, js, n, lambda i: drive, jw)):
        assert_states(js, ts, f"step {i}", tols)
    assert np.abs(np.asarray(js.contact_lam)).max() > 1e-6, "no impulse carried"
    return js


def check(jb, je, tb, te, js, drive, jcost, tcost, seed, vis_body, n=2):
    """check_world, then K1 from the state after the world steps."""
    js = check_world(jb, je, tb, te, js, drive, n)
    V = np.random.RandomState(seed).uniform(-1, 1, (K, H, tb.cmd_map.nu)).astype(np.float32)
    costs = rollouts(jb, je, tb, te, js, jcost, tcost, V, vis_body)
    assert np.ptp(costs[:, -1]) > 1e-5, "every sample rolled out the same"
    return js


def test_two_jackals_pressed_together_match_pallas():
    """The jackal↔jackal blocks (cc between the wheels, cb and bbc with the
    chassis) are penalty blocks that emit on both sides, not swept, with no
    damper cap (m_oth 0): two articulated floating bases meet through the
    penalty law alone. The front and rear wheels start 3 mm deep."""
    from mppiisaac_tpu.tasks.multi_robot import MultiJackalObjective as JObj
    from mppiisaac_tpu_torch.tasks.multi_robot import MultiJackalObjective as TObj

    jc, tc, jb, je, tw = worlds("multi_jackal", [[0.0, 0.0, 0.0], [JACKAL_GAP, 0.0, 0.0]])
    tb, te = tw.built, tw.engine
    ks = tfp.KernelScene.build(tb, te)
    a0 = tb.scene.actor_index("jackal")
    pair = [bi for bi in range(ks.nblk) if int(ks.blk_bb[bi]) >= 0
            and {int(ks.body_actor[ks.blk_ba[bi]]), int(ks.body_actor[ks.blk_bb[bi]])} == {a0, a0 + 1}]
    both = tfp.F_EMIT_A | tfp.F_EMIT_B
    assert pair and all(int(ks.blk_flags[bi]) & both == both for bi in pair)
    assert not any(int(ks.blk_flags[bi]) & tfp.F_SWEPT for bi in pair)
    assert all(float(ks.blk_m_oth[bi]) == 0.0 for bi in pair)
    st = tfp.rows_to_state(ks, tfp.state_to_rows(ks, tw.state.root_state, tw.state.q, tw.state.qd))
    pos, quat, _, _, _ = tfp.fk(ks, st)
    depth = max(float(block_geometry(ks, bi, pos, quat)[2].max()) for bi in pair)
    assert 1e-3 < depth < 5e-3, f"the jackals overlap by {depth} m"
    drive = np.array([0.5, 0.0, -0.5, 0.0], np.float32)
    check(jb, je, tb, te, jb.initial_state(je), drive, JObj(jc).kernel_cost(jb.scene),
          TObj(tc).kernel_cost(tb), seed=8, vis_body=int(tb.scene.body_offset[a0]), n=1)


def _landed_anymal(tw):
    """The port's anymal after LANDING_STEPS plain world steps from the drop
    start, its joints held at their start pose."""
    tb = tw.built
    fw = FusedWorldStep(tb, tw.engine)
    params = ModelParams(torch.ones(tb.scene.nbody), torch.ones(tb.scene.ngeom))
    ts = tw.state.map(lambda x: x[0])
    for _ in range(LANDING_STEPS):
        ts = fw.step(ts.replace(dof_target=ts.q.clone()), params)
    return ts


def landed_anymal():
    """(JAX conf, port conf, JAX built, JAX engine, port Simulation, the
    landed state as the JAX package's, the drive: joints held)."""
    jc, tc, jb, je, tw = worlds("anymal")
    tb, te = tw.built, tw.engine
    assert te.substeps == 8 and abs(tb.scene.dt - 0.1) < 1e-9
    ts = _landed_anymal(tw)
    assert float(ts.root_pos[0, 2]) < 0.8, "anymal did not land"
    return jc, tc, jb, je, tw, to_jax(jb, je, ts), np.zeros(tb.cmd_map.nu, np.float32)


def resting_albert():
    """As landed_anymal for albert at its start, its base driven at (0.3, 0.2)."""
    jc, tc, jb, je, tw = worlds("albert")
    drive = np.zeros(tw.built.cmd_map.nu, np.float32)
    drive[:2] = (0.3, 0.2)
    return jc, tc, jb, je, tw, jb.initial_state(je), drive


@pytest.mark.slow
def test_anymal_landed_matches_pallas():
    from mppiisaac_tpu.tasks.anymal import AnymalObjective as JObj
    from mppiisaac_tpu_torch.tasks.anymal import AnymalObjective as TObj

    jc, tc, jb, je, tw, js, drive = landed_anymal()
    tb = tw.built
    check(jb, je, tb, tw.engine, js, drive, JObj(jc).kernel_cost(jb.scene),
          TObj(tc).kernel_cost(tb), seed=9, vis_body=tb.scene.body_index("base", "anymal"))


@pytest.mark.slow
def test_albert_resting_matches_pallas():
    from mppiisaac_tpu.tasks.albert import AlbertObjective as JObj
    from mppiisaac_tpu_torch.tasks.albert import AlbertObjective as TObj

    jc, tc, jb, je, tw, js, drive = resting_albert()
    tb = tw.built
    tcost = TObj(tc).kernel_cost(tb)
    check(jb, je, tb, tw.engine, js, drive, JObj(jc).kernel_cost(jb.scene), tcost, seed=10,
          vis_body=tcost.ee_body)
