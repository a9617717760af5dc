"""The profiling ablations of the plain twin (ops/fused_physics.substep,
ops/fused_rollout.rollout_plain and world_step_plain) against the JAX
package's, on the same inputs:

* `skip_contacts` and `skip_dynamics` on panda reach (no swept block), one
  substep of the JAX device code (`fused_physics.substep_lanes`, called on
  plain arrays of K samples as tests/test_torch_contacts.py calls the lanes
  functions) against the port's `substep`, from states that put some links
  into the ground so that the contacts carry force;
* `zero_cost` with both skips (the profiler's fkonly) on panda reach, the
  JAX `FusedRollout(profile=...)` in Pallas interpret mode against the
  port's `FusedRollout(profile=...).plain`;
* `two_way_sweeps=False` on boxer_reach, the smallest shipped scene with a
  swept block that has an articulated side (the boxer's floating base
  against the ground: stiction blocks), one world-fidelity substep with the
  JAX module's TWO_WAY_SWEEPS set off and restored, as
  tests/test_broadphase_gate.py sets BROADPHASE_GATE;
* `broadphase_gate=False` bit for bit equal to the gated twin (K1 and K2)
  on the mini-gripper holding a ball beside a far ball whose blocks the
  gate turns off, and the switches' validation.

The JAX functions are jitted without XLA's fusion pass (as
tests/test_torch_legged.py does), which changes no result and shortens the
compile. Tolerances are those of tests/test_torch_substep.py (2e-3: float32
sums in another order over a substep with penalty forces of ~1e3 N).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppiisaac_tpu.ops.pallas import fused_physics as jfp
from mppiisaac_tpu.ops.pallas.fused_rollout import FusedRollout as JRollout
from mppiisaac_tpu.physics.dynamics import build_actor_masks as j_masks
from mppiisaac_tpu.physics.step import Engine as JEngine
from mppiisaac_tpu.runtime.sim import broadcast_state as j_broadcast
from mppiisaac_tpu.runtime.sim import sample_model_params as j_params
from mppiisaac_tpu.scene.actor import load_actor_cfgs as j_actors
from mppiisaac_tpu.scene.builder import build_scene as j_build
from mppiisaac_tpu.tasks.panda_reach import PandaReachObjective as JObjective
from mppiisaac_tpu.utils.config_store import actors_conf_dir as j_actor_dir
from mppiisaac_tpu.utils.config_store import load_config as j_load

from mppiisaac_tpu_torch.convert import model_params_from_jax, sim_state_from_jax
from mppiisaac_tpu_torch.ops import fused_physics as tfp
from mppiisaac_tpu_torch.ops import fused_rollout as fro
from mppiisaac_tpu_torch.ops.fused_rollout import FusedRollout, FusedWorldStep
from mppiisaac_tpu_torch.physics.step import Engine as TEngine
from mppiisaac_tpu_torch.physics.types import ModelParams
from mppiisaac_tpu_torch.runtime.sim import broadcast_state
from mppiisaac_tpu_torch.scene.actor import ActorSpec
from mppiisaac_tpu_torch.scene.actor import load_actor_cfgs as t_actors
from mppiisaac_tpu_torch.scene.builder import SimConfig, build_scene
from mppiisaac_tpu_torch.scene.builder import build_scene as t_build
from mppiisaac_tpu_torch.tasks.panda_reach import PandaReachObjective
from mppiisaac_tpu_torch.utils.config_store import actors_conf_dir, load_config

torch.set_num_threads(1)
NO_FUSION = {"xla_disable_hlo_passes": "fusion"}
RTOL = ATOL = 2e-3
K = 8


def _scenes(task, use_impulse):
    jc = j_load(f"tasks/{task}")
    jb = j_build(j_actors(jc.actors, j_actor_dir()), jc.isaacgym, jc.initial_actor_positions)
    je = JEngine(jb.scene, use_impulse=use_impulse)
    tc = load_config(f"tasks/{task}")
    tb = t_build(t_actors(tc.actors, actors_conf_dir()), tc.isaacgym, tc.initial_actor_positions)
    return jc, jb, je, tc, tb, TEngine(tb.scene)


def _panda_states(jb, je, seed):
    """K panda states bending the arm from clear of the ground into it
    (tests/test_torch_substep.py), targets, and K sampled model params."""
    rng = np.random.RandomState(seed)
    s0 = jb.initial_state(je)
    q = np.tile(np.asarray(s0.q), (K, 1)).astype(np.float32)
    q[:, 0] = rng.uniform(-1, 1, K)
    q[:, 1] = np.linspace(0.6, 1.7, K)
    q[:, 3] = -0.3
    qd = rng.uniform(-1, 1, (K, q.shape[1])).astype(np.float32)
    sK = jax.vmap(je.refresh)(j_broadcast(s0, K)._replace(q=jnp.asarray(q), qd=jnp.asarray(qd)))
    tgt = rng.uniform(-2, 2, q.shape).astype(np.float32)
    return sK, j_params(jb, je, K, seed=seed + 100), tgt


def _to_lanes(st, ks, tgt):
    """The port's state dict (K leading) → the JAX lanes state: per-component
    (1,K) tiles (the kernel's (8,128) tiles with one row), and per swept block
    (λ_n (S,1,K), λ_t 3 × (S,1,K))."""
    A = st["root_pos"].shape[1]

    def t3(x, a):
        return tuple(_tile(x[:, a, i]) for i in range(x.shape[-1]))

    out = {k: [t3(st[k], a) for a in range(A)]
           for k in ("root_pos", "root_quat", "root_linvel", "root_angvel")}
    out["q"] = [_tile(st["q"][:, d]) for d in range(st["q"].shape[1])]
    out["qd"] = [_tile(st["qd"][:, d]) for d in range(st["qd"].shape[1])]
    out["net_cf"] = [t3(st["net_cf"], b) for b in range(st["net_cf"].shape[1])]
    out["dof_target"] = [_tile(tgt[:, d]) for d in range(tgt.shape[1])]
    if "lam" in st:
        lam, lanes, c0 = st["lam"].numpy(), [], 0
        for S in ks_swept_S(ks):
            blk = lam[:, c0:c0 + S].transpose(1, 0, 2)[:, None]     # (S,1,K,4)
            lanes.append((jnp.asarray(blk[..., 0]), tuple(jnp.asarray(blk[..., 1 + i])
                                                          for i in range(3))))
            c0 += S
        out["lam"] = lanes
    return out


def _tile(x):
    return jnp.asarray(np.asarray(x, np.float32).reshape(1, -1))


def ks_swept_S(ks):
    return [int(ks.blk_S[bi]) for bi in range(ks.nblk) if int(ks.blk_flags[bi]) & tfp.F_SWEPT]


def _from_lanes(new, swept_S):
    """The JAX substep's state dict → numpy arrays in the port's layout."""
    def col(c):
        return np.broadcast_to(np.asarray(c, np.float32).reshape(-1), (K,))

    def st3(rows):
        return np.stack([np.stack([col(c) for c in r], -1) for r in rows], 1)

    out = {k: st3(new[k]) for k in ("root_pos", "root_quat", "root_linvel", "root_angvel",
                                     "net_cf")}
    out["q"] = np.stack([col(x) for x in new["q"]], -1)
    out["qd"] = np.stack([col(x) for x in new["qd"]], -1)
    if "lam" in new:
        blocks = []
        for S, (ln, lt) in zip(swept_S, new["lam"]):
            rows = [np.broadcast_to(np.asarray(x, np.float32).reshape(S, -1), (S, K))
                    for x in (ln,) + tuple(lt)]
            blocks.append(np.stack(rows, -1).transpose(1, 0, 2))        # (K,S,4)
        out["lam"] = np.concatenate(blocks, 1)
    return out


def _jax_substep(jb, je, ks, lanes_state, mass, fric, dt, sweeps, world, **kw):
    scene = jb.scene
    masks = [j_masks(a) for a in scene.actors]

    def f(state, mass, fric):
        return jfp.substep_lanes(scene, je.tables, masks, state, fric, mass, dt,
                                 impulse_sweeps=sweeps, world_fidelity=world, **kw)

    new = jax.jit(f, compiler_options=NO_FUSION)(
        lanes_state, [_tile(mass[:, b]) for b in range(mass.shape[1])],
        [_tile(fric[:, g]) for g in range(fric.shape[1])])
    return _from_lanes(new, ks_swept_S(ks))


def _port_state(ks, sK):
    ts = sim_state_from_jax(sK)
    st = tfp.rows_to_state(ks, tfp.state_to_rows(ks, ts.root_state, ts.q, ts.qd))
    st["net_cf"] = torch.zeros_like(st["net_cf"])
    return st


def _compare(got, ref, keys):
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("switch", ["skip_contacts", "skip_dynamics"])
def test_substep_skips_match_jax_on_panda_reach(switch):
    jc, jb, je, tc, tb, te = _scenes("panda", use_impulse=False)
    sK, pK, tgt = _panda_states(jb, je, seed=3)
    tp = model_params_from_jax(pK)
    ks = tfp.KernelScene.build(tb, te)
    st = _port_state(ks, sK)
    mass, fric = tp.body_mass_scale, tp.geom_friction
    ref = _jax_substep(jb, je, ks, _to_lanes(st, ks, tgt), mass.numpy(), fric.numpy(), te.dt_sub, 0,
                       False, **{switch: True})
    got = tfp.substep(ks, st, torch.as_tensor(tgt), mass, fric, te.dt_sub, 0, False,
                      **{switch: True})
    _compare(got, ref, ("root_pos", "root_quat", "q", "qd", "net_cf"))
    full = tfp.substep(ks, st, torch.as_tensor(tgt), mass, fric, te.dt_sub, 0, False)
    if switch == "skip_contacts":
        assert float(full["net_cf"].abs().sum()) > 10.0, "no contact force to skip"
        assert float(got["net_cf"].abs().sum()) == 0.0
        assert float((got["qd"] - full["qd"]).abs().max()) > 10 * ATOL
    else:
        torch.testing.assert_close(got["net_cf"], full["net_cf"], rtol=0.0, atol=0.0)
        assert torch.equal(got["q"], st["q"]) and torch.equal(got["qd"], st["qd"])


def test_fkonly_rollout_matches_pallas_interpret():
    """K1 with zero_cost, skip_contacts and skip_dynamics (the profiler's
    fkonly): the cost of every step is q[0] after its substeps, the JAX
    kernel in interpret mode against the port's plain K1; vis (zero in the
    JAX kernel) is the sum of the actors' root positions, each root drifting
    by its own seeded velocity."""
    jc, jb, je, tc, tb, te = _scenes("panda", use_impulse=False)
    sK, pK, _ = _panda_states(jb, je, seed=5)
    linvel = np.random.RandomState(7).uniform(-0.5, 0.5, sK.root_linvel.shape).astype(np.float32)
    sK = sK._replace(root_linvel=jnp.asarray(linvel))
    H = 2
    prof = {"skip_contacts": True, "skip_dynamics": True, "zero_cost": True}
    V = np.random.RandomState(6).uniform(-1, 1, (K, H, jb.cmd_map.nu)).astype(np.float32)
    jr = JRollout(jb, je, cost_fn=JObjective(jc).kernel_cost(jb.scene), H=H, K=K, vis_body=None,
                  interpret=True, impulse_sweeps=0, profile=prof)
    jr._run = jax.jit(jr._build_call(), compiler_options=NO_FUSION)
    c_j, _ = jr.rollout(sK, pK, jnp.asarray(V))
    fr = FusedRollout(tb, te, PandaReachObjective(tc).kernel_cost(tb), H, K, impulse_sweeps=0,
                      profile=prof)
    st = sim_state_from_jax(sK)
    costs, vis = fr.plain(*fr.pack(st, model_params_from_jax(pK), torch.as_tensor(V)))
    np.testing.assert_allclose(costs.numpy(), np.asarray(c_j), rtol=1e-6, atol=1e-6)
    assert float(costs.abs().max()) > 0.1
    # skip_dynamics keeps q: the cost is the sample's own q[0] at every step
    torch.testing.assert_close(costs, st.q[:, :1].expand(K, H))
    # ... and moves every root by its velocity
    t = torch.arange(1, H + 1, dtype=torch.float64)[:, None, None] * fr.substeps * fr.dt_sub
    want = (st.root_pos.double() + t[..., None] * st.root_linvel.double()).sum(2)
    torch.testing.assert_close(vis.double(), want, rtol=0.0, atol=1e-5)
    assert float((vis[-1] - st.root_pos.sum(1)).abs().max()) > 1e-2, "the roots did not drift"


def test_one_way_sweeps_match_jax_on_boxer_reach():
    """One world-fidelity substep (2 sweeps, λ warm start) of the boxer on
    its wheels, the stiction blocks live: TWO_WAY_SWEEPS off in the JAX
    module (set, then restored) against `two_way_sweeps=False`."""
    jc, jb, je, tc, tb, te = _scenes("boxer_reach", use_impulse=True)
    ks = tfp.KernelScene.build(tb, te)
    w = FusedWorldStep(tb, te)
    s0 = tb.initial_state(te, "cpu")
    params = ModelParams(torch.ones(tb.scene.nbody), torch.ones(tb.scene.ngeom))
    g = torch.Generator().manual_seed(4)
    st = s0
    for _ in range(6):                           # settle onto the wheels, turning
        u = torch.rand(ks.nu, generator=g) * 2 - 1
        st = w.step(st.replace(dof_target=tb.cmd_map.apply(u[None], st.q[None])[0]), params)
    rows_state = tfp.rows_to_state(ks, w.pack(broadcast_state(st, K)))
    assert float(rows_state["lam"].abs().max()) > 0.0, "no stiction impulse carried"
    tgt = (torch.rand(K, ks.ndof, generator=g) * 4 - 2).numpy()
    mass, fric = torch.ones(K, ks.nbody), torch.ones(K, ks.ngeom)
    old = jfp.TWO_WAY_SWEEPS
    jfp.TWO_WAY_SWEEPS = False
    try:
        ref = _jax_substep(jb, je, ks, _to_lanes(rows_state, ks, tgt), mass.numpy(), fric.numpy(),
                           te.dt_sub, 2, True)
    finally:
        jfp.TWO_WAY_SWEEPS = old
    got = tfp.substep(ks, rows_state, torch.as_tensor(tgt), mass, fric, te.dt_sub, 2, True,
                      two_way_sweeps=False)
    _compare(got, ref, ("root_pos", "root_quat", "root_linvel", "root_angvel", "q", "qd", "lam"))
    two_way = tfp.substep(ks, rows_state, torch.as_tensor(tgt), mass, fric, te.dt_sub, 2, True)
    # the switch moves the state far beyond the tolerance of the comparison
    assert float((got["root_angvel"] - two_way["root_angvel"]).abs().max()) > 10 * ATOL


def _gripper_and_far_ball():
    built = build_scene([
        ActorSpec(type="robot", name="mini_gripper", fixed=True, gripper_binarize=True,
                  init_pos=[0.0, 0.0, 0.5]),
        ActorSpec(type="sphere", name="ball", size=[0.02], mass=0.005, init_pos=[0.0, 0.0, 0.53],
                  friction=1.0),
        ActorSpec(type="sphere", name="far_ball", size=[0.05], mass=0.1, init_pos=[5.0, 5.0, 0.05],
                  friction=0.5)], SimConfig(dt=0.05, substeps=2))
    return built, TEngine(built.scene)


def gripper_inputs(built, engine, K_, H, seed, steps=4):
    """The mini-gripper closed on its ball for `steps` world steps (plain K2),
    then K1's inputs from there: (world state, K1 inputs)."""
    fw = FusedWorldStep(built, engine)
    st = built.initial_state(engine, "cpu")
    st = engine.refresh(st.replace(q=torch.full_like(st.q, 0.034)))
    params = ModelParams(torch.ones(built.scene.nbody), torch.ones(built.scene.ngeom))
    close = built.cmd_map.apply(torch.full((1, 2), -1.0), st.q[None])[0]
    for _ in range(steps):
        st = fw.step(st.replace(dof_target=close), params)
    ball = built.scene.actor_index("ball")
    spec = tfp.CostSpec(task=tfp.TASK_PANDA_PICK, ee_body=built.scene.body_offset[ball] - 1,
                        goal_actor=0, w_dist=1.0, w_ori=0.5, block_actor=ball,
                        force_body0=built.scene.body_offset[ball], force_nbody=1, w_block=2.0,
                        w_force=0.01)
    g = torch.Generator().manual_seed(seed)
    V = torch.rand(K_, H, 2, generator=g) * 2 - 1
    pm = ModelParams(torch.ones(K_, built.scene.nbody), torch.ones(K_, built.scene.ngeom))
    return st, spec, (broadcast_state(st, K_), pm, V)


def test_broadphase_gate_off_is_bit_for_bit_the_gated_twin():
    built, engine = _gripper_and_far_ball()
    st, spec, (sK, pm, V) = gripper_inputs(built, engine, 4, 2, seed=9)
    on = FusedRollout(built, engine, spec, 2, 4)
    off = FusedRollout(built, engine, spec, 2, 4, profile={"broadphase_gate": False})
    inputs = on.pack(sK, pm, V)
    (c_on, v_on), (c_off, v_off) = on.plain(*inputs), off.plain(*inputs)
    assert torch.equal(c_on, c_off) and torch.equal(v_on, v_off)
    w_on, w_off = FusedWorldStep(built, engine), FusedWorldStep(built, engine,
                                                              profile={"broadphase_gate": False})
    rows = w_on.pack(st)
    tgt = built.cmd_map.apply(torch.full((1, 2), -1.0), st.q[None])[0]
    ones_b, ones_g = torch.ones(built.scene.nbody), torch.ones(built.scene.ngeom)
    r_on, r_off = rows, rows
    for _ in range(3):
        r_on, r_off = w_on.plain(r_on, tgt, ones_b, ones_g), w_off.plain(r_off, tgt, ones_b, ones_g)
    assert torch.equal(r_on, r_off)
    assert float(r_on[w_on.ks.n_state_rows:].abs().max()) > 0.0, "no couple impulse"


def test_profile_switches_are_validated():
    assert fro.ablation(None) == ({"skip_contacts": False, "skip_dynamics": False,
                                   "zero_cost": False, "two_way_sweeps": True,
                                   "broadphase_gate": True}, 0)
    assert fro.ablation({"skip_contacts": True, "skip_dynamics": True, "zero_cost": True})[1] == 7
    assert fro.ablation({"two_way_sweeps": False}, fro.K2_SWITCHES)[1] == 8
    with pytest.raises(ValueError):
        fro.ablation({"skip_sweeps": True})
    with pytest.raises(ValueError):
        fro.ablation({"zero_cost": True}, fro.K2_SWITCHES)
    # every instantiated mask is a valid switch set, K2's a subset of K1's
    assert set(fro.K2_MASKS) <= set(fro.K1_MASKS) and all(0 < m < 32 for m in fro.K1_MASKS)
    # only the profile turns an ablation on: a switch it leaves out is not ablated
    assert fro.ablation({}, fro.K2_SWITCHES) == ({"two_way_sweeps": True,
                                                  "broadphase_gate": True}, 0)
    assert fro.ablation({"broadphase_gate": False}, fro.K2_SWITCHES)[0]["two_way_sweeps"]
    assert fro.ablation({"two_way_sweeps": True, "broadphase_gate": True})[1] == 0
