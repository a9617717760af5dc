"""The port's engine (`physics/step.Engine.step`: stacked_substep, the contact
forces, the impulse pass, physics/linalg.py) against the JAX package's XLA
engine under vmap, on the CPU.

* `solve_psd` / `solve_psd_multi` against `mppiisaac_tpu.physics.linalg` on
  random SPD and near-singular batches (rtol 1e-5), and the clamped pivot of
  a matrix that is not positive definite;
* `Engine.step` with `use_impulse=False` and `True` for a few control steps
  from the same (K-batched) states and per-sample parameters:
  - panda reach with links pushed into the ground (the cp contacts, penalty
    law, implicit drives): atol 1e-5 on every field but the contact force
    (its penalty springs turn float32 roundings into forces: rtol/atol 2e-3,
    tests/test_torch_substep.py's bound);
  - free spheres and a box on the ground, pressed together and moving (cc,
    cb, cp and bp contacts, the free-body impulse pass with its warm start):
    rtol/atol 2e-3 over 3 steps, the atol raised to 10× the port's own
    float32-vs-float64 drift where that is larger (penalty only, the contact
    force at the third step: drift 2.6e-3 N, difference 5.2e-3 N on 9 N);
  - the mini_gripper_rail grasp of tests/test_impulse_parity.py (position
    fingers closing on a free ball, then the rail moving: the couple terms,
    the Ψ two-way coupling with the exact generalized response, the stiction
    snap and the λ warm start), 12 steps: every field to 10× the port's own
    float32-vs-float64 drift over the same steps, or 1e-5 where that is
    larger (the drift is below 2e-5 in every field here, the differences to
    the JAX engine below 1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppiisaac_tpu.physics import linalg as jlinalg
from mppiisaac_tpu.physics.step import Engine as JEngine
from mppiisaac_tpu.runtime.sim import broadcast_state as j_broadcast
from mppiisaac_tpu.runtime.sim import sample_model_params as j_params
from mppiisaac_tpu.scene.actor import ActorSpec as JSpec
from mppiisaac_tpu.scene.actor import load_actor_cfgs as j_actors
from mppiisaac_tpu.scene.builder import SimConfig as JConfig
from mppiisaac_tpu.scene.builder import build_scene as j_build
from mppiisaac_tpu.utils.config_store import actors_conf_dir as j_actor_dir
from mppiisaac_tpu.utils.config_store import load_config as j_load

from mppiisaac_tpu_torch.convert import model_params_from_jax, sim_state_from_jax
from mppiisaac_tpu_torch.physics import linalg as tlinalg
from mppiisaac_tpu_torch.physics.step import Engine as TEngine
from mppiisaac_tpu_torch.physics.types import SIM_STATE_FIELDS
from mppiisaac_tpu_torch.scene.actor import ActorSpec as TSpec
from mppiisaac_tpu_torch.scene.actor import load_actor_cfgs as t_actors
from mppiisaac_tpu_torch.scene.builder import SimConfig as TConfig
from mppiisaac_tpu_torch.scene.builder import build_scene as t_build
from mppiisaac_tpu_torch.utils.config_store import actors_conf_dir, load_config

torch.set_num_threads(1)
K = 4


# ---------------------------------------------------------------------------
# linalg
# ---------------------------------------------------------------------------

def _spd(rng, n, batch, cond):
    """SPD matrices with eigenvalues spread over `cond` orders of magnitude."""
    A = rng.normal(size=batch + (n, n))
    Q, _ = np.linalg.qr(A)
    ev = 10.0 ** rng.uniform(-cond, 0.0, batch + (n,))
    return np.einsum("...ij,...j,...kj->...ik", Q, ev, Q).astype(np.float32)


@pytest.mark.parametrize("n,cond", [(3, 1), (9, 2), (9, 5), (14, 3)])
def test_solve_psd_matches_jax(n, cond):
    rng = np.random.RandomState(n + cond)
    M = _spd(rng, n, (6, 2), cond)
    b = rng.normal(size=(6, 2, n)).astype(np.float32)
    B = rng.normal(size=(6, 2, n, 5)).astype(np.float32)
    ref = np.asarray(jlinalg.solve_psd(jnp.asarray(M), jnp.asarray(b)))
    got = tlinalg.solve_psd(torch.as_tensor(M), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    ref = np.asarray(jlinalg.solve_psd_multi(jnp.asarray(M), jnp.asarray(B)))
    got = tlinalg.solve_psd_multi(torch.as_tensor(M), torch.as_tensor(B)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_solve_psd_clamps_the_pivot():
    """A matrix that is not positive definite (a zero row and column, a
    negative pivot): the pivot is clamped to 1e-9 as in JAX, no error."""
    M = np.diag([2.0, 0.0, -1.0, 3.0]).astype(np.float32)[None]
    b = np.array([[1.0, 1e-9, 0.0, 3.0]], np.float32)
    ref = np.asarray(jlinalg.solve_psd(jnp.asarray(M), jnp.asarray(b)))
    got = tlinalg.solve_psd(torch.as_tensor(M), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert np.isfinite(got).all()


# ---------------------------------------------------------------------------
# Engine.step
# ---------------------------------------------------------------------------

def _free_specs(S):
    return [S(type="sphere", name="s1", size=[0.1], mass=1.0, init_pos=[0.0, 0.0, 0.095]),
            S(type="sphere", name="s2", size=[0.1], mass=0.5, init_pos=[0.15, 0.05, 0.12]),
            S(type="box", name="b1", size=[0.2, 0.2, 0.2], mass=1.0, init_pos=[0.33, 0.05, 0.098])]


def _grasp_specs(S):
    return [S(type="robot", name="grip", urdf_file="mini_gripper_rail", fixed=True, gravity=False,
              gripper_binarize=True, init_pos=[0.0, 0.0, 0.5]),
            S(type="sphere", name="ball", size=[0.02], mass=0.005, init_pos=[0.0, 0.0, 0.53],
              friction=1.0)]


def _scenes(name, use_impulse):
    if name == "panda":
        jc, tc = j_load("tasks/panda"), load_config("tasks/panda")
        jb = j_build(j_actors(jc.actors, j_actor_dir()), jc.isaacgym, jc.initial_actor_positions)
        tb = t_build(t_actors(tc.actors, actors_conf_dir()), tc.isaacgym, tc.initial_actor_positions)
    else:
        specs, dt = (_free_specs, 0.05) if name == "free" else (_grasp_specs, 0.04)
        jb = j_build(specs(JSpec), JConfig(dt=dt, substeps=2))
        tb = t_build(specs(TSpec), TConfig(dt=dt, substeps=2))
    return jb, JEngine(jb.scene, use_impulse=use_impulse), tb, TEngine(tb.scene, use_impulse=use_impulse)


def _initial(name, jb, je, rng):
    sK = j_broadcast(jb.initial_state(je), K)
    if name == "panda":
        # bend the arm from clear of the ground into it
        q = np.tile(np.asarray(sK.q[0]), (K, 1)).astype(np.float32)
        q[:, 1] = np.linspace(0.6, 1.7, K)
        q[:, 3] = -0.3
        qd = rng.uniform(-1, 1, q.shape).astype(np.float32)
        sK = sK._replace(q=jnp.asarray(q), qd=jnp.asarray(qd))
    elif name == "free":
        rl = np.asarray(sK.root_linvel) + rng.uniform(-0.3, 0.3, sK.root_linvel.shape)
        sK = sK._replace(root_linvel=jnp.asarray(rl, jnp.float32))
    return jax.vmap(je.refresh)(sK)


def _controls(name, jb, step, rng):
    nu = jb.cmd_map.nu
    if name == "panda":
        return rng.uniform(-2, 2, (K, nu)).astype(np.float32)
    u = np.zeros((K, nu), np.float32)
    if name == "grasp":
        u[:, 1:3] = -1.0                 # fingers closed (binarized)
        if step >= 8:
            u[:, 0] = 0.8                # then the rail slides
    return u


STEPS = {"panda": 3, "free": 3, "grasp": 12}


@pytest.mark.parametrize("use_impulse", [False, True], ids=["penalty", "impulse"])
@pytest.mark.parametrize("name", ["panda", "free", "grasp"])
def test_engine_step_matches_jax(name, use_impulse):
    jb, je, tb, te = _scenes(name, use_impulse)
    assert te.substeps == je.substeps and te.tables.n_con == je.tables.n_con
    rng = np.random.RandomState(0)
    sK = _initial(name, jb, je, rng)
    pK = j_params(jb, je, K, seed=3)
    ts, tp = sim_state_from_jax(sK), model_params_from_jax(pK)
    s64, p64 = ts.map(torch.Tensor.double), tp.map(torch.Tensor.double)
    jstep = jax.jit(jax.vmap(je.step))
    worst = {}
    for i in range(STEPS[name]):
        u = _controls(name, jb, i, rng)
        sK = sK._replace(dof_target=jax.vmap(jb.cmd_map.apply)(jnp.asarray(u), sK.q))
        ts = ts.replace(dof_target=tb.cmd_map.apply(torch.as_tensor(u), ts.q))
        s64 = s64.replace(dof_target=tb.cmd_map.apply(torch.as_tensor(u).double(), s64.q))
        sK, ts, s64 = jstep(sK, pK), te.step(ts, tp), te.step(s64, p64)
        for f in SIM_STATE_FIELDS:
            j, t = np.asarray(getattr(sK, f)), getattr(ts, f).numpy()
            if not j.size:
                continue
            drift = np.abs(getattr(s64, f).numpy() - t).max()
            if name == "grasp":
                tol = dict(atol=max(1e-5, 10 * drift), rtol=0)
            elif name == "free":
                tol = dict(atol=max(2e-3, 10 * drift), rtol=2e-3)
            elif f == "net_contact_force":
                tol = dict(atol=2e-3, rtol=2e-3)
            else:
                tol = dict(atol=1e-5, rtol=0)
            np.testing.assert_allclose(t, j, err_msg=f"step {i} {f} (drift {drift:.2g})", **tol)
            worst[f] = max(worst.get(f, 0.0), float(np.abs(t - j).max()))
    # the contacts this scene is about were live
    if name == "panda":
        assert np.abs(np.asarray(sK.net_contact_force)).sum() > 10.0, "no ground contact"
    elif use_impulse:
        assert np.abs(np.asarray(sK.contact_lam)).max() > 1e-3, "the impulse pass did nothing"
    if name == "grasp":
        ball = np.asarray(sK.root_pos)[:, 1]
        assert use_impulse is False or ball[:, 0].min() > 0.05, f"the ball was not carried: {ball}"
