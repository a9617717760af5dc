"""The tape prior of the port (planner/priors.QuadrupedGaitPrior and the
solver's tape-prior branch) against the JAX package's on the anymal scene.

* The tape: the same anymal world states (random joint angles, base poses
  and goals, in both packages through the JAX engine's refresh) and the same
  step clock t0 give the same (H, 12) tape, atol 1e-5 (float32 trig of the
  heading in another library).
* The solver: one command with the tape injected (sample K − 2) and, with
  `prior_blend`, the sampling mean moved toward it, the noise ε injected and
  both solvers rolling out through the same stub cost, as
  tests/test_torch_solver.py does; U, weights and the action to 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppiisaac_tpu.mppi.solver import MPPIPlanner as JPlanner
from mppiisaac_tpu.planner.observables import SimView as JView
from mppiisaac_tpu.planner.priors import QuadrupedGaitPrior as JPrior
from mppiisaac_tpu.runtime.sim import Simulation as JSim
from mppiisaac_tpu.runtime.sim import broadcast_state as j_broadcast
from mppiisaac_tpu.utils.config_store import load_config as j_load

from mppiisaac_tpu_torch.convert import carry_from_jax, sim_state_from_jax
from mppiisaac_tpu_torch.mppi.solver import MPPIPlanner as TPlanner
from mppiisaac_tpu_torch.planner.observables import SimView as TView
from mppiisaac_tpu_torch.planner.priors import QuadrupedGaitPrior as TPrior
from mppiisaac_tpu_torch.runtime.sim import broadcast_state as t_broadcast
from mppiisaac_tpu_torch.scene.actor import load_actor_cfgs as t_actors
from mppiisaac_tpu_torch.scene.builder import SimConfig as TSimConfig
from mppiisaac_tpu_torch.scene.builder import build_scene as t_build
from mppiisaac_tpu_torch.utils.config_store import actors_conf_dir
from mppiisaac_tpu_torch.utils.config_store import load_config as t_load

from test_torch_solver import TOL, _JStub, _TStub

torch.set_num_threads(1)
TAPE_ATOL = 1e-5
# (base xy, base yaw, goal xy, t0): goal far ahead, behind to the left (a
# turn, the facing gate closed), inside the stop radius (the stride tapers)
STATES = [((0.0, 2.0), 0.3, (2.0, 2.0), 0),
          ((0.5, 1.0), 1.2, (-1.0, 1.5), 7),
          ((1.9, 1.85), -2.5, (2.0, 2.0), 113)]


def _worlds():
    jc = j_load("tasks/anymal")
    jw = JSim(cfg=jc.isaacgym, actors=jc.actors, init_positions=jc.initial_actor_positions)
    tb = t_build(t_actors(list(jc.actors), actors_conf_dir()),
                 TSimConfig(dt=jc.isaacgym.dt, substeps=jc.isaacgym.substeps))
    return jc, jw, tb


def _state(jw, rng, base_xy, yaw, goal_xy):
    """A 1-env anymal state: random joint angles, the base at base_xy (z
    0.6) turned by yaw, the goal at goal_xy."""
    js = jax.tree.map(lambda x: x[0], jw.state)
    s = jw.scene
    a, g = s.actor_index("anymal"), s.actor_index("goal")
    q = jnp.asarray(rng.uniform(-0.5, 0.5, js.q.shape), jnp.float32)
    rp = js.root_pos.at[a].set(jnp.array([base_xy[0], base_xy[1], 0.6]))
    rp = rp.at[g, :2].set(jnp.asarray(goal_xy))
    rq = js.root_quat.at[a].set(jnp.array([0.0, 0.0, np.sin(yaw / 2), np.cos(yaw / 2)]))
    return jw.engine.refresh(js._replace(q=q, root_pos=rp, root_quat=rq))


@pytest.mark.parametrize("case", range(len(STATES)))
def test_gait_tape_matches_jax(case):
    jc, jw, tb = _worlds()
    base_xy, yaw, goal_xy, t0 = STATES[case]
    js = _state(jw, np.random.RandomState(case), base_xy, yaw, goal_xy)
    kw = dict(H=jc.mppi.horizon, dt=jc.isaacgym.dt)
    ref = np.asarray(JPrior(**kw).tape(JView(jw.built, js), t0))
    got = TPrior(**kw).tape(TView(tb, sim_state_from_jax(js)), t0)
    assert got.shape == (jc.mppi.horizon, 12) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=TAPE_ATOL)
    # the tape is not the posture PD alone: the gait moves the thighs
    assert np.abs(ref[:, 1::3] + 2.0 * np.asarray(js.q)[None, 1::3]).max() > 0.05


@pytest.mark.parametrize("overrides", [[], ["mppi.prior_blend=0.0"]])
def test_command_with_tape_prior_matches_jax(overrides):
    """anymal's solver (K=400, H=12, prior_blend 0.5, and 0: the tape as one
    sample only) from a state with the goal ahead, at step clock t0 = 5."""
    jc, tc = j_load("tasks/anymal", overrides), t_load("tasks/anymal", overrides)
    jw = JSim(cfg=jc.isaacgym, actors=jc.actors, init_positions=jc.initial_actor_positions)
    tb = t_build(t_actors(list(tc.actors), actors_conf_dir()),
                 TSimConfig(dt=tc.isaacgym.dt, substeps=tc.isaacgym.substeps))
    K = jc.mppi.num_samples
    js = _state(jw, np.random.RandomState(5), (0.0, 2.0), 0.2, (2.0, 2.0))
    kw = dict(H=jc.mppi.horizon, dt=jc.isaacgym.dt)
    jprior, tprior = JPrior(**kw), TPrior(**kw)

    def j_tape(state_single, t0):
        return jprior.tape(JView(jw.built, state_single[0]), t0)

    def t_tape(state0, t0):
        return tprior.tape(TView(tb, state0[0].map(lambda x: x[0])), t0)

    jp = JPlanner(jc.mppi, jc.nx, dynamics=None, running_cost=None, fused=_JStub(),
                  tape_prior=j_tape)
    tp = TPlanner(tc.mppi, tc.nx, fused=_TStub(), tape_prior=t_tape, device="cpu")
    rng = np.random.RandomState(11)
    carry = jp.init_carry()
    carry = carry._replace(U=jnp.asarray(rng.uniform(-0.5, 0.5, carry.U.shape), jnp.float32),
                           t0=jnp.asarray(5, carry.t0.dtype))
    _, sub = jax.random.split(carry.key)
    eps = np.asarray(jp._sample_noise(sub, carry.sigma))
    a_j, c_j, i_j = jp._command_impl(carry, (j_broadcast(js, K), None))
    n0 = TPlanner.tape_injections
    a_t, c_t, i_t = tp._command_impl(carry_from_jax(carry),
                                     (t_broadcast(sim_state_from_jax(js), K), None),
                                     eps=torch.tensor(eps))
    assert TPlanner.tape_injections == n0 + 1

    def close(t, j, what):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL, atol=TOL, err_msg=what)

    close(i_t["costs"], i_j["costs"], "costs S")
    close(i_t["weights"], i_j["weights"], "weights")
    close(a_t, a_j, "action")
    close(c_t.U, c_j.U, "U")


def test_closed_loop_prior_is_refused():
    """A `compute_command` prior runs only inside the unfused rollout: the
    port's planner refuses it with use_fused=True by that reason (the JAX
    package drops the prior there), and takes the unfused rollout for it
    under use_fused=None (tests/test_torch_unfused.py holds that rollout)."""
    from mppiisaac_tpu_torch.planner.mppi_isaac import MPPIisaacPlanner
    from mppiisaac_tpu_torch.tasks.anymal import AnymalObjective

    class ClosedLoop:
        def compute_command(self, view):
            return None

    cfg = t_load("tasks/anymal", ["mppi.num_samples=8", "mppi.horizon=2"])
    with pytest.raises(ValueError, match="closed-loop prior"):
        MPPIisaacPlanner(cfg, AnymalObjective(cfg), ClosedLoop(), device="cpu", use_fused=True)
    planner = MPPIisaacPlanner(cfg, AnymalObjective(cfg), ClosedLoop(), device="cpu")
    assert planner.mppi.fused is None and planner.mppi.prior is not None
