"""The port's unfused rollout against the JAX package's XLA rollout, on the CPU.

`MPPIisaacPlanner(..., use_fused=False)` rolls the K samples out through the
engine's `Engine.step`, the objective's `compute_cost` and, with
`mppi.use_priors`, a closed-loop prior for sample K−2; the JAX planner with
`use_fused=False` does the same under vmap-of-scan. Both draw the noise of
the same seed (`mppi/prng.py` is the JAX threefry bit for bit), so two
commands in a row from the same world state give the same actions: held to
1e-4 (float32 engines of the same model over K=16, H=4), the per-sample
costs to 1e-4 relative.

Also: each closed-loop prior's `compute_command` against the JAX one on a few
states (1e-5), `SimConfig.fused_world=False` (the world on `Engine.step`)
against the JAX `Simulation` with `fused_world=False` over 10 steps (1e-5 on
point_robot with the sphere paper_obst1 resting on the ground, or 10× the
port's float32-vs-float64 drift where that is larger), and
an objective with a `compute_cost` only (no `kernel_cost`), which the port
refused before it had the unfused rollout.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppiisaac_tpu.planner.mppi_isaac import MPPIisaacPlanner as JPlanner
from mppiisaac_tpu.planner.priors import ArmJacobianPrior as JArmPrior
from mppiisaac_tpu.planner.priors import PointNavigationPrior as JPointPrior
from mppiisaac_tpu.runtime.sim import Simulation as JSim
from mppiisaac_tpu.tasks.panda_reach import PandaReachObjective as JPandaObj
from mppiisaac_tpu.tasks.point_robot import PointRobotObjective as JPointObj
from mppiisaac_tpu.utils.config_store import load_config as j_load

from mppiisaac_tpu_torch.convert import sim_state_from_jax
from mppiisaac_tpu_torch.physics.types import SIM_STATE_FIELDS
from mppiisaac_tpu_torch.planner.mppi_isaac import MPPIisaacPlanner as TPlanner
from mppiisaac_tpu_torch.planner.objective import Objective
from mppiisaac_tpu_torch.planner.priors import ArmJacobianPrior as TArmPrior
from mppiisaac_tpu_torch.planner.priors import PointNavigationPrior as TPointPrior
from mppiisaac_tpu_torch.runtime.sim import Simulation as TSim
from mppiisaac_tpu_torch.tasks.panda_reach import PandaReachObjective as TPandaObj
from mppiisaac_tpu_torch.tasks.point_robot import PointRobotObjective as TPointObj
from mppiisaac_tpu_torch.utils.config_store import load_config as t_load

torch.set_num_threads(1)
K, H = 16, 4
ACT_ATOL = 1e-4
PRIOR_ATOL = 1e-5
OVERRIDES = [f"mppi.num_samples={K}", f"mppi.horizon={H}"]
# (conf, actors, JAX objective, port objective, the goal actor's position)
TASKS = {
    "point_robot": ("tasks/point_robot", ["point_robot", "goal"], JPointObj, TPointObj,
                    [2.0, 2.0, 0.5]),
    "panda": ("tasks/panda", None, JPandaObj, TPandaObj, [0.5, 0.3, 0.45]),
}


def _priors(task, jworld, tworld):
    if task == "point_robot":
        return JPointPrior(), TPointPrior()
    return (JArmPrior(jworld.built, ee_link="panda_ee_tip"),
            TArmPrior(tworld.built, ee_link="panda_ee_tip"))


def _setup(task, with_prior=False, extra=()):
    conf, actors, JObj, TObj, goal = TASKS[task]
    ov = OVERRIDES + ["mppi.use_priors=true"] * with_prior + list(extra)
    jc, tc = j_load(conf, ov), t_load(conf, ov)
    if actors is not None:
        jc.actors, tc.actors = list(actors), list(actors)
    jworld = JSim(cfg=jc.isaacgym, actors=jc.actors, init_positions=jc.initial_actor_positions)
    tworld = TSim(tc.isaacgym, tc.actors, tc.initial_actor_positions, device="cpu")
    for w in (jworld, tworld):
        w.set_actor_position_by_name("goal", np.asarray(goal, np.float32))
    jprior, tprior = _priors(task, jworld, tworld) if with_prior else (None, None)
    jp = JPlanner(jc, JObj(jc), prior=jprior, use_fused=False)
    # with the closed-loop prior, use_fused=None must pick the unfused rollout
    tp = TPlanner(tc, TObj(tc), prior=tprior, device="cpu",
                  use_fused=None if with_prior else False)
    return jworld, tworld, jp, tp


def _two_commands(jworld, tworld, jp, tp):
    """Two commands in a row from the world state (the carry advances)."""
    for _ in range(2):
        a_j = np.asarray(jp.compute_action_from_state(jworld.state))
        a_t = tp.compute_action_from_state(tworld.state).numpy()
        np.testing.assert_allclose(a_t, a_j, atol=ACT_ATOL)
        c_j, c_t = np.asarray(jp.mppi.last_info["costs"]), tp.mppi.last_info["costs"].numpy()
        np.testing.assert_allclose(c_t, c_j, rtol=1e-4, atol=1e-4)
    assert np.abs(a_t).max() > 1e-3, "the commands are zero: nothing was compared"
    return a_t


@pytest.mark.parametrize("task", sorted(TASKS))
def test_unfused_commands_match_jax(task):
    jworld, tworld, jp, tp = _setup(task)
    assert tp.mppi.fused is None and not tp.use_fused
    _two_commands(jworld, tworld, jp, tp)
    vis_j, vis_t = np.asarray(jp.mppi.last_info["vis"]), tp.mppi.last_info["vis"].numpy()
    assert vis_t.shape == vis_j.shape
    np.testing.assert_allclose(vis_t, vis_j, atol=1e-4)


@pytest.mark.parametrize("task", sorted(TASKS))
def test_closed_loop_prior_commands_match_jax(task):
    """use_priors with the task's closed-loop prior: sample K−2 follows it."""
    jworld, tworld, jp, tp = _setup(task, with_prior=True)
    assert tp.mppi.prior is not None and tp.mppi.fused is None, "None must pick the unfused rollout"
    _two_commands(jworld, tworld, jp, tp)


@pytest.mark.parametrize("task", sorted(TASKS))
def test_prior_compute_command_matches_jax(task):
    """compute_command on a few K-batched states (random joints)."""
    jworld, tworld, jp, tp = _setup(task)
    jprior, tprior = _priors(task, jworld, tworld)
    rng = np.random.RandomState(3)
    D = jp.sim.built.scene.ndof
    for _ in range(3):
        q = rng.uniform(-1.0, 1.0, (K, D)).astype(np.float32)
        st = jp.sim._refresh_fn(jp.sim.state._replace(q=jnp.asarray(q)))
        jv = type(jp.sim.view)(jp.built, st)
        tv = type(tp.sim.view)(tp.built, sim_state_from_jax(st))
        u_j = np.asarray(jax_vmap_prior(jprior, jv))
        u_t = tprior.compute_command(tv).numpy()
        assert u_t.shape == u_j.shape and u_t.shape[0] == K
        np.testing.assert_allclose(u_t, u_j, atol=PRIOR_ATOL)
        assert np.abs(u_t).max() > 1e-3


def jax_vmap_prior(prior, view):
    """The JAX prior per sample, as the XLA rollout calls it (its NaN guard
    is per sample there)."""
    import jax

    from mppiisaac_tpu.planner.observables import SimView

    return jax.vmap(lambda s: prior.compute_command(SimView(view.built, s)))(view.state)


def test_use_fused_true_with_closed_loop_prior_raises():
    tc = t_load("tasks/point_robot", OVERRIDES)
    tc.actors = ["point_robot", "goal"]
    with pytest.raises(ValueError, match="closed-loop prior PointNavigationPrior"):
        TPlanner(tc, TPointObj(tc), prior=TPointPrior(), device="cpu", use_fused=True)


class _CostOnly(Objective):
    """A user objective written the reference's way: compute_cost only."""

    def __init__(self, inner):
        self.inner = inner
        self.weights = inner.weights

    def compute_cost(self, view):
        return self.inner.compute_cost(view)


def test_compute_cost_only_objective_plans():
    """An objective without kernel_cost takes the unfused rollout under
    use_fused=None and plans as the JAX planner does."""
    jworld, tworld, jp, _ = _setup("point_robot")
    tc = t_load("tasks/point_robot", OVERRIDES)
    tc.actors = ["point_robot", "goal"]
    tp = TPlanner(tc, _CostOnly(TPointObj(tc)), device="cpu")
    assert tp.mppi.fused is None
    _two_commands(jworld, tworld, jp, tp)


def test_fused_world_false_matches_jax_simulation():
    """The world on Engine.step (fused_world=False) against the JAX
    Simulation's XLA engine over 10 steps, 2 envs with their own commands.
    Each field is held to 1e-5, or to 10× the port's own float32-vs-float64
    drift over the same steps where that is larger: the resting obstacle's
    angular velocity drifts by 1.0e-5 rad/s there (and differs from the JAX
    package's by 1.1e-5), its net contact force by 1.4e-5 N."""
    jc, tc = j_load("tasks/point_robot"), t_load("tasks/point_robot")
    jc.isaacgym.fused_world = tc.isaacgym.fused_world = False
    actors = ["point_robot", "goal", "paper_obst1"]
    js = JSim(cfg=jc.isaacgym, actors=actors, num_envs=2)
    ts = TSim(tc.isaacgym, actors, num_envs=2, device="cpu")
    assert ts._world_step is ts.engine
    s64 = ts.state.map(torch.Tensor.double)
    p64 = ts.params.map(torch.Tensor.double)
    rng = np.random.RandomState(0)
    for i in range(10):
        u = rng.uniform(-1.0, 1.0, (2, 3)).astype(np.float32)
        js.apply_robot_cmd(jnp.asarray(u))
        ts.apply_robot_cmd(u)
        s64 = s64.replace(dof_target=ts.built.cmd_map.apply(torch.as_tensor(u).double(), s64.q))
        js.step()
        ts.step()
        s64 = ts.engine.step(s64, p64)
    for f in SIM_STATE_FIELDS:
        j, t = np.asarray(getattr(js.state, f)), getattr(ts.state, f).numpy()
        drift = np.abs(getattr(s64, f).numpy() - t).max()
        np.testing.assert_allclose(t, j, atol=max(1e-5, 10 * drift), err_msg=f"{f} (drift {drift:.2g})")
    assert np.abs(np.asarray(js.state.q)).max() > 0.1, "the robot did not move"
    # save/restore and add_to_envs work on the engine path too
    saved = ts.save_state()
    ts.step()
    ts.restore_state(saved)
    assert torch.equal(ts.state.q, saved.q)
    ts.add_to_envs([{"type": "sphere", "name": "extra", "size": [0.1], "init_pos": [3.0, 3.0, 0.1],
                     "mass": 1.0}])
    ts.step()
    assert all(torch.isfinite(x).all() for x in ts.state.tensors())


def test_unfused_chunk_equals_the_per_step_loop():
    """run_task with use_fused=False at device_steps=2 (on the CPU the chunk
    runs the same control step eagerly) against the per-step loop: world
    states bit for bit over 3 steps; the applied controls of the prior
    sample ride in the command's info."""
    from mppiisaac_tpu_torch.runtime.loop import run_task

    tc = t_load("tasks/point_robot", OVERRIDES + ["mppi.use_priors=true"])
    tc.actors = ["point_robot", "goal"]
    runs = {}
    for n in (1, 2):
        seen = []

        def record(w, seen=seen):
            seen.append(w.state.map(lambda x: x.clone()))
            return False

        m = run_task(tc, TPointObj(tc), prior=TPointPrior(), n_steps=3, success_fn=record,
                     device="cpu", device_steps=n)
        assert m.steps == 3 and m.final_state_finite
        runs[n] = seen
    for a, b in zip(runs[1], runs[2]):
        for f in SIM_STATE_FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_goal_changed_on_the_same_objective_reaches_the_unfused_cost():
    """A goal reassigned on the planner's own objective, then
    `update_objective` with that objective: the unfused rollout's cost reads
    the new goal (its device copy is written anew in place, which a
    captured control step also sees), as it does for a new objective with
    that goal. The two planners' second commands are equal bit for bit, and
    differ from those of a planner that kept the first goal."""
    tc = t_load("tasks/point_robot", OVERRIDES)
    tc.actors = ["point_robot", "goal"]
    new_goal = torch.tensor([-1.5, 0.5])
    out = {}
    for case in ("same objective", "new objective", "first goal"):
        world = TSim(tc.isaacgym, tc.actors, tc.initial_actor_positions, device="cpu")
        obj = TPointObj(tc)
        tp = TPlanner(tc, obj, device="cpu", use_fused=False)
        tp.compute_action_from_state(world.state)
        if case == "new objective":
            obj = TPointObj(tc)
        if case != "first goal":
            obj.nav_goal = new_goal.clone()
        tp.update_objective(obj)
        a = tp.compute_action_from_state(world.state)
        out[case] = (a, tp.mppi.last_info["costs"])
    for x, y in zip(out["same objective"], out["new objective"]):
        assert torch.equal(x, y)
    assert not torch.allclose(out["same objective"][1], out["first goal"][1])
