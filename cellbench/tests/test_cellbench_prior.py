"""The reference's tape prior and sample stage equal the port's, on the CPU:
the trot tape of anymal bit for bit against `QuadrupedGaitPrior.tape`, and
the controls V and ε_eff of `Reference.sample` against the V that the
port's `MPPIPlanner._command_impl` hands to its fused rollout, from the same
state, carry and draw. Without a prior (panda_reach) `sample` is what it
was: the noise around U, clamped, with the null action."""
import copy
import dataclasses
import json
import os

import pytest
import torch

from cellbench import judge
from cellbench.loop import Program
from cellbench.reference.controller import Reference, state_from
from cellbench.reference.kernels import stored
from cellbench.spec import HERE

K = 8


def program(c):
    """The port's world and planner for a configuration file, on the CPU,
    built by the benchmark's `Program`."""
    return Program(c, {"loop": "per_step", "episode_steps": 1}, torch.device("cpu"))


def fields(state):
    return {k: v for k, v in vars(state).items() if v is not None}


def seeded_states(world, nu, seed, n):
    """The goal-placed initial state, then `n` world steps under commands
    drawn from `seed`."""
    g = torch.Generator().manual_seed(seed)
    states = [world.state]
    for _ in range(n):
        world.apply_robot_cmd(torch.rand(nu, generator=g) * 4 - 2)
        world.step()
        states.append(world.state)
    return states


def goal_near(state, built, offset=(0.1, -0.15)):
    """The state with the goal moved to the base's xy plus `offset`: inside
    the tape's stop radius (0.4 m)."""
    scene = built.scene
    base = state.body_pos[0, scene.body_index("base", "anymal")]
    root_pos = state.root_pos.clone()
    g = scene.actor_index("goal")
    root_pos[0, g, :2] = base[:2] + torch.tensor(offset)
    return state.replace(root_pos=root_pos)


@pytest.fixture(scope="module")
def anymal_scene(anymal_config):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        c = anymal_config(K)
        prog = program(c)
        planner, prior = prog.planner, prog.planner._prior
        states = seeded_states(prog.world, planner.mppi.nu, 2024, 2)
        states.append(goal_near(states[-1], planner.built))
        ref = Reference(c["conf"], c["cost"], "cpu", prior=c["reference_prior"])
    finally:
        torch.set_num_threads(n)
    return planner, prior, states, ref


def port_V(monkeypatch, planner, carry, state, draw):
    """The V that `_command_impl` hands to the fused rollout (a spy that
    stops the command there)."""
    seen = {}

    class Stop(Exception):
        pass

    def spy(sim_state_K, params_K, V):
        seen["V"] = V.clone()
        raise Stop

    monkeypatch.setattr(planner.mppi.fused, "rollout", spy)
    with pytest.raises(Stop):
        planner._full(carry, state, draw=draw)
    return seen["V"] / planner.mppi.cfg.u_scale


def carries(planner, t0, seed):
    """A port carry with U drawn from `seed` inside the control bounds, the
    step clock at t0 and the key of `seed`, and the reference's copy of it."""
    from mppiisaac_tpu_torch.mppi import prng

    mppi = planner.mppi
    g = torch.Generator().manual_seed(seed)
    U = (torch.rand(mppi.carry.U.shape, generator=g) * 2 - 1) * mppi._u_max
    carry = dataclasses.replace(mppi.init_carry(), U=U, t0=torch.tensor(t0, dtype=torch.int64),
                                key=prng.prng_key(seed))
    return carry, {"U": carry.U, "lambda_": carry.lambda_, "sigma": carry.sigma,
                   "t0": carry.t0, "key": carry.key}


@pytest.mark.parametrize("t0", [0, 7, 10, 25], ids=["t0", "t7", "one_period", "t25"])
@pytest.mark.parametrize("which", [0, 1, 2, 3], ids=["initial", "step1", "step2", "goal_near"])
def test_tape_equals_port(anymal_scene, t0, which):
    from mppiisaac_tpu_torch.planner.observables import SimView

    planner, prior, states, ref = anymal_scene
    state = states[which]
    want = prior.tape(SimView(planner.built, state.map(lambda x: x[0])),
                      torch.tensor(t0, dtype=torch.int64))
    got = ref.tape(state_from(fields(state), "cpu"), torch.tensor(t0, dtype=torch.int64))
    assert torch.equal(got, want)
    assert got.shape == (planner.mppi.cfg.horizon, 12) and bool(got.abs().max() > 0)
    if which == 3:      # inside the stop radius the stride tapers
        far = prior.tape(SimView(planner.built, states[2].map(lambda x: x[0])),
                         torch.tensor(t0, dtype=torch.int64))
        assert not torch.equal(got, far)


@pytest.mark.parametrize("t0,seed", [(0, 5), (7, 6), (25, 7)])
@pytest.mark.parametrize("which", [0, 2, 3], ids=["initial", "step2", "goal_near"])
def test_sample_equals_port(monkeypatch, anymal_scene, t0, seed, which):
    planner, _, states, ref = anymal_scene
    state = states[which]
    carry, copied = carries(planner, t0, seed)
    draw = ref.draw(carry.key)
    want = port_V(monkeypatch, planner, carry, state, draw)
    V, eps_eff = ref.sample(state_from(fields(state), "cpu"), judge._carry(ref, copied), draw)
    assert torch.equal(V, want)
    assert torch.equal(eps_eff, want - carry.U[None])
    # the tape's sample, and the blend that moves every other sample
    tape = torch.clamp(ref.tape(state_from(fields(state), "cpu"), carry.t0),
                       ref.solver._u_min, ref.solver._u_max)
    assert torch.equal(V[K - 2], tape) and bool((V[K - 1] == 0).all())
    plain = torch.clamp(carry.U[None] + ref.solver.noise(draw, carry.sigma),
                        ref.solver._u_min, ref.solver._u_max)
    assert not torch.equal(V[: K - 2], plain[: K - 2])


def test_control_stores_the_tape(anymal_scene, anymal_config):
    """The bfloat16 control keeps the tape in bfloat16 as it keeps the noise."""
    planner, _, states, ref = anymal_scene
    c = anymal_config(K)
    ctl = Reference(c["conf"], c["cost"], "cpu", store=torch.bfloat16,
                    prior=c["reference_prior"])
    carry, copied = carries(planner, 7, 5)
    state = state_from(fields(states[2]), "cpu")
    V, _ = ctl.sample(state, judge._carry(ctl, copied), ctl.draw(carry.key))
    tape = torch.clamp(ctl.tape(state, carry.t0), ctl.solver._u_min, ctl.solver._u_max)
    assert torch.equal(V[K - 2], stored(tape, torch.bfloat16))
    assert not torch.equal(V[K - 2], tape)


def test_sample_without_a_prior_is_unchanged(monkeypatch):
    c = copy.deepcopy(json.load(open(os.path.join(HERE, "configs", "panda_reach.json"))))
    c["conf"]["mppi"].update(num_samples=K, horizon=2)
    assert "prior" not in c and "reference_prior" not in c
    prog = program(c)
    planner = prog.planner
    ref = Reference(c["conf"], c["cost"], "cpu")
    assert planner._prior is None and ref.tape is None
    for state in seeded_states(prog.world, planner.mppi.nu, 31, 1):
        carry, copied = carries(planner, 3, 9)
        draw = ref.draw(carry.key)
        want = port_V(monkeypatch, planner, carry, state, draw)
        V, eps_eff = ref.sample(state_from(fields(state), "cpu"), judge._carry(ref, copied), draw)
        s = ref.solver
        old = torch.clamp(carry.U[None] + s.noise(draw, carry.sigma), s._u_min, s._u_max)
        old[K - 1] = 0.0
        assert torch.equal(V, want) and torch.equal(V, old)
        assert torch.equal(eps_eff, old - carry.U[None])
