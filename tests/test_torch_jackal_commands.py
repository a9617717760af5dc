"""multi_jackal's commands and world steps, recorded on the card along the
port's own episodes, held against the JAX package on the CPU.

`tests/data/multi_jackal_commands.npz` holds control steps that
`python -m mppiisaac_tpu_torch.validate jackal seeds=42,0,1,2,3,4
n_steps=400 device_steps=1 record=...` recorded on the card (the conf's K=300
and H=12): seed 42's initial state, states along seeds 0-4, and the last
steps of episodes that stalled (reached neither goal within 400 steps).
Each record holds the world state before the step, the solver carry before
the command, the card's command and the state after K2, and beside them
what `scripts/jackal_commands_jax.py` computed on the CPU: the JAX
package's outputs from the same inputs and the port plain's own rounding
in every measure.

The first records (the npz's `tier1`: seed 42's initial state and two or more
stalled states) are held live here: the JAX package's command (its Pallas K1
in interpret mode) and K2 (interpret mode), and the port's float32 plain
command and K2, from the record's inputs; the draw bit for bit; the noise,
the rollout's costs (largest, first step's, median over samples), S, the
new U and the action, and the state after K2 by row group, each within 10×
the port plain's own rounding stored beside the record (the larger of its
float32-vs-float64 drift and its envelope over copies of the state rounded
by one float32 ulp; floor 1e-6), for JAX against the card and against the
port. `-m slow` holds the other records the same way and recomputes every
record's drift and envelope.

The JAX command's compile takes about two minutes on one core (the Pallas
kernel in interpret mode at K=300); each record then takes about 15 s, most
of it the port's plain command.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
import jackal_commands_jax as J  # noqa: E402

torch.set_num_threads(1)
RECORDS = os.path.join(os.path.dirname(__file__), "data", "multi_jackal_commands.npz")
DATA = J.load(RECORDS)
TIER1 = [int(i) for i in np.flatnonzero(DATA["tier1"])]
OTHERS = [int(i) for i in np.flatnonzero(~DATA["tier1"])]
MEASURES = J.COMMAND_MEASURES + J.K2_MEASURES


def _name(i):
    return f"seed{int(DATA['seed'][i])}-step{int(DATA['step'][i])}"


@pytest.fixture(scope="module")
def sides():
    mass, fric = J.params(DATA)
    return J.JaxSide(mass, fric), J.PortSide(mass, fric)


def test_the_records():
    """At least 12 records of seeds 42 and 0-4, recorded on the card at the
    conf's K and H, two or more from stalled episodes; the tier-1 ones
    include seed 42's initial state and two stalled states."""
    seeds, steps, stalled = DATA["seed"], DATA["step"], DATA["stalled"]
    assert len(seeds) >= 12 and set(seeds.tolist()) <= {42, 0, 1, 2, 3, 4}
    assert (int(DATA["K"]), int(DATA["H"])) == (300, 12)
    assert "H100" in str(DATA["device"])
    assert stalled.sum() >= 2
    t1 = DATA["tier1"]
    assert t1.sum() >= 4 and (t1 & stalled).sum() >= 2
    assert (t1 & (seeds == 42) & (steps == 0)).any()
    for k in MEASURES:
        for kind in ("drift", "envelope"):
            assert np.isfinite(DATA[f"{kind}.{k}"]).all() and (DATA[f"{kind}.{k}"] >= 0).all()


def _hold(sides, i):
    jx_side, p32 = sides
    r = J.record(DATA, i)
    jx, c32 = jx_side.command(r), p32.command(r)
    j_rows = p32.rows(J._fields(jx_side.world_step(r))).double().numpy()
    drift = {k: float(r[f"drift.{k}"]) for k in MEASURES}
    env = {k: float(r[f"envelope.{k}"]) for k in MEASURES}
    ks = p32.world._world_step.ks
    res = J.compare(r, jx, j_rows, c32, p32.world_step(r).double().numpy(), drift, env, ks,
                    {k: r[f"card.{k}"] for k in J.OUTPUTS}, p32.rows(r["after"]).double().numpy())
    assert res["draw_bit_for_bit"], "the port's draw differs from jax.random's"
    bad = {f"{side} {k}": (v, res["bound"][k]) for side in ("jax_vs_card", "jax_vs_port")
           for k, v in res[side].items() if v > res["bound"][k]}
    assert not bad, f"{_name(i)}: beyond 10x the port plain's own rounding: {bad}"
    # the JAX outputs stored for chip_smoke.py phase 21 are the JAX package's
    stored = {"costs": r["jax.costs"], "S": r["jax.S"], "U": r["jax.U"], "action": r["jax.action"]}
    now = J.command_measures(jx, stored)
    now.update(J.groups(ks, j_rows - r["jax.after_rows"].astype(np.float64)))
    assert all(now[k] <= res["bound"][k] for k in now), now


@pytest.mark.parametrize("i", TIER1, ids=_name)
def test_card_and_port_hold_against_jax(sides, i):
    _hold(sides, i)


@pytest.mark.slow
@pytest.mark.parametrize("i", OTHERS, ids=_name)
def test_other_records_hold_against_jax(sides, i):
    _hold(sides, i)


@pytest.mark.slow
@pytest.mark.parametrize("i", TIER1 + OTHERS, ids=_name)
def test_stored_rounding_is_the_port_plain_rounding(i):
    """Each record's stored drift (float32 against float64) and envelope
    (float32 from rounded copies of the state) are the port plain's own,
    recomputed."""
    mass, fric = J.params(DATA)
    p32, p64 = J.PortSide(mass, fric), J.PortSide(mass, fric, torch.float64)
    r = J.record(DATA, i)
    drift, env = J.rounding(p32, p64, r, p32.command(r), p32.world_step(r))
    for k in MEASURES:
        np.testing.assert_allclose(drift[k], float(r[f"drift.{k}"]), rtol=1e-6, atol=1e-12,
                                   err_msg=k)
        np.testing.assert_allclose(env[k], float(r[f"envelope.{k}"]), rtol=1e-6, atol=1e-12,
                                   err_msg=k)


def test_a_recorded_step_replays_bit_for_bit(tmp_path):
    """The recorder keeps exactly a command's and a world step's inputs: on
    the same device they give the recorded outputs again, bit for bit (a
    cut multi_jackal on the CPU)."""
    from mppiisaac_tpu_torch.mppi.solver import MppiCarry
    from mppiisaac_tpu_torch.physics.types import SimState
    from mppiisaac_tpu_torch.planner.mppi_isaac import MPPIisaacPlanner
    from mppiisaac_tpu_torch.runtime.loop import CommandRecorder, goal_world, run_task_episodes
    from mppiisaac_tpu_torch.tasks.multi_robot import MultiJackalObjective
    from mppiisaac_tpu_torch.utils.config_store import load_config

    cfg = load_config("tasks/multi_jackal", ["mppi.num_samples=8", "mppi.horizon=3"])
    obj = MultiJackalObjective(cfg)
    rec = CommandRecorder(every=2, last=1)
    run_task_episodes(cfg, obj, [7], n_steps=3, device="cpu", recorder=rec)
    rec.save(str(tmp_path / "r.npz"))
    d = J.load(str(tmp_path / "r.npz"))
    assert d["step"].tolist() == [0, 2] and d["stalled"].all()
    assert d["traj0.q"].shape[0] == 3
    planner = MPPIisaacPlanner(cfg, obj, device="cpu")
    world = goal_world(cfg, "cpu")
    for i in range(len(d["step"])):
        r = J.record(d, i)
        carry = MppiCarry(U=torch.as_tensor(r["carry.U"]), lambda_=torch.as_tensor(r["carry.lambda"]),
                          sigma=torch.as_tensor(r["carry.sigma"]),
                          t0=torch.tensor(int(r["carry.t0"])), key=r["carry.key"])
        ws = SimState(**{f: torch.as_tensor(v) for f, v in r["before"].items()})
        action, new, info = planner._full(carry, ws)
        for k, v in (("S", info["costs"]), ("costs", info["rollout_costs"]), ("U", new.U),
                     ("action", action.reshape(-1))):
            np.testing.assert_array_equal(v.numpy(), r[f"card.{k}"], err_msg=k)
        after = world.stepped(world.commanded(ws, torch.as_tensor(r["card.action"])[None]))
        for f, v in r["after"].items():
            np.testing.assert_array_equal(getattr(after, f).numpy(), v, err_msg=f)


def test_moved_starts_move_each_jackal_by_the_given_metres():
    """validate.py jackal perturb=M: each jackal's root moved by ±metres in x,
    y and z, signs drawn from (seed, move), nothing else moved."""
    from mppiisaac_tpu_torch.runtime.loop import goal_world
    from mppiisaac_tpu_torch.tasks.multi_robot import MultiJackalObjective
    from mppiisaac_tpu_torch.utils.config_store import load_config
    from mppiisaac_tpu_torch.validate import moved_start

    world = goal_world(load_config("tasks/multi_jackal"), "cpu")
    rp0 = world.root_state.clone()
    idx = MultiJackalObjective.robot_actor_indices(world.scene)
    signs = []
    for move in (1, 2):
        world.state = world._initial_state
        moved_start(move, 1e-6)(42, world)
        d = (world.root_state - rp0).double()
        np.testing.assert_allclose(d[0, idx, :3].abs().numpy(), 1e-6, rtol=0.2)
        others = [a for a in range(d.shape[1]) if a not in idx]
        assert float(d[0, :, 3:].abs().max()) == 0.0 and float(d[0, others].abs().max()) == 0.0
        signs.append(torch.sign(d[0, idx, :3]))
    assert not torch.equal(signs[0], signs[1])
