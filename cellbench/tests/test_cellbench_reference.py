"""The frozen reference equals the port's plain versions today, on the CPU at
small sizes, and imports nothing of the port."""
import copy
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cellbench import judge
from cellbench.reference.controller import Reference, state_from
from cellbench.spec import HERE, ROOT

SMALL = {"num_samples": 8, "horizon": 2}


def config(name):
    c = json.load(open(os.path.join(HERE, "configs", f"{name}.json")))
    c = copy.deepcopy(c)
    c["conf"]["mppi"].update(SMALL)
    return c


def port(c):
    """The port's world and planner for a configuration file, on the CPU."""
    import importlib

    from mppiisaac_tpu_torch.planner.mppi_isaac import MPPIisaacPlanner
    from mppiisaac_tpu_torch.runtime.loop import goal_world
    from mppiisaac_tpu_torch.utils.config_store import config_from_dict

    cfg = config_from_dict(c["conf"])
    mod, cls = c["objective"].split(":")
    obj = getattr(importlib.import_module(mod), cls)(cfg, **c["objective_kwargs"])
    cpu = torch.device("cpu")
    return goal_world(cfg, cpu), MPPIisaacPlanner(cfg, obj, device=cpu)


def same_tables(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert np.array_equal(x, y), f.name
        elif f.name != "cost":
            assert x == y, f.name
    assert dataclasses.asdict(a.cost) == dataclasses.asdict(b.cost) if a.cost else b.cost is None


@pytest.mark.parametrize("name", ["panda_reach", "panda_pick"])
def test_reference_equals_port(name):
    c = config(name)
    world, planner = port(c)
    ref = Reference(c["conf"], c["cost"], "cpu")
    same_tables(ref.rollout.ks, planner.mppi.fused.ks)
    same_tables(ref.world_step.ks, world._world_step.ks)
    assert torch.equal(ref.params_K.body_mass_scale, planner._params_K.body_mass_scale)
    assert torch.equal(ref.params_K.geom_friction, planner._params_K.geom_friction)
    for f, v in judge.to_host(vars(world.state)).items():
        if v is not None:
            assert torch.equal(v, getattr(ref.initial_world, f)), f

    # one command and one world step of the port (its plain versions) from a
    # moved state, against the reference from the same state and carry
    from mppiisaac_tpu_torch.mppi import prng

    world.apply_robot_cmd(torch.full((planner.mppi.nu,), 0.05))
    world.step()
    state = world.state
    planner.mppi.carry = dataclasses.replace(planner.mppi.init_carry(), key=prng.prng_key(77))
    carry = planner.mppi.carry
    action, new, info = planner._full(carry, state)
    step = {"state": state_from({k: v for k, v in vars(state).items() if v is not None}, "cpu"),
            "carry": judge._carry(ref, {"U": carry.U, "lambda_": carry.lambda_,
                                        "sigma": carry.sigma, "t0": carry.t0, "key": carry.key})}
    (costs,), (eps,) = ref.costs([step])
    assert torch.equal(costs, info["rollout_costs"])
    a, U, S = ref.update(step["carry"], eps, costs)
    assert torch.equal(a, action[0]) and torch.equal(U, new.U) and torch.equal(S, info["costs"])
    rows = ref.world_steps([step["state"]], [action[0]])
    after = world.stepped(world.commanded(state, action[0].expand(1, -1)))
    got = ref.world_step.out_rows(state_from({k: v for k, v in vars(after).items()
                                              if v is not None}, "cpu"))
    assert torch.equal(rows, got)


def test_reference_imports_nothing_of_the_port():
    code = (
        "import json, sys\n"
        "from cellbench.reference.controller import Reference\n"
        "from cellbench.reference import count\n"
        "from cellbench.reference.priors import anymal_trot\n"
        "from cellbench import judge\n"
        f"c = json.load(open({os.path.join(HERE, 'configs', 'panda_pick.json')!r}))\n"
        "c['conf']['mppi'].update(num_samples=4, horizon=1)\n"
        "r = Reference(c['conf'], c['cost'], 'cpu')\n"
        "r.costs([{'state': r.initial_world, 'carry': r.initial_carry(1)}])\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not top & {"mppiisaac_tpu_torch", "mppiisaac_tpu", "jax", "jaxlib", "flax"}
