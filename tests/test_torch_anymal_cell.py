"""The benchmark's anymal cell (`anymal.chunked`) and the tape prior's span
and graph-node counter, on the CPU with one torch thread at K=8, H=2:

* the cell resolves its configuration, traffic and limits, and the metrics
  it reports; its configuration's `conf` is what `conf/tasks/anymal.yaml`
  composes through the port's config store;
* one command with the trot tape injected and one world step of the port's
  plain versions, from a state after the landing, equal the benchmark's
  frozen reference bit for bit from the same state, carry and draw;
* a profiled eager command records `solver.tape` once, inside
  `solver.noise`, and none without a tape (panda_reach);
* `tape_part` counts the tape's nodes only while a graph is captured,
  `take_tape_nodes` reads and resets the count, `tape_nodes_per_step`
  reads the "tape" key;
* on the card (marked `cuda`, skipped here): a captured anymal step counts
  its tape's nodes, a captured panda_reach step none. Run there with

    python -m pytest tests/test_torch_anymal_cell.py -m cuda -p no:cacheprovider --noconftest
"""
import copy
import dataclasses
import json
import os
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cellbench import judge
from cellbench.loop import Program
from cellbench.reference.controller import Reference, state_from
from cellbench.spec import HERE, load_cell
from mppiisaac_tpu_torch.mppi import prng
from mppiisaac_tpu_torch.mppi.solver import MPPIPlanner
from mppiisaac_tpu_torch.utils import confsys, profiling
from mppiisaac_tpu_torch.utils.config_store import CONF_ROOT, actors_conf_dir
from mppiisaac_tpu_torch.utils.profiling import span, spans, take_tape_nodes, tape_part

K, H = 8, 2
LANDING = 5             # world steps from the 1.2 m drop start: the feet are down by the 4th
CELL = "anymal.chunked"
# device-bound like panda_pick.chunked: step_ms and its family
PER_LAYER = ["graph_nodes_per_step", "device_idle_pct", "k1_ms", "k1_roofline_pct", "k2_ms",
             "k2_roofline_pct", "chunk_host_ms", "tape_nodes_per_step", "draws_ahead_pct"]


def config(name, num_samples=K, horizon=H):
    """The benchmark's configuration file `name`, with K and H cut."""
    c = copy.deepcopy(json.load(open(os.path.join(HERE, "configs", f"{name}.json"))))
    c["conf"]["mppi"].update(num_samples=num_samples, horizon=horizon)
    return c


def fields(state):
    return {k: v for k, v in vars(state).items() if v is not None}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def landed(one_thread):
    """The port's anymal world and planner (with its tape prior) as the
    benchmark builds them, the world stepped through the landing under
    seeded commands, and the benchmark's reference of the same
    configuration."""
    c = config("anymal")
    prog = Program(c, {"loop": "per_step", "episode_steps": 1}, torch.device("cpu"))
    world, planner = prog.world, prog.planner
    g = torch.Generator().manual_seed(2026)
    for _ in range(LANDING):
        world.apply_robot_cmd(torch.rand(planner.mppi.nu, generator=g) * 2 - 1)
        world.step()
    ref = Reference(c["conf"], c["cost"], "cpu", prior=c["reference_prior"])
    return world, planner, world.state, ref


def test_cell_resolves():
    cell = load_cell(CELL)
    assert cell.chips == 1 and cell.config["name"] == "anymal"
    assert cell.config["prior"] == "mppiisaac_tpu_torch.tasks.anymal:gait_prior"
    assert cell.config["reference_prior"] == "anymal_trot" and cell.config["reduced"] == []
    assert cell.traffic == json.load(open(os.path.join(HERE, "traffic", "chunked.json")))
    assert set(cell.limits) == {"start_gap", "cost_gap", "horizon_cost_gap", "command_gap",
                                "pose_gap"}
    assert all(v > 0 for v in cell.limits.values())
    assert [m.name for m in cell.end_to_end] == ["step_ms", "setup_s"]
    assert [m.name for m in cell.per_layer] == PER_LAYER


def test_conf_is_the_shipped_task():
    conf = confsys.compose(CONF_ROOT, "tasks/anymal", [])
    conf["actors"] = [confsys.load_yaml(os.path.join(actors_conf_dir(), f"{a}.yaml"))
                      for a in conf["actors"]]
    assert config("anymal", 400, 12)["conf"] == conf
    assert conf["mppi"]["use_priors"] and conf["mppi"]["prior_blend"] == 0.5
    assert conf["initial_actor_positions"] == [[0.0, 2.0, 1.2]]


def test_reference_equals_port_with_the_tape(landed):
    world, planner, state, ref = landed
    assert float(state.net_contact_force.abs().sum()) > 0       # standing on its feet
    assert planner.mppi.tape_prior is not None and ref.tape is not None
    planner.mppi.carry = dataclasses.replace(planner.mppi.init_carry(), key=prng.prng_key(88))
    carry = planner.mppi.carry
    injected = MPPIPlanner.tape_injections
    action, new, info = planner._full(carry, state)
    assert MPPIPlanner.tape_injections == injected + 1
    step = {"state": state_from(fields(state), "cpu"),
            "carry": judge._carry(ref, {"U": carry.U, "lambda_": carry.lambda_,
                                        "sigma": carry.sigma, "t0": carry.t0, "key": carry.key})}
    (costs,), (eps,) = ref.costs([step])
    assert torch.equal(costs, info["rollout_costs"])
    a, U, S = ref.update(step["carry"], eps, costs)
    assert torch.equal(a, action[0]) and torch.equal(U, new.U) and torch.equal(S, info["costs"])
    rows = ref.world_steps([step["state"]], [action[0]])
    after = world.stepped(world.commanded(state, action[0].expand(1, -1)))
    assert torch.equal(rows, ref.world_step.out_rows(state_from(fields(after), "cpu")))


def _command_spans(planner, state):
    """The spans of one profiled eager command from `state`: name → list
    of (record, parent's name)."""
    planner.mppi.carry = dataclasses.replace(planner.mppi.init_carry(), key=prng.prng_key(5))
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        planner.compute_action_from_state(state)
    records = spans()
    out = {}
    for r in records:
        out.setdefault(r.name, []).append((r, records[r.parent].name if r.parent >= 0 else None))
    return out


@pytest.mark.parametrize("task", ["anymal", "panda_reach"])
def test_tape_span(landed, task):
    if task == "anymal":
        _, planner, state, _ = landed
    else:
        prog = Program(config("panda_reach"), {"loop": "per_step", "episode_steps": 1},
                       torch.device("cpu"))
        planner, state = prog.planner, prog.world.state
    got = _command_spans(planner, state)
    assert [p for _, p in got["solver.noise"]] == ["planner.command"]
    if task == "panda_reach":
        assert "solver.tape" not in got
        return
    [(tape, parent)] = got["solver.tape"]
    [(noise, _)] = got["solver.noise"]
    assert parent == "solver.noise"
    assert noise.start_ns <= tape.start_ns <= tape.end_ns <= noise.end_ns


def test_tape_nodes_count_only_inside_a_capture(monkeypatch):
    """While a graph is captured each tape part adds the nodes captured
    between its start and its end, a part that raises adds none, and a take
    reads and resets the count; outside a capture a part is the shared
    no-op."""
    take_tape_nodes()
    assert tape_part() is span("off")             # the shared no-op: nothing captures here
    captured = iter(range(0, 1000, 7))            # 7 more nodes at every query
    monkeypatch.setattr(profiling, "_capturing_graph_nodes", lambda: next(captured))
    monkeypatch.setattr(profiling, "_capturing", lambda: True)
    with tape_part():
        pass
    with tape_part():
        pass
    with pytest.raises(ValueError), tape_part():
        raise ValueError
    assert take_tape_nodes() == 14 and take_tape_nodes() == 0
    with tape_part():
        pass
    assert take_tape_nodes() == 7
    monkeypatch.setattr(profiling, "_capturing", lambda: False)
    assert tape_part() is span("off")
    assert take_tape_nodes() == 0


def test_tape_nodes_are_counted_per_thread(monkeypatch):
    """A tape captured on another thread adds to that thread's count alone."""
    take_tape_nodes()
    monkeypatch.setattr(profiling, "_capturing_graph_nodes", iter(range(0, 100, 5)).__next__)
    monkeypatch.setattr(profiling, "_capturing", lambda: True)
    got = []

    def other():
        with tape_part():
            pass
        got.append(take_tape_nodes())

    t = threading.Thread(target=other)
    t.start()
    t.join()
    assert got == [5] and take_tape_nodes() == 0


def test_tape_nodes_reader():
    cell = load_cell(CELL)
    [metric] = [m for m in cell.per_layer if m.name == "tape_nodes_per_step"]
    read = cell.reader(metric)
    assert read({"graph_nodes": {"kernel": 159, "memcpy": 16, "memset": 3, "other": 0,
                                 "total": 178, "tape": 49}}) == 49.0
    assert read({"graph_nodes": {"kernel": 83, "memcpy": 16, "memset": 3, "other": 0,
                                 "total": 102}}) is None
    assert read({"graph_nodes": None}) is None and read({}) is None


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graph capture has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["anymal", "panda_reach"])
def test_captured_tape_nodes(cuda_card, task):
    """The chunk's captured step at the shipped K and H: anymal's tape adds
    nodes, panda_reach has no tape."""
    c = json.load(open(os.path.join(HERE, "configs", f"{task}.json")))
    prog = Program(c, {"loop": "chunked", "episode_steps": 200, "device_steps": 4}, cuda_card)
    prog.warm()
    nodes = prog.chunk.nodes
    assert nodes["total"] == sum(nodes[k] for k in ("kernel", "memcpy", "memset", "other"))
    if task == "anymal":
        assert 0 < nodes["tape"] < nodes["total"]
    else:
        assert nodes["tape"] == 0
    prog.free()
