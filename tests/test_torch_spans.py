"""The port's spans (`utils/profiling.span`), on the CPU at point_robot's
K=16, H=4:

* under torch.profiler, a per-step episode (`run_steps`) and a chunked one
  (`_run_chunked`, the CPU's eager chunk) record the span tree the loop,
  the planner, the solver, K1's and K2's wrappers and the world step open:
  one root per control step or chunk, each span inside its parent's
  interval, every name among the profiler's own events;
* with the profiler off nothing is recorded, and the actions and world
  states equal the profiled run's bit for bit;
* `paused()` (a CUDA graph capture) records nothing; past SPAN_CAP records
  are dropped and counted; each thread keeps its own parents;
* `device_time` (the busy time of `trace`) leaves out the marks spans leave
  on the device's timeline.
"""
import dataclasses
import threading
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mppiisaac_tpu_torch.mppi import prng
from mppiisaac_tpu_torch.physics.types import SIM_STATE_FIELDS
from mppiisaac_tpu_torch.planner.mppi_isaac import MPPIisaacPlanner
from mppiisaac_tpu_torch.runtime.loop import DeviceChunk, _run_chunked, goal_world, run_steps
from mppiisaac_tpu_torch.tasks.point_robot import PointRobotObjective
from mppiisaac_tpu_torch.utils import profiling
from mppiisaac_tpu_torch.utils.config_store import load_config
from mppiisaac_tpu_torch.utils.profiling import device_time, paused, span, spans

torch.set_num_threads(1)
STEPS, CHUNK = 3, 2

# the span tree: (name, its parent's name) pairs; the first is the root
COMMAND = {"planner.broadcast": "planner.command", "solver.draw": "planner.command",
           "solver.noise": "planner.command", "k1.pack": "planner.command",
           "k1.launch": "planner.command", "solver.update": "planner.command"}
WORLD = {"k2.pack": "world.step", "k2.launch": "world.step", "k2.unpack": "world.step",
         "world.refresh": "world.step"}
PER_STEP = {"loop.step": None, "planner.command": "loop.step", "world.step": "loop.step",
            "loop.readback": "loop.step", **COMMAND, **WORLD}
# one chunk: the chunk's phases under loop.chunk; on the CPU its steps run
# eagerly under chunk.replay, with the draws made ahead (no solver.draw) and
# no planner.command; the first chunk draws the second's under chunk.ahead
STEP_IN_CHUNK = {**{k: "chunk.replay" for k in COMMAND if k != "solver.draw"},
                 "world.step": "chunk.replay", **WORLD}
CHUNKED = {"loop.chunk": None, "loop.observe": "loop.chunk",
           **{f"chunk.{p}": "loop.chunk"
              for p in ("draws", "load", "replay", "ahead", "fetch", "store", "unpack",
                        "rebroadcast")},
           **STEP_IN_CHUNK}
PER_STEP, CHUNKED = list(PER_STEP.items()), list(CHUNKED.items()) + [("planner.broadcast",
                                                                       "chunk.rebroadcast")]


@pytest.fixture(scope="module")
def built():
    cfg = load_config("tasks/point_robot", ["mppi.num_samples=16", "mppi.horizon=4"])
    world = goal_world(cfg, "cpu")
    planner = MPPIisaacPlanner(cfg, PointRobotObjective(cfg), randomize=False, device="cpu")
    return cfg, world, planner, world.state, DeviceChunk(world, planner, CHUNK)


def _episode(built, loop):
    """One episode from the initial state and a fixed carry → (actions,
    world states) after each step."""
    cfg, world, planner, initial, chunk = built
    world.state = initial
    planner.mppi.carry = dataclasses.replace(planner.mppi.init_carry(), key=prng.prng_key(7))
    actions, states = [], []
    if loop == "per_step":
        run_steps(world, planner.compute_action_from_state, STEPS, cfg.isaacgym.dt,
                  observer=lambda i, w, a: (actions.append(a.clone()),
                                            states.append(w.state.map(torch.Tensor.clone))))
    else:
        _run_chunked(chunk, 2 * CHUNK, cfg.isaacgym.dt,
                     chunk_observer=lambda i, w, a: (actions.append(torch.from_numpy(a.copy())),
                                                     states.append(w.state)))
    return actions, states


@pytest.fixture(scope="module", params=["per_step", "chunked"])
def profiled(request, built):
    """One episode under torch.profiler → (loop, its spans, the names on the
    profiler's timeline, its actions and world states)."""
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = _episode(built, request.param)
    records = spans()
    profiling.clear()
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    return request.param, records, names, out


def _names(rec, records):
    return rec.name, (records[rec.parent].name if rec.parent >= 0 else None)


def test_span_tree(profiled):
    loop, records, timeline, _ = profiled
    tree, roots = (PER_STEP, STEPS) if loop == "per_step" else (CHUNKED, 2)
    assert {_names(r, records) for r in records} == set(tree)
    top = [i for i, r in enumerate(records) if r.parent < 0]
    assert [records[i].name for i in top] == [tree[0][0]] * roots
    if loop == "chunked":
        assert [records[i].attrs for i in top] == [{"steps": CHUNK}] * roots
        # the second chunk's draws were made during the first's replays
        assert [r.attrs for r in records if r.name == "chunk.draws"] == [{"ahead": 0},
                                                                         {"ahead": 1}]
        assert [r.root for r in records if r.name == "chunk.ahead"] == [top[0]]
    for i, r in enumerate(records):
        assert 0 < r.start_ns <= r.end_ns
        root = records[r.root]
        assert root.parent < 0 and root.start_ns <= r.start_ns and r.end_ns <= root.end_ns
        if r.parent >= 0:
            p = records[r.parent]
            assert r.root == p.root and p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
        else:
            assert r.root == i
    # each root holds one control step's spans, or one chunk's
    for i in top:
        own = [r.name for r in records if r.root == i]
        assert own.count("world.step") == (1 if loop == "per_step" else CHUNK)
    # the same spans stand on the profiler's timeline
    assert {n for n, _ in tree} <= timeline


def test_off_records_nothing_and_changes_nothing(built, profiled):
    loop, _, _, on = profiled
    profiling.clear()
    off = _episode(built, loop)
    assert spans() == [] and profiling.dropped == 0
    assert len(on[0]) == len(off[0]) == (STEPS if loop == "per_step" else 2 * CHUNK)
    for a, b in zip(on[0], off[0]):
        assert torch.equal(a, b)
    for a, b in zip(on[1], off[1]):
        for f in SIM_STATE_FIELDS:
            if getattr(a, f) is not None:
                assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_off_is_one_shared_object(monkeypatch):
    """Off, a span never enters record_function (which costs ~10 µs even
    with the profiler off)."""

    def refused(name):
        raise AssertionError(f"record_function({name!r}) entered with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    profiling.clear()
    s = span("loop.step")
    assert s is span("world.step", steps=2)
    with s:
        pass
    assert spans() == []


def test_set_adds_attributes(monkeypatch):
    """An open span takes attributes after it opened; off, `span` gives
    None; a span past the cap takes them and records nothing."""
    profiling.clear()
    with span("chunk.fetch", a=1) as s:
        assert s is None
    with profile(activities=[ProfilerActivity.CPU]):
        with span("chunk.fetch", a=1) as s:
            s.set(b=2)
            s.set(a=3)
        monkeypatch.setattr(profiling, "SPAN_CAP", 1)
        with span("chunk.fetch") as s:
            s.set(c=4)
    assert [(r.name, r.attrs) for r in spans()] == [("chunk.fetch", {"a": 3, "b": 2})]
    assert profiling.dropped == 1
    profiling.clear()


def test_paused_records_nothing():
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("chunk.capture"):
            with paused():
                with span("world.step"):
                    pass
            with span("chunk.replay"):
                pass
    assert [(r.name, r.parent) for r in spans()] == [("chunk.capture", -1), ("chunk.replay", 0)]
    assert "world.step" not in {e.name for e in prof.events()}
    profiling.clear()


def test_cap_drops_and_counts(monkeypatch):
    monkeypatch.setattr(profiling, "SPAN_CAP", 3)
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with span("loop.step"):
                with span("world.step"):
                    with span("k2.launch"):
                        pass
    assert [r.name for r in spans()] == ["loop.step", "world.step", "k2.launch"]
    assert profiling.dropped == 3
    profiling.clear()
    assert spans() == [] and profiling.dropped == 0


def _one_span():
    with span("planner.command"):
        pass


def test_parents_per_thread(monkeypatch):
    """A span opened in another thread is a root there, not a child of the
    span open in this one. (torch.profiler's flag is per thread: a thread
    that does not inherit the profiler's state records nothing, so the flag
    is forced on here.)"""
    monkeypatch.setattr(profiling, "_profiling", lambda: True)
    profiling.clear()
    with span("loop.step"):
        t = threading.Thread(target=_one_span)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        with span("world.step"):
            pass
    names = [r.name for r in spans()]
    by = {r.name: r for r in spans()}
    assert by["planner.command"].parent == -1
    assert by["planner.command"].root == names.index("planner.command")
    assert by["world.step"].parent == by["world.step"].root == names.index("loop.step")
    profiling.clear()


def test_device_time_leaves_out_annotations():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, start, end, device=cuda, annotation=False):
        return SimpleNamespace(name=name, device_type=device, is_user_annotation=annotation,
                               time_range=SimpleNamespace(start=start, end=end))

    events = [ev("fused_rollout_kernel", 0, 3000), ev("k1.launch", 0, 3000, annotation=True),
              ev("memcpy", 3000, 3500), ev("fused_rollout_kernel", 4000, 7000),
              ev("k1.launch", 0, 9000, device=cpu, annotation=True)]
    busy, kernels = device_time(events)
    assert busy == pytest.approx(0.0065)
    assert list(kernels) == ["fused_rollout_kernel", "memcpy"]
    assert kernels["fused_rollout_kernel"] == (2, pytest.approx(0.006))
