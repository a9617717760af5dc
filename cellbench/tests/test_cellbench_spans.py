"""The readers of the program's spans (`metrics/chunk_host_ms.py`,
`command_host_ms.py`, `world_host_ms.py`) on synthetic span records: each
gives the exact ms its docstring defines, and None without a trace or
without a matching record."""
from types import SimpleNamespace

import pytest

from cellbench import spec
from cellbench.profiling import Trace

MS = 1_000_000          # ns


def rec(name, start, end, parent=-1, root=-1, **attrs):
    return SimpleNamespace(name=name, start_ns=start * MS, end_ns=end * MS, parent=parent,
                           root=root, attrs=attrs)


def chunk(at, steps, replay, fetch, root):
    """A chunk of `steps` at `at` ms: draws 1 ms, load 1 ms, then the
    replays and the fetch (ms), then 2 ms of clones and unpack."""
    r, f = at + 2 + replay, at + 2 + replay + fetch
    return [rec("loop.chunk", at, f + 2, steps=steps, root=root),
            rec("chunk.draws", at, at + 1, root, root),
            rec("chunk.load", at + 1, at + 2, root, root),
            rec("chunk.replay", at + 2, r, root, root),
            rec("chunk.fetch", r, f, root, root),
            rec("chunk.unpack", f, f + 2, root, root)]


def reader(workload, metric):
    cell = spec.load_cell(workload)
    return cell.reader(next(m for m in cell.per_layer if m.name == metric))


@pytest.fixture
def recorded(monkeypatch):
    """Sets the program's span records the readers find."""
    from mppiisaac_tpu_torch.utils import profiling

    def put(recs):
        monkeypatch.setattr(profiling, "spans", lambda: list(recs))

    return put


@pytest.mark.parametrize("workload, metric", [("panda_pick.chunked", "chunk_host_ms"),
                                              ("panda_reach.chunked", "chunk_host_ms.host_bound")])
def test_chunk_host_ms(recorded, workload, metric):
    # 16 steps: 48 ms of which replay 20 and fetch 24; 4 steps whose fetch
    # covers most of the chunk: 100 ms, replay 1, fetch 95
    recs = chunk(0, 16, 20, 24, 0)
    recs += chunk(60, 4, 1, 95, len(recs))
    recorded(recs)
    # host: (48 − 44) + (100 − 96) = 8 ms over 20 steps
    assert reader(workload, metric)({"trace": Trace()}) == pytest.approx(0.4)


@pytest.mark.parametrize("workload", ["panda_pick.per_step", "panda_reach.per_step"])
def test_command_and_world_host_ms(recorded, workload):
    recs = []
    for at, cmd, world in ((0, 3, 5), (20, 5, 2)):
        root = len(recs)
        recs += [rec("loop.step", at, at + 15, root=root),
                 rec("planner.command", at, at + cmd, root, root),
                 rec("planner.broadcast", at, at + 1, root + 1, root),
                 rec("world.step", at + 8, at + 8 + world, root, root),
                 rec("world.refresh", at + 9, at + 8 + world, root + 3, root)]
    recorded(recs)
    ctx = {"trace": Trace()}
    assert reader(workload, "command_host_ms.per_step")(ctx) == pytest.approx(4.0)
    assert reader(workload, "world_host_ms.per_step")(ctx) == pytest.approx(3.5)


@pytest.mark.parametrize("workload, metric", [
    ("panda_pick.chunked", "chunk_host_ms"), ("panda_reach.chunked", "chunk_host_ms.host_bound"),
    ("panda_pick.per_step", "command_host_ms.per_step"),
    ("panda_reach.per_step", "world_host_ms.per_step")])
def test_none_without_records(recorded, workload, metric):
    read = reader(workload, metric)
    recorded([])
    assert read({"trace": Trace()}) is None
    # records, but none this metric reads
    recorded([rec("loop.readback", 0, 1, root=0)])
    assert read({"trace": Trace()}) is None
    # no trace: nothing was profiled, whatever the list holds
    recorded(chunk(0, 16, 20, 24, 0) + [rec("planner.command", 0, 1, root=6),
                                        rec("world.step", 1, 2, root=7)])
    assert read({}) is None and read({"trace": None}) is None
