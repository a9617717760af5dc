"""The profiled part of a traced run, kept in memory.

After the port's `utils/profiling.trace` (torch.profiler with CPU and CUDA
activities; busy time = the summed time of the device's kernels and copies,
here without the marks the benchmark's own spans leave on the device's
timeline), writing no Chrome trace. `Trace` also keeps each kernel's
launches in order, and the breakdown the result line carries: the device
operations that took most time, and the idle gaps of the device named by
what the host was doing across them (the innermost host event, "python"
where none is open, under the benchmark's span where one is).
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

SPAN = "cellbench."        # the benchmark's own spans (torch.profiler.record_function)


@dataclass
class Trace:
    window_s: float = 0.0
    busy_s: float = 0.0
    kernels: Dict[str, Tuple[int, float]] = field(default_factory=dict)  # name → (calls, s)
    launches: Dict[str, List[float]] = field(default_factory=dict)       # name → s per launch
    device_ops: List[list] = field(default_factory=list)
    idle_gaps: List[list] = field(default_factory=list)

    def kernel(self, fragment: str) -> List[float]:
        """The launch times, in order, of the kernels whose name holds
        `fragment`."""
        out: List[float] = []
        for name, ts in self.launches.items():
            if fragment in name:
                out.extend(ts)
        return out


@contextlib.contextmanager
def traced(device: torch.device):
    """Profile the block on the card; yields a Trace, filled on exit. On the
    CPU (a rehearsal) nothing is profiled: the Trace stays empty, and the
    readers find nothing to read."""
    from torch.profiler import ProfilerActivity, profile

    res = Trace()
    if device.type != "cuda":
        yield res
        return
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield res
        torch.cuda.synchronize()
        res.window_s = time.perf_counter() - t0
    _fill(res, prof)


def _annotation(e) -> bool:
    """A span's mark on the device's timeline (record_function), not work."""
    return bool(getattr(e, "is_user_annotation", False)) or e.name.startswith(SPAN)


def _fill(res: Trace, prof):
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == cuda:
            if not _annotation(e):
                dev.append((tr.start, tr.end, e.name))
        else:
            host.append((tr.start, tr.end, e.name))
    dev.sort()
    launches = defaultdict(list)
    for s, t, name in dev:
        launches[name].append((t - s) / 1e6)
    res.launches = dict(launches)
    res.kernels = {k: (len(v), sum(v)) for k, v in
                   sorted(launches.items(), key=lambda kv: -sum(kv[1]))}
    res.busy_s = sum(s for _, s in res.kernels.values())
    res.device_ops = [[k, s] for k, (_, s) in list(res.kernels.items())[:10]]
    res.idle_gaps = _gaps(dev, host)


def _gaps(dev, host, top: int = 10):
    """The device's idle gaps, summed by what the host was doing across
    each (its innermost host event at the gap's middle, prefixed by the
    benchmark's innermost span there) → [[name, seconds]], largest first."""
    busy_to = None
    gaps = []
    for s, t, _ in dev:
        if busy_to is not None and s > busy_to:
            gaps.append((busy_to, s))
        busy_to = t if busy_to is None else max(busy_to, t)
    host.sort()
    by_name = defaultdict(float)
    active, j = [], 0
    for a, b in gaps:                      # in time order: one sweep over the host
        mid = 0.5 * (a + b)
        while j < len(host) and host[j][0] <= mid:
            active.append(host[j])
            j += 1
        active = [h for h in active if h[1] >= mid]
        inner = min((h for h in active if not h[2].startswith(SPAN)),
                    key=lambda h: h[1] - h[0], default=None)
        span = min((h for h in active if h[2].startswith(SPAN)),
                   key=lambda h: h[1] - h[0], default=None)
        label = inner[2] if inner else "python"
        if span:
            label = f"{span[2][len(SPAN):]}/{label}"
        by_name[label] += (b - a) / 1e6
    return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]
