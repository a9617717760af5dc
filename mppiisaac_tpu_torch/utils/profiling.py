"""The port's spans, a profiler trace, and the node counts of a CUDA graph.

Usage:
    with span("loop.chunk", steps=k): ...     # records only under torch.profiler

    with trace("chiprun_out/trace") as t:     # open trace.json in Perfetto
        run_task(cfg, obj, n_steps=32, device_steps=16)
    print(t.idle_share)
    print(spans())                           # the spans the traced block recorded

`span(name, **attrs)` marks one phase of the program. It records only while
`torch.profiler` records on the calling thread; otherwise it is one shared
no-op object behind one flag check (under 1 µs with its `with`: a bare
`record_function` costs about 10 µs even with the profiler off, so it is
never entered unguarded). A live span enters `record_function(name)`, which
puts it on the profiler's timeline beside the device's kernels, and appends
one `SpanRecord` to a bounded list in memory (`spans()`, `clear()`; past
SPAN_CAP records it drops them and counts them in `dropped`). The
benchmark's readers (`cellbench/metrics/*_host_ms.py`) read that list. A
span name never holds a kernel's name: the benchmark finds a kernel's
launches by a fragment of it.

`trace` runs `torch.profiler` with CPU and, where the device is a GPU, CUDA
activities, writes a Chrome trace, and gives the device's busy time and idle
share of the traced window.

`graph_nodes` counts a captured CUDA graph's nodes by type; a `tape_part()`
block adds the nodes it captures to a per-thread count that
`take_tape_nodes()` reads and resets (the solver's tape prior).
"""
from __future__ import annotations

import contextlib
import ctypes
import os
import subprocess
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

SPAN_CAP = 65536           # records kept in memory; later ones are dropped
_profiling = torch._C._autograd._profiler_enabled


@dataclass
class SpanRecord:
    """One span: start and end on `time.perf_counter_ns` (the host clock of
    the benchmark's timings; end 0 while open), `parent` the index in
    `spans()` of the span it opened in (-1 for a root), `root` the index of
    its root: the request, one control step or one chunk."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    root: int
    attrs: dict


_records: List[SpanRecord] = []
_lock = threading.Lock()
_open = threading.local()           # per thread: the stack of open spans' (index, root)
_paused = 0
dropped = 0                         # records past SPAN_CAP since the last clear()
_OFF = contextlib.nullcontext()      # the span when nothing records: shared


class _Span:
    __slots__ = ("_name", "_attrs", "_fn", "_rec")

    def __init__(self, name: str, attrs: dict):
        self._name, self._attrs = name, attrs

    def __enter__(self):
        global dropped
        self._fn = torch.profiler.record_function(self._name)
        self._fn.__enter__()
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        parent, root = stack[-1] if stack else (-1, -1)
        rec = SpanRecord(self._name, time.perf_counter_ns(), 0, parent, root, self._attrs)
        with _lock:
            if len(_records) < SPAN_CAP:
                i = len(_records)
                _records.append(rec)
            else:
                i, rec = -1, None
                dropped += 1
        if rec is not None and root < 0:
            rec.root = root = i
        self._rec = rec
        stack.append((i, root))
        return self

    def set(self, **attrs):
        """Add attributes to the open span's record."""
        if self._rec is not None:
            self._rec.attrs.update(attrs)

    def __exit__(self, *exc):
        if self._rec is not None:
            self._rec.end_ns = time.perf_counter_ns()
        _open.stack.pop()
        self._fn.__exit__(*exc)
        return False


def span(name: str, **attrs):
    """A context manager over one phase of the program, recorded only while
    torch.profiler records and no `paused()` block is open. It gives the
    open span (`set` adds attributes), or None where nothing records."""
    if _paused or not _profiling():
        return _OFF
    return _Span(name, attrs)


@contextlib.contextmanager
def paused():
    """No span records inside the block: a CUDA graph capture takes no
    span or annotation."""
    global _paused
    _paused += 1
    try:
        yield
    finally:
        _paused -= 1


def spans() -> List[SpanRecord]:
    """The spans recorded since the last `clear()`, in the order they
    opened."""
    with _lock:
        return list(_records)


def clear():
    """Forget the recorded spans and the dropped count (call it with no span
    open)."""
    global dropped
    with _lock:
        _records.clear()
        dropped = 0


@dataclass
class TraceResult:
    """Filled when the `trace` block ends. window_s: the block's wall time
    (ended by a device synchronise); device_busy_s: the summed time of the
    device's kernels and copies (0 without a GPU); kernels: device
    (name → (calls, seconds)), largest first. Neither counts the marks that
    spans leave on the device's timeline (`device_time`)."""

    path: str = ""
    window_s: float = 0.0
    device_busy_s: float = 0.0
    kernels: Dict[str, tuple] = field(default_factory=dict)

    @property
    def idle_share(self) -> Optional[float]:
        """1 − busy/window on the GPU; None where nothing ran on a device."""
        if self.window_s <= 0 or self.device_busy_s <= 0:
            return None
        return 1.0 - self.device_busy_s / self.window_s


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace.json"):
    """torch.profiler over the block (CPU activities, and CUDA ones where a
    GPU is present), its Chrome trace written to `log_dir/name`. Yields a
    TraceResult, filled on exit."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    res = TraceResult(path=os.path.join(log_dir, name))
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        yield res
        if cuda:
            torch.cuda.synchronize()
        res.window_s = time.perf_counter() - t0
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(res.path)
    if cuda:
        res.device_busy_s, res.kernels = device_time(prof.events())


def device_time(events):
    """The device's kernels and copies among torch.profiler events → (busy
    seconds, {name: (calls, seconds)} largest first). A `record_function`
    span leaves a mark on the device's timeline over the work it launched
    (a user annotation): that is no work, and is left out."""
    cuda = torch.autograd.DeviceType.CUDA
    by_name = defaultdict(lambda: [0, 0.0])
    for e in events:
        if e.device_type == cuda and not getattr(e, "is_user_annotation", False):
            k = by_name[e.name]
            k[0] += 1
            k[1] += (e.time_range.end - e.time_range.start) / 1e6
    kernels = {n: (c, t) for n, (c, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])}
    return sum(t for _, t in kernels.values()), kernels


def card() -> Dict[str, Optional[str]]:
    """The card a measurement ran on: {"device": torch's name of GPU 0,
    "power_limit": `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`'s first line, None where nvidia-smi fails}."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else None
    return {"device": torch.cuda.get_device_name(0), "power_limit": line}


# CUgraphNodeType of the CUDA driver API
_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset"}


def graph_nodes(raw_graph: int) -> Dict[str, int]:
    """The nodes of a captured CUDA graph (`CUDAGraph.raw_cuda_graph()`, a
    `cudaGraph_t`) by type, through the driver API: → {"kernel": n,
    "memcpy": n, "memset": n, "other": n, "total": n}."""
    drv = ctypes.CDLL("libcuda.so.1")
    drv.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_size_t)]
    drv.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    n = ctypes.c_size_t(0)
    rc = drv.cuGraphGetNodes(ctypes.c_void_p(raw_graph), None, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {rc}")
    nodes = (ctypes.c_void_p * n.value)()
    rc = drv.cuGraphGetNodes(ctypes.c_void_p(raw_graph), nodes, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {rc}")
    out = {"kernel": 0, "memcpy": 0, "memset": 0, "other": 0}
    for node in nodes:
        t = ctypes.c_int(-1)
        rc = drv.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t))
        if rc != 0:
            raise RuntimeError(f"cuGraphNodeGetType failed: CUresult {rc}")
        out[_NODE_TYPES.get(t.value, "other")] += 1
    out["total"] = n.value
    return out


_tape = threading.local()           # per thread: the tape prior's captured nodes since the last take


def _capturing() -> bool:
    """Whether the current CUDA stream captures a graph (False before CUDA
    is initialised, and so on a CPU-only build)."""
    return torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


def _capturing_graph_nodes() -> int:
    """The nodes captured so far into the graph that the current CUDA stream
    captures (`cuStreamGetCaptureInfo_v2` gives the graph; the capture is
    left as it is)."""
    drv = ctypes.CDLL("libcuda.so.1")
    info = drv.cuStreamGetCaptureInfo_v2      # stream, status, id, graph, deps, n deps
    info.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
                     ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p, ctypes.c_void_p]
    status, graph = ctypes.c_int(0), ctypes.c_void_p(0)
    rc = info(ctypes.c_void_p(torch.cuda.current_stream().cuda_stream), ctypes.byref(status),
              None, ctypes.byref(graph), None, None)
    if rc != 0:
        raise RuntimeError(f"cuStreamGetCaptureInfo_v2 failed: CUresult {rc}")
    return graph_nodes(graph.value)["total"]


class _TapePart:
    __slots__ = ("_n0",)

    def __enter__(self):
        self._n0 = _capturing_graph_nodes()
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            _tape.nodes = getattr(_tape, "nodes", 0) + _capturing_graph_nodes() - self._n0
        return False


def tape_part():
    """Around the solver's tape prior: while the current CUDA stream
    captures a graph, adds the nodes the block puts into it to this
    thread's count (`take_tape_nodes`); otherwise one shared no-op behind
    one check, so that it adds nothing to an eager step or to a replay."""
    if not _capturing():
        return _OFF
    return _TapePart()


def take_tape_nodes() -> int:
    """The tape nodes this thread captured since the last take; resets the
    count."""
    n = getattr(_tape, "nodes", 0)
    _tape.nodes = 0
    return n
