"""Phase timers, a profiler trace, and the node count of a CUDA graph
(parity with the JAX package's `utils/profiling.py`).

Usage:
    prof = PhaseProfiler()
    with prof.phase("sample"): ...
    with prof.phase("rollout"): ...
    print(prof.report())

    with trace("chiprun_out/trace") as t:     # open trace.json in Perfetto
        run_task(cfg, obj, n_steps=32, device_steps=16)
    print(t.idle_share)

`trace` runs `torch.profiler` with CPU and, where the device is a GPU, CUDA
activities, writes a Chrome trace, and gives the device's busy time and idle
share of the traced window.
"""
from __future__ import annotations

import contextlib
import ctypes
import os
import subprocess
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch


class PhaseProfiler:
    def __init__(self):
        self.times: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name].append(time.perf_counter() - t0)

    def report(self) -> str:
        import numpy as np

        lines = []
        for name, ts in self.times.items():
            a = np.asarray(ts) * 1e3
            lines.append(
                f"{name:>12}: n={len(a):4d}  mean {a.mean():8.2f} ms  "
                f"p50 {np.percentile(a, 50):8.2f}  p95 {np.percentile(a, 95):8.2f}"
            )
        return "\n".join(lines)

    def summary(self) -> dict:
        import numpy as np

        return {
            name: {"mean_ms": float(np.mean(ts) * 1e3), "n": len(ts)}
            for name, ts in self.times.items()
        }


@dataclass
class TraceResult:
    """Filled when the `trace` block ends. window_s: the block's wall time
    (ended by a device synchronise); device_busy_s: the summed self time of
    the device's kernels and copies (0 without a GPU); kernels: device
    (name → (calls, seconds)), largest first."""

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
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        res.device_busy_s = sum(e.self_device_time_total for e in events) / 1e6
        res.kernels = {e.key: (e.count, e.self_device_time_total / 1e6)
                       for e in sorted(events, key=lambda e: -e.self_device_time_total)}


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
