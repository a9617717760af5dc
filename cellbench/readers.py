"""What the per-layer readers under `metrics/` share: each reads one number
from a traced run's context, or returns None where it finds nothing to read.

ctx: "trace" (profiling.Trace of the profiled episode), "spans" (the
benchmark's spans by name, seconds), "graph_nodes" (`DeviceChunk.nodes`),
"bounds" ({"k1"|"k2": [(least s, measured s)]} of the profiled launches
whose inputs the run kept).
"""

K1, K2 = "fused_rollout_kernel", "fused_world_step_kernel"


def idle_pct(ctx):
    """The share of the profiled window in which no operation ran on the
    device."""
    tr = ctx.get("trace")
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def kernel_ms(ctx, name):
    """A kernel's device time, the mean over its profiled launches, in ms."""
    tr = ctx.get("trace")
    ts = tr.kernel(name) if tr is not None else []
    if not ts:
        return None
    return 1e3 * sum(ts) / len(ts)


def roofline_pct(ctx, key):
    """A kernel's least time over its measured time, summed over the
    profiled launches whose inputs the run kept. The least time is the
    larger of the frozen count's operations over the float32 peak and its
    bytes over the memory bandwidth (reference/count.py)."""
    pairs = ctx.get("bounds", {}).get(key)
    if not pairs:
        return None
    return 100.0 * sum(b for b, _ in pairs) / sum(t for _, t in pairs)
