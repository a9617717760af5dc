"""chunk_host_ms (chunked cells): the host's time in the profiled episode's
chunks outside the graph's replays and the one fetch, in ms a control step
(`command_host_ms.records`).

Over the program's `loop.chunk` spans: each chunk's duration less its
`chunk.replay` and `chunk.fetch` spans (the enqueue of the k replays; the
copy that waits for the device), summed, over the chunks' steps. What is
left is the chunk's draws, copies in, clones, unpack and rebroadcast, and
the loop's per-step bookkeeping."""
from cellbench.metrics.command_host_ms import records

OUTSIDE = ("chunk.replay", "chunk.fetch")


def host_ms(recs):
    """The chunks' host time outside OUTSIDE over their steps, in ms; None
    without a closed chunk."""
    chunks = {i: r for i, r in enumerate(recs or ()) if r.name == "loop.chunk" and r.end_ns}
    if not chunks:
        return None
    ns = sum(r.end_ns - r.start_ns for r in chunks.values())
    ns -= sum(r.end_ns - r.start_ns for r in recs if r.name in OUTSIDE and r.root in chunks)
    return ns / 1e6 / sum(int(r.attrs["steps"]) for r in chunks.values())


def read(ctx):
    return host_ms(records(ctx))
