"""draws_ahead_pct (chunked cells): the share of the profiled episode's
`chunk.draws` spans whose draws were made ahead, during the previous chunk's
replays (the span's `ahead` attribute 1), in %. An episode's first chunk
draws on the spot, so 200 steps in chunks of 16 read 12 of 13.

None without a trace, without a `chunk.draws` span, or where the program's
`chunk.draws` spans carry no `ahead` attribute (a program that draws every
chunk on the spot)."""
from cellbench.metrics.command_host_ms import records


def read(ctx):
    draws = [r for r in records(ctx) or () if r.name == "chunk.draws" and r.end_ns]
    if not draws or any("ahead" not in r.attrs for r in draws):
        return None
    return 100.0 * sum(int(r.attrs["ahead"]) for r in draws) / len(draws)
