"""psi_solved_pct (pick and anymal chunked): the share of the Ψ columns that
the actors' Ψ slots hold which K1 solved, in %, over the profiled
episode's `chunk.fetch` spans: 100 × Σ psi_solved / Σ psi_held. K1 solves
Ψ only for the contact links whose broadphase gate let a block through
(`csrc/impulse.cuh` psi_blocks); each span carries the columns of its
chunk's replays, read from the kernel's counters while spans record.

None without a trace, where the program's `chunk.fetch` spans carry no such
attributes (a program that solves every column), or where no column is
held."""
from cellbench.metrics.command_host_ms import records


def read(ctx):
    fetches = [r for r in records(ctx) or () if r.name == "chunk.fetch" and r.end_ns]
    if not fetches or any("psi_held" not in r.attrs for r in fetches):
        return None
    held = sum(int(r.attrs["psi_held"]) for r in fetches)
    if held <= 0:
        return None
    return 100.0 * sum(int(r.attrs["psi_solved"]) for r in fetches) / held
