"""world_host_ms (per-step cells): the world step on the host, the mean
over the profiled episode's `world.step` spans (`Simulation.stepped`), in
ms: K2's packing and launch, the unpack of its rows and the body-cache
refresh, enqueued, with no synchronise (`command_host_ms.records`)."""
from cellbench.metrics.command_host_ms import mean_ms, records


def read(ctx):
    return mean_ms(records(ctx), "world.step")
