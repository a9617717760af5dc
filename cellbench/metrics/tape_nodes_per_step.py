"""tape_nodes_per_step: the nodes that the solver's tape prior adds to the
CUDA graph that `DeviceChunk` captures for one control step
(`DeviceChunk.nodes["tape"]`, counted while the step is captured: 0 without a
prior). A program whose `nodes` has no "tape" key gives nothing to read."""


def read(ctx):
    nodes = ctx.get("graph_nodes")
    if not nodes or "tape" not in nodes:
        return None
    return float(nodes["tape"])
