"""graph_nodes_per_step: the nodes of the CUDA graph that `DeviceChunk`
captures for one control step (`DeviceChunk.nodes["total"]`)."""


def read(ctx):
    nodes = ctx.get("graph_nodes")
    if not nodes:
        return None
    return float(nodes["total"])
