"""k2_roofline_pct: K2's least time over its measured time
(readers.roofline_pct)."""
from cellbench.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "k2")
