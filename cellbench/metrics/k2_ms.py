"""k2_ms: the profiler's device time of K2, the mean over
its launches in the profiled episode, in ms."""
from cellbench.readers import K2, kernel_ms


def read(ctx):
    return kernel_ms(ctx, K2)
