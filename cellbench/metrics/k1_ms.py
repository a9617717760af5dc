"""k1_ms: the profiler's device time of K1, the mean over
its launches in the profiled episode, in ms."""
from cellbench.readers import K1, kernel_ms


def read(ctx):
    return kernel_ms(ctx, K1)
