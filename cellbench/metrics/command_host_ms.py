"""command_host_ms (per-step cells): the planner's command on the host, the
mean over the profiled episode's `planner.command` spans, in ms: the host's
enqueue of the broadcast, the draw, the noise, K1's packing and launch and
the update, with no synchronise.

The program's spans (`mppiisaac_tpu_torch.utils.profiling.spans`) are
recorded only while torch.profiler records, so in a traced run they are the
profiled episode's. None without a trace, or where the program records no
such span."""


def records(ctx):
    """The program's span records of a traced run; None without a trace
    or in a program without spans."""
    if ctx.get("trace") is None:
        return None
    try:
        from mppiisaac_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    return spans()


def mean_ms(recs, name):
    """The mean duration of the closed spans named `name`, in ms; None
    without one."""
    ns = [r.end_ns - r.start_ns for r in recs or () if r.name == name and r.end_ns]
    return sum(ns) / len(ns) / 1e6 if ns else None


def read(ctx):
    return mean_ms(records(ctx), "planner.command")
