"""command_ms (per-step cells): the benchmark's span around the planner's command
in the per-step loop, ended by a synchronise; the mean over the profiled
episode's steps, in ms."""


def read(ctx):
    spans = ctx.get("spans", {}).get("command")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
