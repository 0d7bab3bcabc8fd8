"""The share of the traced window in which no kernel, copy or memset ran
on the card (the profiler's device trace)."""

from portbench import devtrace


def read(ctx, name):
    if ctx.trace is None or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - devtrace.busy_s(ctx.trace) / ctx.trace.window_s)
