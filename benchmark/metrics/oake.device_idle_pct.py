"""Share of the window in which no operation ran on the device (trace)."""


def read(ctx):
    if ctx.trace is None:
        return None
    lo, hi = ctx.outcome.window
    return 100.0 * (1.0 - ctx.trace.busy_s(lo, hi) / (hi - lo))
