"""Device milliseconds of one objects dispatch: the kernel time of the
traced split (every dispatch of it, so none is cut at an edge) divided by
its dispatches."""


def read(ctx):
    if ctx.trace is None or not ctx.counts.get('dispatches'):
        return None
    return 1e3 * ctx.trace.kernel_s(float('-inf'), float('inf')) / ctx.counts['dispatches']
