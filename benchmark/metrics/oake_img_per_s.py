"""Images whose OAKE record the port's pipeline wrote in the window,
divided by the whole window (host clock)."""


def read(ctx):
    return ctx.counts['records_in_window'] / ctx.window_s
