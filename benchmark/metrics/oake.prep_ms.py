"""Host milliseconds an image on the producer thread: its JPEG decode
(``CocoImageSet.load``) and ``ObjectsPipeline.prepare`` (boxes, grid masks,
packing), over the images begun in the window (benchmark spans)."""

import statistics


def read(ctx):
    lo, hi = ctx.outcome.window
    decode = ctx.spans.starting_in('oake.decode', lo, hi)
    prepare = ctx.spans.starting_in('oake.prepare', lo, hi)
    if not decode or not prepare:
        return None
    return 1e3 * (statistics.fmean(decode) + statistics.fmean(prepare))
