"""Host milliseconds an image to fetch its record from the device
(``ObjectsPipeline.finalize``, on the main thread) and write it
(``save_pth``, on the saver thread), over the images begun in the window
(benchmark spans)."""

import statistics


def read(ctx):
    lo, hi = ctx.outcome.window
    fetch = ctx.spans.starting_in('oake.fetch', lo, hi)
    save = ctx.spans.starting_in('oake.save', lo, hi)
    if not fetch or not save:
        return None
    return 1e3 * (statistics.fmean(fetch) + statistics.fmean(save))
