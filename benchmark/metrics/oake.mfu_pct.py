"""Model operations of the crops whose records were written in the window
(the proposals of each image, not the padded rows), over the window times
the card's bf16 peak."""

from benchmark.metrics import peaks, work


def read(ctx):
    if not ctx.counts.get('crops_in_window'):
        return None
    flops = ctx.counts['crops_in_window'] * work.surgery_crop_flops(work.Vit.surgery(ctx.config))
    return 100.0 * flops / (ctx.window_s * peaks.BF16_FLOPS)
