"""The bound of the main and side attention of the traced split's
dispatches (``work.surgery_attention``) over the device time of the
attention kernels."""

from benchmark.metrics import kernel_parts, work


def read(ctx):
    if ctx.trace is None or not ctx.counts.get('dispatches'):
        return None
    spent = ctx.trace.kernel_s(float('-inf'), float('inf'),
                               lambda n: kernel_parts.part(n) in kernel_parts.ATTENTION)
    if spent <= 0:
        return None
    n, rows = ctx.counts['dispatches'], ctx.counts['dispatch_rows']
    bound = n * work.bound_s(work.surgery_attention(work.Vit.surgery(ctx.config), rows / n))
    return 100.0 * bound / spent
