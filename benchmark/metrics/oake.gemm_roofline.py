"""The bound of every matrix product of the traced split's dispatches
(patch product, each layer's QKV, out-projection, fc and proj on both
streams, the final projection: ``work.surgery_products``) over the device
time of the kernels classed as products (``ln_gemm``'s and the library's)."""

from benchmark.metrics import kernel_parts, work


def read(ctx):
    if ctx.trace is None or not ctx.counts.get('dispatches'):
        return None
    spent = ctx.trace.kernel_s(float('-inf'), float('inf'),
                               lambda n: kernel_parts.part(n) in kernel_parts.PRODUCTS)
    if spent <= 0:
        return None
    n, rows = ctx.counts['dispatches'], ctx.counts['dispatch_rows']
    bound = n * work.bound_s(work.surgery_products(work.Vit.surgery(ctx.config), rows / n))
    return 100.0 * bound / spent
