"""Milliseconds a dispatch that CUDA's host pool spent creating page-locked
blocks while its inputs were staged (the change of
``torch.cuda.host_memory_stats()``'s ``host_alloc_time.total`` over the
``step.stage`` spans, counted by ``oadp_torch/oake/encoders.py:_pin_counts``;
program counter)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.ms_per_dispatch(ctx, 'step.stage', count='pin_alloc_us')
