"""Main-thread milliseconds a dispatch spent stacking, pinning and queueing
the copy of its inputs to the device (``step.stage``,
``oadp_torch/oake/encoders.py:OakeSteps._to_device``; program spans)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.ms_per_dispatch(ctx, 'step.stage')
