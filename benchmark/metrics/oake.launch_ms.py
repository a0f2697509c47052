"""Main-thread milliseconds a dispatch spent queueing the encoder's kernels
(``step.launch``, ``oadp_torch/oake/encoders.py:objects_packed_step`` after
staging; program spans)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.ms_per_dispatch(ctx, 'step.launch')
