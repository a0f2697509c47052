"""Main-thread milliseconds a dispatch spent waiting for the producer's
next prepared image (``runner.wait_prepared``, the loop's ``queue.get`` in
``oadp_torch/oake/base.py:run_split``; program spans)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.ms_per_dispatch(ctx, 'runner.wait_prepared')
