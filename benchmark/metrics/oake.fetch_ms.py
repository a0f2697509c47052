"""Main-thread milliseconds a dispatch spent waiting for the previous
dispatch and copying its embeddings back (``runner.fetch``, the
``finalize`` calls of ``oadp_torch/oake/base.py:run_split``; program
spans)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.ms_per_dispatch(ctx, 'runner.fetch')
