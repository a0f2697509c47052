"""Main-thread milliseconds a dispatch spent blocked on the saver's full
queue (``runner.wait_saver``, ``oadp_torch/oake/base.py:run_split``'s
``enqueue_save``; program spans)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.ms_per_dispatch(ctx, 'runner.wait_saver')
