"""Share of the window's ``runner.fetch`` spans after which the next
dispatch's copy back had not yet arrived, so that the card still had work
queued when the fetch returned: the ``fetches_ahead`` over the ``fetches``
that ``oadp_torch/oake/base.py:run_split``'s fetch counts (program counter).
None where the fetch spans count neither, as in a program whose fetch
drains the card's queue."""

from benchmark import program_spans


def read(ctx):
    counts = [s.counts for s in program_spans.in_window(ctx) or ()
              if s.name == 'runner.fetch' and s.counts and 'fetches' in s.counts]
    fetches = sum(c['fetches'] for c in counts)
    if not fetches:
        return None
    return 100.0 * sum(c.get('fetches_ahead', 0) for c in counts) / fetches
