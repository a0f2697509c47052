"""Share of the window's attention launches that took the route past 256
tokens: the ``attn_long_launches`` over the ``attn_launches`` that
``oadp_torch/oake/encoders.py`` counts on each ``step.launch`` span
(program counter). None where the launch spans count neither, as in a
program with one attention route."""

from benchmark import program_spans


def read(ctx):
    counts = [s.counts for s in program_spans.in_window(ctx) or ()
              if s.name == 'step.launch' and s.counts and 'attn_launches' in s.counts]
    launches = sum(c['attn_launches'] for c in counts)
    if not launches:
        return None
    return 100.0 * sum(c.get('attn_long_launches', 0) for c in counts) / launches
