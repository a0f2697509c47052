"""What the readers of the program's own spans share: the spans that the
port's recorder (``oadp_torch/utils/tracing.py``) kept in the traced run,
those begun in the window, summed over the window's dispatches (its
``step.launch`` spans, one an objects dispatch). A run without a trace,
or a program without the recorder, gives None."""


def in_window(ctx) -> list | None:
    if ctx.trace is None:
        return None
    try:
        from oadp_torch.utils.tracing import spans
    except ImportError:  # a program that records no spans of its own
        return None
    lo, hi = ctx.outcome.window
    return [s for s in spans() if lo <= s.t0 < hi]


def ms_per_dispatch(ctx, name: str, count: str | None = None) -> float | None:
    """Milliseconds a dispatch of the ``name`` spans begun in the window;
    with ``count``, of that counter's microseconds over them instead."""
    got = in_window(ctx)
    dispatches = sum(s.name == 'step.launch' for s in got or ())
    if not dispatches:
        return None
    of = [s for s in got if s.name == name]
    if count is None:
        return 1e3 * sum(s.t1 - s.t0 for s in of) / dispatches
    counted = [s.counts[count] for s in of if s.counts and count in s.counts]
    if not counted:
        return None
    return 1e-3 * sum(counted) / dispatches
