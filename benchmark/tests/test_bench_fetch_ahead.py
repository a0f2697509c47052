"""``oake.fetch_ahead_pct`` on hand-made spans in and around a window: the
share of the window's ``runner.fetch`` spans that left the next dispatch
queued, and None without a trace, without the recorder, or where the fetch
spans count nothing (a program whose fetch drains the card's queue)."""

import sys

import pytest

from benchmark import harness
from oadp_torch.utils import tracing
from oadp_torch.utils.tracing import Span

WINDOW = (10.0, 11.0)
MAIN = 'MainThread'


def _fetch(t0, fetches=1, ahead=1, counted=True):
    counts = dict(fetches=fetches, fetches_ahead=ahead) if counted else None
    return Span('runner.fetch', MAIN, t0, t0 + 0.1, 0.0, counts=counts)


def _spans():
    return [
        _fetch(9.9, ahead=0),  # begun before the window: left out
        _fetch(10.0), _fetch(10.2), _fetch(10.4, ahead=0), _fetch(10.6), _fetch(10.8),
        Span('step.stage', MAIN, 10.1, 10.2, 0.0, counts=dict(pin_alloc_us=0, pin_allocs=0)),
        Span('runner.write', 'saver', 10.3, 10.4, 0.0, key=3),
        _fetch(11.0, ahead=0),  # begun at the window's close: left out
    ]


def _ctx(trace=True):
    outcome = harness.Outcome(window=WINDOW, spans=harness.Spans(), counts={}, checks={},
                              attempted=0, failed=0, memory_peak_bytes=0,
                              trace=object() if trace else None)
    return harness.Ctx(spec=None, outcome=outcome)


def _read(ctx):
    return harness.load_module('metrics', 'oake.fetch_ahead_pct').read(ctx)


def test_share_of_the_windows_fetches_that_left_the_next_queued(monkeypatch):
    monkeypatch.setattr(tracing, 'spans', _spans)
    assert _read(_ctx()) == pytest.approx(80.0)


def test_none_without_a_trace_or_the_recorder(monkeypatch):
    monkeypatch.setattr(tracing, 'spans', _spans)
    assert _read(_ctx(trace=False)) is None
    monkeypatch.setitem(sys.modules, 'oadp_torch.utils.tracing', None)
    assert _read(_ctx()) is None


def test_none_where_the_fetches_count_nothing(monkeypatch):
    """Fetch spans without the counters, as the program's before the copy
    back was queued behind each dispatch, or none in the window."""
    monkeypatch.setattr(tracing, 'spans', lambda: [_fetch(10.1 + 0.2 * i, counted=False)
                                                   for i in range(4)])
    assert _read(_ctx()) is None
    monkeypatch.setattr(tracing, 'spans', lambda: [_fetch(9.0), _fetch(12.0)])
    assert _read(_ctx()) is None
