"""The readers of the program's own spans (``program_spans.py`` and the six
metrics that use it) on hand-made spans in and around a window: the sums a
dispatch, the counter, and None without a trace or without the recorder."""

import sys

import pytest

from benchmark import harness
from oadp_torch.utils import tracing
from oadp_torch.utils.tracing import Span

# the window is [10, 11) s; three dispatches begin in it
WINDOW = (10.0, 11.0)
MAIN = 'MainThread'


def _spans():
    s = lambda name, t0, t1, thread=MAIN, **kw: Span(name, thread, t0, t1, 0.0, **kw)  # noqa: E731
    stage = lambda t0, us, n: s('step.stage', t0, t0 + 0.004, counts=dict(  # noqa: E731
        pin_alloc_us=us, pin_allocs=n))
    return [
        # a dispatch before the window: left out, though it ends inside
        stage(9.90, 5000, 1), s('step.launch', 9.95, 9.96), s('runner.fetch', 9.96, 10.05),
        # three dispatches begun in the window
        s('runner.wait_prepared', 10.00, 10.01), s('runner.wait_prepared', 10.02, 10.03),
        stage(10.03, 0, 0), s('step.launch', 10.04, 10.05), s('runner.fetch', 10.05, 10.25),
        s('runner.wait_saver', 10.25, 10.26),
        stage(10.30, 3000, 2), s('step.launch', 10.31, 10.32), s('runner.fetch', 10.32, 10.52),
        stage(10.60, 0, 0), s('step.launch', 10.61, 10.63), s('runner.fetch', 10.63, 10.83),
        s('runner.wait_saver', 10.83, 10.86),
        # other threads' spans count for none of the six
        s('runner.prepare', 10.10, 10.12, 'producer', key=3),
        s('runner.write', 10.30, 10.35, 'saver', key=3),
        # a dispatch begun at the window's close: left out
        stage(11.00, 7000, 1), s('step.launch', 11.01, 11.02), s('runner.fetch', 11.02, 11.2),
    ]


def _ctx(trace=True):
    outcome = harness.Outcome(window=WINDOW, spans=harness.Spans(), counts={}, checks={},
                              attempted=0, failed=0, memory_peak_bytes=0,
                              trace=object() if trace else None)
    return harness.Ctx(spec=None, outcome=outcome)


def _read(name, ctx):
    return harness.load_module('metrics', name).read(ctx)


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(tracing, 'spans', _spans)


EXPECTED = {  # ms a dispatch, over the three dispatches of the window
    'oake.wait_prepared_ms': 20 / 3,
    'oake.wait_saver_ms': 40 / 3,
    'oake.fetch_ms': 200.0,
    'oake.stage_ms': 4.0,
    'oake.launch_ms': 40 / 3,
    'oake.pin_alloc_ms': 1.0,
}


@pytest.mark.parametrize('name', sorted(EXPECTED))
def test_reader_sums_a_dispatch_in_the_window(recorded, name):
    assert _read(name, _ctx()) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize('name', sorted(EXPECTED))
def test_reader_gives_none_without_a_trace(recorded, name):
    assert _read(name, _ctx(trace=False)) is None


@pytest.mark.parametrize('name', sorted(EXPECTED))
def test_reader_gives_none_without_the_recorder(monkeypatch, name):
    """A program without ``oadp_torch.utils.tracing``, as before it was
    added: the reader finds nothing and does not raise."""
    monkeypatch.setitem(sys.modules, 'oadp_torch.utils.tracing', None)
    assert _read(name, _ctx()) is None


def test_no_dispatch_or_no_counter_gives_none(monkeypatch):
    ctx = _ctx()
    monkeypatch.setattr(tracing, 'spans', lambda: [
        Span('runner.wait_prepared', MAIN, 10.1, 10.2, 0.0)])
    assert _read('oake.wait_prepared_ms', ctx) is None
    # the CPU, or a torch that counts no pinned blocks: no counter on the stage spans
    monkeypatch.setattr(tracing, 'spans', lambda: [
        Span('step.stage', MAIN, 10.1, 10.2, 0.0), Span('step.launch', MAIN, 10.2, 10.3, 0.0)])
    assert _read('oake.pin_alloc_ms', ctx) is None
    assert _read('oake.stage_ms', ctx) == pytest.approx(100.0)
    assert _read('oake.wait_saver_ms', ctx) == 0.0


def test_main_thread_phases_sum_to_the_dispatch_period(recorded):
    """On spans that tile the main thread, the five main-thread readers sum
    to the window over its dispatches, less the untraced gaps."""
    main = sorted(EXPECTED.keys() - {'oake.pin_alloc_ms'})
    total = sum(_read(name, _ctx()) for name in main)
    spanned = sum(s.t1 - s.t0 for s in _spans() if s.thread == MAIN and WINDOW[0] <= s.t0 < 11)
    assert total == pytest.approx(1e3 * spanned / 3)
