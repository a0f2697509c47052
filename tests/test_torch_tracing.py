"""The span recorder (``oadp_torch/utils/tracing.py``) and the spans of the
OAKE runner's three threads, on the CPU: nothing recorded outside a
profiler session, every thread recorded inside one, the ring's bound, the
main thread's spans in the profiler's own trace on its clock, one set of
spans a dispatch and an image through ``ObjectsPipeline.run_split``, and
``profile=`` writing the producer's and the saver's spans into its trace."""

import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from oadp_torch.utils import Config, load_pth, tracing

torch.set_num_threads(1)

VIT = dict(width=64, layers=2, heads=2, output_dim=32)
MAIN = {'runner.wait_prepared', 'runner.fetch', 'runner.wait_saver', 'step.stage',
        'step.launch'}


@pytest.fixture(autouse=True)
def empty_ring():
    tracing.clear()
    yield
    tracing.clear()


def _session():
    return profile(activities=[ProfilerActivity.CPU])


def _busy(seconds):
    """Spin until this thread has had ``seconds`` of CPU time."""
    t = time.thread_time()
    while time.thread_time() - t < seconds:
        pass


def _recording():
    return torch.autograd.profiler._is_profiler_enabled


def test_outside_a_session_nothing_is_recorded():
    assert not _recording()
    with tracing.span('t.value', key=3) as s:
        s.key = 4  # as a body that learns its request sets it
        value = 7
    assert value == 7
    with pytest.raises(KeyError, match='inside'):
        with tracing.span('t.raises'):
            raise KeyError('inside')
    with tracing.serving(5, (1, 2)):
        with tracing.span('t.served'):
            pass
    assert tracing.spans() == []


def test_a_session_records_every_thread():
    def worker():
        with tracing.span('t.worker', key=11):
            _busy(0.01)
        with tracing.span('t.sleep', key=12):
            time.sleep(0.05)

    with _session():
        assert _recording()
        with tracing.span('t.main') as s:
            s.key = 10  # known only inside the body
            _busy(0.01)
        thread = threading.Thread(target=worker, name='worker')
        thread.start()
        thread.join(timeout=30)
        assert not thread.is_alive()
    assert not _recording()
    got = {s.name: s for s in tracing.spans()}
    assert set(got) == {'t.main', 't.worker', 't.sleep'}
    assert got['t.main'].thread == threading.main_thread().name
    assert (got['t.main'].key, got['t.worker'].thread, got['t.worker'].key) == (10, 'worker', 11)
    for name in ('t.main', 't.worker'):
        s = got[name]
        assert 0.01 <= s.cpu_s <= s.t1 - s.t0 + 1e-3
    sleep = got['t.sleep']
    assert sleep.t1 - sleep.t0 >= 0.05 and sleep.cpu_s < 0.5 * (sleep.t1 - sleep.t0)


def test_serving_keys_and_counters():
    values = iter([dict(allocs=2, us=40), dict(allocs=5, us=100)])
    with _session():
        with tracing.serving(4, (21, 22)):
            with tracing.span('t.stage', counters=lambda: next(values)):
                pass
            with tracing.span('t.own', key=9):
                pass
        with tracing.span('t.after'):
            pass
    got = {s.name: s for s in tracing.spans()}
    assert (got['t.stage'].key, got['t.stage'].ids) == (4, (21, 22))
    assert got['t.stage'].counts == dict(allocs=3, us=60)
    assert (got['t.own'].key, got['t.own'].ids, got['t.own'].counts) == (9, (21, 22), None)
    assert (got['t.after'].key, got['t.after'].ids) == (None, ())


def test_the_ring_keeps_at_most_its_bound():
    assert tracing.RING == 2 ** 16

    def worker():  # off the main thread: no profiler range a span
        for i in range(tracing.RING + 5):
            with tracing.span('t.many', key=i):
                pass

    with _session():
        thread = threading.Thread(target=worker, name='worker')
        thread.start()
        thread.join(timeout=120)
        assert not thread.is_alive()
    got = tracing.spans()
    assert len(got) == tracing.RING
    assert (got[0].key, got[-1].key) == (5, tracing.RING + 4)


def test_main_thread_span_is_in_the_profilers_trace_on_its_clock(tmp_path):
    with _session() as prof:
        mark = tracing.clock()
        time.sleep(0.01)
        with tracing.span('t.phase'):
            torch.ones(64, 64).sum()
    prof.export_chrome_trace(str(tmp_path / 'trace.json'))
    events = json.loads((tmp_path / 'trace.json').read_text())['traceEvents']
    marks = [e for e in events if e.get('name') == tracing.CLOCK]
    ranges = [e for e in events if e.get('name') == 't.phase']
    assert len(marks) == 1 and len(ranges) == 1
    # a host op of the launching thread, as the benchmark's Trace.host reads it
    assert ranges[0]['cat'] == 'cpu_op' and ranges[0]['tid'] == marks[0]['tid']
    (s,) = tracing.spans()
    t0 = mark + (ranges[0]['ts'] - marks[0]['ts']) * 1e-6
    assert abs(t0 - s.t0) < 1e-3
    assert abs(ranges[0]['dur'] * 1e-6 - (s.t1 - s.t0)) < 1e-3


# ---------------------------------------------------------------------------
# The OAKE runner
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def data(tmp_path_factory):
    from tests.synthetic_data import make_synthetic_coco

    return make_synthetic_coco(tmp_path_factory.mktemp('tracing_oake'), n_images=5,
                               n_proposals=12)


def _pipeline(data, **extra):
    from oadp_torch.oake.objects import ObjectsPipeline

    config = Config.merge(Config(), dict(
        model=dict(checkpoint=None, dtype='float32', max_image_size=320, vit=VIT, device='cpu'),
        batch_size=2, mini_batch_size=16, log=dict(interval=10 ** 6), **extra))
    return ObjectsPipeline('tracing', config)


def _run_split(pipeline, data, out):
    pipeline.run_split(Config.merge(Config(), dict(dataloader=dict(dataset=dict(
        root=data['root'], annFile=data['ann_file'],
        proposal_file=data['proposal_file'], proposal_sorted=True, output_dir=str(out))))))
    return {p.name: load_pth(p) for p in sorted(out.glob('*.pth'))}


def _same_records(got, want):
    assert sorted(got) == sorted(want) and len(want) == 5
    for name, record in want.items():
        assert sorted(got[name]) == sorted(record)
        for key, value in record.items():
            a, b = np.asarray(got[name][key]), np.asarray(value)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), (name, key)


def test_objects_run_split_spans_a_dispatch_and_an_image(data, tmp_path):
    pipeline = _pipeline(data)
    plain = _run_split(pipeline, data, tmp_path / 'plain')
    assert tracing.spans() == []  # no session: nothing through a whole split
    with _session():
        traced = _run_split(pipeline, data, tmp_path / 'traced')
    _same_records(traced, plain)

    got = tracing.spans()
    by = {}
    for s in got:
        by.setdefault(s.name, []).append(s)
    ids = sorted(data['ids'])
    dispatches = list(range(3))  # 5 images, 2 a dispatch
    for name in ('step.stage', 'step.launch', 'runner.fetch'):
        assert sorted(s.key for s in by[name]) == dispatches, name
    # a dispatch's image ids, taken by size as the producer takes them
    assert sorted(i for s in by['step.stage'] for i in s.ids) == ids
    assert all(len(s.ids) == 2 for s in by['step.stage'][:2])
    # one wait an image, and the wait for the end of the split
    waits = [s.key for s in by['runner.wait_prepared']]
    assert sorted(k for k in waits if k is not None) == ids and waits[-1] is None
    for name in ('runner.decode', 'runner.prepare', 'runner.write'):
        assert sorted(s.key for s in by[name]) == ids, name
    assert {s.thread for s in by['runner.decode'] + by['runner.prepare']} == {'producer'}
    assert {s.thread for s in by['runner.write']} == {'saver'}
    main = sorted((s for s in got if s.name in MAIN), key=lambda s: s.t0)
    assert {s.thread for s in main} == {threading.main_thread().name}
    assert {s.name for s in main} == MAIN
    # the main thread's spans never nest nor overlap: each is the phase
    assert all(a.t1 <= b.t0 for a, b in zip(main, main[1:]))
    # each dispatch is staged, then launched, then fetched a dispatch later
    stage = {s.key: s for s in by['step.stage']}
    launch = {s.key: s for s in by['step.launch']}
    fetch = {s.key: s for s in by['runner.fetch']}
    for n in dispatches:
        assert stage[n].t1 <= launch[n].t0 <= launch[n].t1 <= fetch[n].t0
    assert stage[2].counts is None  # no pinned pool on the CPU


def test_profile_writes_one_trace_with_every_threads_spans(data, tmp_path):
    trace_dir = tmp_path / 'trace'
    pipeline = _pipeline(data, profile=str(trace_dir))
    profiled = _run_split(pipeline, data, tmp_path / 'profiled')
    plain = _run_split(_pipeline(data), data, tmp_path / 'plain')
    _same_records(profiled, plain)
    traces = list(trace_dir.glob('*.pt.trace.json'))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())['traceEvents']
    (session,) = [e for e in events if e.get('cat') == 'Trace' and e.get('ph') == 'X']
    ours = [e for e in events if e.get('pid') == tracing.PROCESS and e.get('ph') == 'X']
    rows = {e['tid'] for e in ours}
    assert {'producer', 'saver', threading.main_thread().name} <= rows
    names = {(e['tid'], e['name']) for e in ours}
    assert {('producer', 'runner.decode'), ('producer', 'runner.prepare'),
            ('saver', 'runner.write')} <= names
    lo, hi = session['ts'], session['ts'] + session['dur']
    assert all(lo <= e['ts'] and e['ts'] + e['dur'] <= hi for e in ours)
    assert all('cpu_ms' in e['args'] for e in ours)
    named = {e['tid'] for e in events if e.get('ph') == 'M' and e.get('pid') == tracing.PROCESS}
    assert named == rows
    # the main thread's spans are the profiler's ranges too, on the same clock
    (mark,) = [e for e in events if e.get('name') == tracing.CLOCK]
    ranges = sorted(e['ts'] for e in events
                    if e.get('cat') == 'cpu_op' and e.get('name') == 'step.launch')
    merged = sorted(e['ts'] for e in ours if e['name'] == 'step.launch')
    assert len(ranges) == len(merged) == 3
    assert max(abs(a - b) for a, b in zip(ranges, merged)) < 1e3  # us
    assert mark['ts'] <= merged[0]
