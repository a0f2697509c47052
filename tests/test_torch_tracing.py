"""The span recorder (``oadp_torch/utils/tracing.py``) and the spans of the
OAKE runner's three threads, on the CPU: nothing recorded outside a
profiler session, every thread recorded inside one, the ring's bound, the
main thread's spans in the profiler's own trace on its clock, one set of
spans a dispatch and an image through ``ObjectsPipeline.run_split``,
``profile=`` writing the producer's and the saver's spans into its trace,
and each dispatch's copy back (``oake/base.py:HostCopy``): a fetch waits
for its own dispatch only, and counts whether it left the next one queued
(on the card too, ``-m cuda``)."""

import importlib
import itertools
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


def _pipeline(data, task='objects', **extra):
    module = importlib.import_module(f'oadp_torch.oake.{task}')
    config = Config.merge(Config(), dict(
        model=dict(checkpoint=None, dtype='float32', max_image_size=320, vit=VIT, device='cpu'),
        batch_size=2, mini_batch_size=16, log=dict(interval=10 ** 6), **extra))
    return getattr(module, f'{task.capitalize()}Pipeline')('tracing', config)


def _run_split(pipeline, data, out):
    pipeline.run_split(Config.merge(Config(), dict(dataloader=dict(dataset=dict(
        root=data['root'], annFile=data['ann_file'],
        proposal_file=data['proposal_file'], proposal_sorted=True, output_dir=str(out))))))
    return {p.name: load_pth(p) for p in sorted(out.glob('*.pth'))}


def _same_records(got, want):
    assert sorted(got) == sorted(want) and len(want) == 5
    for name, record in want.items():
        if not isinstance(record, dict):  # a globals record is its embedding
            record, got[name] = dict(embeddings=record), dict(embeddings=got[name])
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


# ---------------------------------------------------------------------------
# The copy back: a fetch waits for its own dispatch only
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('task', ['objects', 'globals', 'blocks'])
def test_a_fetch_waits_for_its_own_dispatch_only(data, tmp_path, monkeypatch, task):
    """Each dispatch queues its copies back inside its own ``execute_batch``;
    ``finalize`` of dispatch n waits on dispatch n's copies and no other's,
    and on no stream- or device-wide synchronisation (a ``.cpu()`` of a card
    tensor is one); the records are byte-identical to a run without the
    recorders."""
    from oadp_torch.oake import base

    pipeline = _pipeline(data, task)
    plain = _run_split(pipeline, data, tmp_path / 'plain')

    at = dict(dispatch=None, fetching=None)  # what the main thread is inside
    made = {}  # HostCopy -> the dispatch whose execute_batch made it
    waits = []  # (dispatch fetched, dispatch of the copy waited on)
    finalized = []  # (dispatch fetched, waits in that finalize)
    syncs = []
    dispatch_of = {}  # id(record) -> its dispatch
    dispatches = itertools.count()
    init, wait = base.HostCopy.__init__, base.HostCopy.wait

    def recording_init(self, tensor):
        init(self, tensor)
        made[self] = at['dispatch']

    def recording_wait(self):
        waits.append((at['fetching'], made.get(self)))
        return wait(self)

    def recording_sync(name, fn):
        def recording(*args, **kwargs):
            if at['fetching'] is not None and threading.current_thread() is threading.main_thread():
                syncs.append(name)
            return fn(*args, **kwargs)
        return recording

    monkeypatch.setattr(base.HostCopy, '__init__', recording_init)
    monkeypatch.setattr(base.HostCopy, 'wait', recording_wait)
    for owner, name in ((torch.cuda, 'synchronize'), (torch.cuda.Stream, 'synchronize'),
                        (torch.Tensor, 'cpu'), (torch.Tensor, 'to')):
        monkeypatch.setattr(owner, name, recording_sync(f'{owner.__name__}.{name}',
                                                        getattr(owner, name)))
    execute, finalize = pipeline.execute_batch, pipeline.finalize

    def recording_execute(prepared):
        n = at['dispatch'] = next(dispatches)
        records = execute(prepared)
        at['dispatch'] = None
        dispatch_of.update((id(r), n) for r in records)
        return records

    def recording_finalize(record):
        n = at['fetching'] = dispatch_of[id(record)]
        before = len(waits)
        try:
            return finalize(record)
        finally:
            at['fetching'] = None
            finalized.append((n, len(waits) - before))

    pipeline.execute_batch, pipeline.finalize = recording_execute, recording_finalize
    recorded = _run_split(pipeline, data, tmp_path / 'recorded')

    _same_records(recorded, plain)
    assert next(dispatches) == 3  # 5 images, 2 a dispatch
    # every copy was queued inside an execute_batch, every dispatch queued its own
    assert sorted(set(made.values()), key=str) == [0, 1, 2]
    assert sorted(n for n, _ in finalized) == [0, 0, 1, 1, 2]
    assert all(k >= 1 for _, k in finalized), finalized
    assert all(fetching == own for fetching, own in waits), waits
    assert syncs == []


@pytest.mark.parametrize('arrived', [True, False], ids=['arrived', 'queued'])
def test_fetch_spans_count_fetches_that_left_the_next_dispatch_queued(
        data, tmp_path, monkeypatch, arrived):
    """Each ``runner.fetch`` span carries its ``fetches`` and ``fetches_ahead``
    deltas: one fetch, and one ahead where the next dispatch's copies had not
    arrived when it returned (the last fetch has no next dispatch). On the CPU
    a copy has always arrived; ``queued`` stands for a busy card."""
    from oadp_torch.oake import base

    if not arrived:
        monkeypatch.setattr(base.HostCopy, 'ready', lambda self: False)
    with _session():
        _run_split(_pipeline(data), data, tmp_path / 'out')
    fetches = sorted((s for s in tracing.spans() if s.name == 'runner.fetch'),
                     key=lambda s: s.key)
    assert [s.key for s in fetches] == [0, 1, 2]
    ahead = 0 if arrived else 1
    assert [s.counts for s in fetches] == [
        dict(fetches=1, fetches_ahead=ahead), dict(fetches=1, fetches_ahead=ahead),
        dict(fetches=1, fetches_ahead=0)]


@pytest.mark.cuda
def test_a_copy_back_leaves_the_next_dispatch_queued_on_the_card():
    """On the card: the copy of dispatch k-1's output arrives while dispatch k
    (a long ``torch.cuda._sleep``) still runs, and its ``wait`` returns then;
    a ``.cpu()`` would have waited for k too."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from oadp_torch.oake.base import HostCopy

    gen = torch.Generator(device='cuda').manual_seed(3)
    x = torch.randn((2048, 512), generator=gen, device='cuda').half()
    x2, y = x * 2, x + 1
    # two page-locked blocks in CUDA's host pool, as a run holds after its
    # first dispatches: creating one waits for the device
    warm = [HostCopy(x), HostCopy(x)]
    for w in warm:
        w.wait()
    del warm
    before = HostCopy(x2)  # dispatch k-1's output
    torch.cuda._sleep(2 * 10 ** 9)  # dispatch k: about a second of the card
    after = HostCopy(y)
    got = before.wait()
    assert before.ready() and not after.ready()
    assert got.is_pinned() and after.host.is_pinned()
    assert torch.equal(after.wait(), y.cpu()) and after.ready()
    assert torch.equal(got, (x * 2).cpu())
