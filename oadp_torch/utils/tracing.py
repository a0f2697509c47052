"""Spans of the port's host threads, kept while a ``torch.profiler``
session is open in the process.

A span says what one thread was doing between two instants of the
``time.perf_counter`` clock: its name, the thread's name, the thread's CPU
time over it (``cpu_s``; far below the wall time, the thread was off the
CPU: blocked on a lock, the GIL or the device; where the host counts CPU
time in scheduler ticks, read it summed over many spans), the request it
serves (``key``: an image id for a per-image span, a dispatch number for
a per-dispatch one), the image ids of that dispatch (``ids``) and the
changes of some counters over it (``counts``)::

    with tracing.span('runner.fetch', key=n):
        records = [finalize(r) for r in records]

The recorder keeps the newest :data:`RING` spans in memory (:func:`spans`)
and never writes on the way. It records exactly while a profiler session
is open (``torch.profiler.profile`` started and not yet stopped, whoever
started it); outside one a span reads one flag, records nothing and
leaves the body's result and exceptions as they are.

On the process's main thread, which runs the OAKE runner's loop and
launches the device work, a span also opens a profiler range of its name
(a ``cpu_op`` event), so that it lands in the profiler's trace on the
trace's own clock, beside the kernels it launched. The range keeps the
GIL: ``record_function``'s enter and exit let go of it, and beside the
producer and the saver each then took milliseconds to get it back. The
main thread's spans never nest, so its outermost range is its phase. The
profiler keeps no range of a thread started after the session, so the
other threads' spans live in the recorder alone; :func:`merge` writes
every thread's spans into an exported trace, each thread on a row of its
own, through the marker that :func:`clock` leaves in the session.
"""

from __future__ import annotations

__all__ = ['RING', 'Span', 'span', 'serving', 'spans', 'clear', 'clock', 'merge']

import collections
import dataclasses
import json
import pathlib
import threading
import time
from typing import Any, Callable

import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

#: the most spans the recorder holds; the oldest go first
RING = 1 << 16

#: the name of the range that :func:`clock` leaves in a session
CLOCK = 'oadp_torch.clock'

#: the process row of the spans that :func:`merge` adds to a trace
PROCESS = 'oadp_torch spans'


@dataclasses.dataclass(frozen=True, slots=True)
class Span:
    name: str
    thread: str
    t0: float  # perf_counter seconds
    t1: float
    cpu_s: float  # the thread's CPU seconds over the span
    key: Any = None
    ids: tuple = ()
    counts: dict | None = None  # counter deltas over the span


_ring: collections.deque = collections.deque(maxlen=RING)
_lock = threading.Lock()
_local = threading.local()


class serving:
    """``with serving(key, ids):`` the spans that this thread opens inside
    it without a key of their own serve ``key`` (a dispatch number) and
    ``ids`` (its image ids)."""

    __slots__ = ('request', '_outer')

    def __init__(self, key: Any, ids: tuple = ()) -> None:
        self.request = (key, tuple(ids))

    def __enter__(self) -> 'serving':
        self._outer = getattr(_local, 'request', None)
        _local.request = self.request
        return self

    def __exit__(self, *exc) -> bool:
        _local.request = self._outer
        return False


class _Off:
    """What :func:`span` gives outside a session: a context that does nothing."""

    __slots__ = ('key',)

    def __enter__(self) -> '_Off':
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def span(name: str, key: Any = None, counters: Callable[[], dict] | None = None):
    """``with span(name, key=None, counters=None):`` records a :class:`Span`
    of the body while a profiler session is open. ``counters``, a function
    returning a dict of numbers, is read at both ends and the span keeps
    the changes. The span's ``key`` may be set inside the body, once the
    request is known."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Recording(name, key, counters)


class _Recording:
    __slots__ = ('name', 'key', 'counters', '_t0', '_c0', '_n0', '_range')

    def __init__(self, name: str, key: Any, counters: Callable[[], dict] | None) -> None:
        self.name, self.key, self.counters = name, key, counters

    def __enter__(self) -> '_Recording':
        self._n0 = self.counters() if self.counters else None
        self._range = None
        if threading.current_thread() is threading.main_thread():
            self._range = _RecordFunctionFast(self.name)
            self._range.__enter__()
        self._c0 = time.thread_time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        cpu_s = time.thread_time() - self._c0
        if self._range is not None:
            self._range.__exit__(None, None, None)
        counts = None
        if self._n0 is not None:
            n1 = self.counters()
            counts = {k: v - self._n0[k] for k, v in n1.items() if k in self._n0}
        key, ids = self.key, ()
        request = getattr(_local, 'request', None)
        if request is not None:
            ids = request[1]
            if key is None:
                key = request[0]
        record = Span(self.name, threading.current_thread().name, self._t0, t1, cpu_s,
                      key, ids, counts)
        with _lock:
            _ring.append(record)
        return False


def spans() -> list[Span]:
    """The spans held, oldest first."""
    with _lock:
        return list(_ring)


def clear() -> None:
    """Drop every span held."""
    with _lock:
        _ring.clear()


def clock() -> float:
    """Leave a marker range in the open session and return its instant on
    the ``perf_counter`` clock, for :func:`merge`."""
    t = time.perf_counter()
    with _RecordFunctionFast(CLOCK):
        pass
    return t


def merge(path: str | pathlib.Path, mark: float) -> int:
    """Add the spans begun since ``mark`` (:func:`clock`) to the chrome
    trace at ``path``, on the trace's clock: one row a thread under the
    process ``oadp_torch spans``, ``key``, ``ids``, ``cpu_ms`` and the
    counter changes as arguments. Returns how many it added."""
    path = pathlib.Path(path)
    trace = json.loads(path.read_text())
    events = trace['traceEvents']
    marks = [e['ts'] for e in events if e.get('name') == CLOCK and 'ts' in e]
    if not marks:
        raise ValueError(f'{path} holds no {CLOCK} marker')
    offset_us = marks[0] - mark * 1e6
    added = [s for s in spans() if s.t0 >= mark]
    for thread in sorted({s.thread for s in added}):
        events.append(dict(ph='M', name='thread_name', pid=PROCESS, tid=thread,
                           args=dict(name=thread)))
    for s in added:
        args = dict(cpu_ms=1e3 * s.cpu_s, **(s.counts or {}))
        if s.key is not None:
            args['key'] = s.key
        if s.ids:
            args['ids'] = list(s.ids)
        events.append(dict(ph='X', cat='oadp_span', name=s.name, pid=PROCESS, tid=s.thread,
                           ts=s.t0 * 1e6 + offset_us, dur=(s.t1 - s.t0) * 1e6, args=args))
    path.write_text(json.dumps(trace))
    return len(added)
