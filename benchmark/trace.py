"""The traced run: a ``torch.profiler`` session over the timed part of a
run, its reduction to device intervals on the host's clock, the check of
its kernels against the port's launch counters, and ``nvidia-smi``
samples beside the window.

Every interval is put on the ``time.perf_counter`` clock of the process,
through one marker that the session records right after it starts, so
that the benchmark's own spans and windows select from it directly.
"""

from __future__ import annotations

import collections
import json
import pathlib
import subprocess
import threading
import time

from .harness import BenchmarkError
from .metrics.kernel_parts import LAUNCH_FAMILIES, part

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
SMI_FIELDS = ('name', 'clocks.sm', 'clocks.mem', 'power.draw', 'power.limit',
              'temperature.gpu')


def _smi(fields) -> list[list[str]]:
    out = subprocess.run(
        ['nvidia-smi', f'--query-gpu={",".join(fields)}', '--format=csv,noheader,nounits'],
        capture_output=True, text=True, timeout=30, check=True).stdout
    return [[v.strip() for v in line.split(',')] for line in out.strip().splitlines()]


def card_info() -> list[dict] | str:
    """Each card's name, power limit and clocks, from ``nvidia-smi``."""
    fields = ('name', 'power.limit', 'clocks.max.sm', 'clocks.sm')
    try:
        return [dict(zip(fields, row)) for row in _smi(fields)]
    except (OSError, subprocess.SubprocessError) as e:
        return f'nvidia-smi failed: {e}'


class Smi:
    """``nvidia-smi`` samples every ``every`` seconds on a thread, each
    with its time on the ``perf_counter`` clock."""

    def __init__(self, every: float = 2.0) -> None:
        self.every = every
        self.samples: list[dict] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def _loop(self) -> None:
        while not self._stop.is_set():
            t = time.perf_counter()
            try:
                rows = _smi(SMI_FIELDS)
            except (OSError, subprocess.SubprocessError) as e:
                self.samples.append(dict(t=t, error=str(e)))
                return
            self.samples.append(dict(t=t, cards=[dict(zip(SMI_FIELDS, r)) for r in rows]))
            self._stop.wait(self.every)

    def __enter__(self) -> 'Smi':
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(timeout=60)


def launch_counters() -> dict[str, int]:
    """The port's launch counters, one flat dict."""
    from oadp_torch.ops import attention, embed, nms, preprocess
    out = {}
    for module in (attention, embed, nms, preprocess):
        out.update(module.LAUNCHES)
    return out


class Session:
    """A profiler session with host and device activity over the timed
    part of a run (the caller's thread launches all the device work)."""

    def start(self) -> 'Session':
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        torch.cuda.synchronize()
        self.before = launch_counters()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self.t_mark = time.perf_counter()
        with record_function('benchmark.clock'):
            pass
        return self

    def stop(self, path: pathlib.Path) -> 'Trace':
        import torch

        torch.cuda.synchronize()
        self.prof.stop()
        after = launch_counters()
        self.prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())['traceEvents']
        path.unlink()
        trace = Trace(events, self.t_mark)
        trace.launches = check_launches(trace, self.before, after)
        return trace


def check_launches(trace: 'Trace', before: dict, after: dict) -> dict[str, list[int]]:
    """Hold the session's kernels to the launch counters: each family of
    :data:`LAUNCH_FAMILIES` traced as often as its entry points launched
    it. A session that dropped kernels raises instead of reading low."""
    delta = {k: after[k] - before.get(k, 0) for k in after}
    traced = collections.Counter(part(name) for name, _, _ in trace.kernels)
    if not trace.kernels:
        raise BenchmarkError('the profiler session recorded no kernel')
    out = {}
    for family, rule in LAUNCH_FAMILIES.items():
        if any(delta.get(c, 0) for c in rule.get('unless', ())):
            continue
        launched = sum(delta.get(c, 0) for c in rule['counters'])
        out[family] = [traced.get(family, 0), launched]
        if traced.get(family, 0) != launched:
            raise BenchmarkError(f'profiler session: {traced.get(family, 0)} {family} kernels '
                                 f'traced, {launched} launched')
    return out


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Trace:
    """A session's events on the ``perf_counter`` clock (seconds)."""

    def __init__(self, events: list[dict], t_mark: float) -> None:
        marks = [e for e in events if e.get('name') == 'benchmark.clock' and 'ts' in e]
        if not marks:
            raise BenchmarkError('the profiler session lost its clock marker')
        offset = marks[0]['ts'] * 1e-6 - t_mark
        self.main_tid = marks[0].get('tid')

        def span(e):
            t0 = e['ts'] * 1e-6 - offset
            return t0, t0 + e.get('dur', 0) * 1e-6

        self.device: list[tuple[str, float, float]] = []
        self.kernels: list[tuple[str, float, float]] = []
        self.host: list[tuple[str, float, float]] = []
        for e in events:
            if e.get('ph') != 'X':
                continue
            cat = e.get('cat')
            if cat in DEVICE_CATS:
                row = (e['name'], *span(e))
                self.device.append(row)
                if cat == 'kernel':
                    self.kernels.append(row)
            elif cat in ('cpu_op', 'user_annotation') and e.get('tid') == self.main_tid:
                self.host.append((e['name'], *span(e)))
        self.busy = _union([(a, b) for _, a, b in self.device])
        self.launches: dict = {}
        self.spans = None  # the run's harness.Spans, to name idle gaps

    def busy_s(self, lo: float, hi: float) -> float:
        """Seconds of ``[lo, hi]`` in which an operation ran on the device."""
        return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in self.busy)

    def kernel_s(self, lo: float, hi: float, keep=None) -> float:
        """Summed kernel seconds inside ``[lo, hi]``, of the kernels whose
        name ``keep`` accepts (all by default)."""
        return sum(max(0.0, min(b, hi) - max(a, lo)) for n, a, b in self.kernels
                   if keep is None or keep(n))

    def gaps(self, lo: float, hi: float) -> list[tuple[float, float]]:
        out, t = [], lo
        for a, b in self.busy:
            if b <= lo or a >= hi:
                continue
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if t < hi:
            out.append((t, hi))
        return out

    def host_at(self, t: float) -> str:
        """What the host was doing at ``t``: the outermost operation of the
        launching thread, else the benchmark's spans open then."""
        ops = [(a, n) for n, a, b in self.host if a <= t < b]
        if ops:
            return 'main:' + min(ops)[1]
        open_spans = sorted(name for name, spans in (self.spans.by_name.items() if self.spans else ())
                            if any(a <= t < b for a, b in spans))
        return 'span:' + '+'.join(open_spans) if open_spans else 'main:idle'

    def breakdown(self, lo: float, hi: float, top: int = 10) -> dict:
        """The device operations that took most time in ``[lo, hi]`` and
        the longest idle gaps, each named by what the host was doing."""
        by_name: dict[str, float] = collections.defaultdict(float)
        for n, a, b in self.device:
            by_name[n[:160]] += max(0.0, min(b, hi) - max(a, lo))
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(lo, hi), key=lambda g: g[0] - g[1])[:top]
        return dict(device_ops=[[n, s] for n, s in ops],
                    idle_gaps=[[self.host_at((a + b) / 2), b - a] for a, b in gaps])
