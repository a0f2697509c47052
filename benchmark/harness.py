"""The general part of the benchmark: the manifest, loading every piece by
name, the run of one cell, and its result line.

A run: the job named by the cell's mix builds the system under test
from ``--seed``, warms it, measures for ``--seconds`` and checks what the
timed path produced against the plain reference (``reference/``). The
harness then reads each metric of the cell through its reader
(``metrics/<name>.py``), checks that no JAX module was loaded, and prints
the numbers compared, each beside its limit, as the last lines of
standard error, and the result as the last line of standard output.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import pathlib
import sys
import tempfile
import threading
import time
from typing import Any, Callable

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = ROOT / 'benchmark'

#: top-level module names that a run may not load, compared whole: the
#: port's own name begins with the JAX package's
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'oadp_tpu')

#: the program's build and kernel caches, at fixed paths inside the checkout
CACHE_DIRS = {
    'TRITON_CACHE_DIR': 'triton',
    'TORCH_EXTENSIONS_DIR': 'torch_extensions',
    'TORCHINDUCTOR_CACHE_DIR': 'inductor',
    'CUDA_CACHE_PATH': 'cuda_jit',
}


class BenchmarkError(RuntimeError):
    """A run that cannot give a result (no card, exhausted traffic, a
    profiler session that dropped kernels)."""


def process_start() -> float:
    """This process's start on the ``time.perf_counter`` clock, from
    ``/proc`` (to a clock tick); the import of this module elsewhere."""
    try:
        ticks = int(pathlib.Path('/proc/self/stat').read_text().rsplit(')', 1)[1].split()[19])
        uptime = float(pathlib.Path('/proc/uptime').read_text().split()[0])
        return time.perf_counter() - (uptime - ticks / os.sysconf('SC_CLK_TCK'))
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.perf_counter()


# ---------------------------------------------------------------------------
# Pieces by name
# ---------------------------------------------------------------------------


def load_manifest(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / 'BENCHMARK.json').read_text())


def load_json(kind: str, name: str) -> dict:
    """``benchmark/<kind>/<name>.json``."""
    return json.loads((BENCH / kind / f'{name}.json').read_text())


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (metric names hold dots,
    so the file is loaded by its path)."""
    path = BENCH / kind / f'{name}.py'
    spec = importlib.util.spec_from_file_location(f'benchmark.{kind}.{name}', path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    mix: dict
    end_to_end: list[dict]
    per_layer: list[dict]

    @property
    def chips(self) -> int:
        return int(self.workload['chips'])


def _reports(metric: dict, cell: str) -> bool:
    return 'workloads' not in metric or cell in metric['workloads']


def load_cell(name: str, manifest: dict | None = None) -> Cell:
    manifest = manifest or load_manifest()
    by_name = {w['name']: w for w in manifest['workloads']}
    if name not in by_name:
        raise BenchmarkError(f'no workload {name!r} in BENCHMARK.json')
    workload = by_name[name]
    config = next(c for c in manifest['configs'] if c['name'] == workload['config'])
    return Cell(
        name, workload, json.loads((ROOT / config['file']).read_text()),
        load_json('mixes', workload['traffic']),
        [m for m in manifest['end_to_end'] if _reports(m, name)],
        [m for m in manifest['per_layer'] if _reports(m, name)],
    )


# ---------------------------------------------------------------------------
# What a job hands back
# ---------------------------------------------------------------------------


class Spans:
    """Host spans of the benchmark's own, by name, on the
    ``time.perf_counter`` clock; safe to add from several threads."""

    def __init__(self) -> None:
        self.by_name: dict[str, list[tuple[float, float]]] = {}
        self._lock = threading.Lock()

    def add(self, name: str, t0: float, t1: float) -> None:
        with self._lock:
            self.by_name.setdefault(name, []).append((t0, t1))

    def timed(self, name: str, fn: Callable, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            self.add(name, t0, time.perf_counter())

    def starting_in(self, name: str, lo: float, hi: float) -> list[float]:
        """Durations (s) of the ``name`` spans that start in ``[lo, hi)``."""
        return [t1 - t0 for t0, t1 in self.by_name.get(name, ()) if lo <= t0 < hi]


@dataclasses.dataclass
class Spec:
    """What a job is asked to run."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    tmp: pathlib.Path


@dataclasses.dataclass
class Outcome:
    """What a job measured and checked."""
    window: tuple[float, float]  # (open, close) on the perf_counter clock
    spans: Spans
    counts: dict[str, float]  # work done, by the job's names
    checks: dict[str, float]  # the numbers compared with the cell's limits
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: Any = None  # trace.Trace of the traced run
    chips: int = 1
    notes: dict = dataclasses.field(default_factory=dict)  # for a line before the result


@dataclasses.dataclass
class Ctx:
    """What a metric's reader sees."""
    spec: Spec
    outcome: Outcome

    @property
    def config(self) -> dict:
        return self.spec.cell.config

    @property
    def mix(self) -> dict:
        return self.spec.cell.mix

    @property
    def window_s(self) -> float:
        lo, hi = self.outcome.window
        return hi - lo

    @property
    def counts(self) -> dict:
        return self.outcome.counts

    @property
    def spans(self) -> Spans:
        return self.outcome.spans

    @property
    def trace(self):
        return self.outcome.trace


# ---------------------------------------------------------------------------
# One run
# ---------------------------------------------------------------------------


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is a JAX one, compared whole."""
    return sorted({m.split('.', 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def use_checkout_caches() -> None:
    base = ROOT / 'build' / 'benchmark_cache'
    for key, sub in CACHE_DIRS.items():
        os.environ[key] = str(base / sub)


def checks_with_limits(cell: Cell, values: dict[str, float]) -> dict[str, dict]:
    """Each number compared beside its limit (``limits/<cell>.json``); a
    number without a limit, a limit never set, or a number that could not
    be read (None, infinite) fails."""
    limits = load_json('limits', cell.name)
    out = {}
    for name in sorted(set(values) | set(limits)):
        value, limit = values.get(name), limits.get(name)
        if value is not None and not math.isfinite(value):
            value = None
        ok = value is not None and limit is not None and value <= limit
        out[name] = dict(value=value, limit=limit, ok=ok)
    return out


def read_metrics(metrics: list[dict], ctx: Ctx) -> dict[str, dict]:
    out = {}
    for metric in metrics:
        if metric['name'] == 'setup_s':
            continue
        value = load_module('metrics', metric['name']).read(ctx)
        if value is not None:
            out[metric['name']] = dict(value=float(value), unit=metric['unit'])
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = 'cuda',
             config_over: dict | None = None, mix_over: dict | None = None,
             manifest: dict | None = None, started: float | None = None
             ) -> tuple[dict, dict]:
    """Run one cell once; return its result object and the job's notes
    (``nvidia-smi`` samples and launch counts of a traced run), which the
    command line prints on the line before the result. ``device='cpu'``,
    ``config_over`` and ``mix_over`` are for the CPU tests (tiny widths);
    the command line always runs on the card."""
    started = process_start() if started is None else started
    cell = load_cell(workload, manifest)
    cell.config.update(config_over or {})
    cell.mix.update(mix_over or {})
    job = load_module('jobs', cell.mix['job'])
    with tempfile.TemporaryDirectory(prefix='benchmark-') as tmp:
        spec = Spec(cell, int(seed), float(seconds), bool(trace), device, pathlib.Path(tmp))
        outcome = job.run(spec)
    ctx = Ctx(spec, outcome)
    checks = checks_with_limits(cell, outcome.checks)
    if trace:
        metrics = read_metrics(cell.per_layer, ctx)
    else:
        metrics = read_metrics(cell.end_to_end, ctx)
        metrics['setup_s'] = dict(value=outcome.window[0] - started, unit='s')
    result = dict(
        correct=all(c['ok'] for c in checks.values()) and outcome.failed == 0,
        attempted=outcome.attempted,
        failed=outcome.failed,
        metrics=metrics,
        device=device_info(device, outcome),
    )
    if trace and outcome.trace is not None:
        result['breakdown'] = outcome.trace.breakdown(*outcome.window)
    result['checks'] = {k: dict(value=c['value'], limit=c['limit']) for k, c in checks.items()}
    return result, outcome.notes


def device_info(device: str, outcome: Outcome) -> dict:
    info = dict(platform='cpu', kind='cpu', count=outcome.chips,
                memory_peak_bytes=int(outcome.memory_peak_bytes))
    if device == 'cuda':
        import torch
        info.update(platform='gpu', kind=torch.cuda.get_device_name(0))
    if outcome.trace is not None:
        lo, hi = outcome.window
        info.update(busy_s=outcome.trace.busy_s(lo, hi), window_s=hi - lo)
    return info


def main(argv: list[str] | None = None) -> int:
    import argparse

    started = process_start()
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    use_checkout_caches()
    cell = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f'benchmark: the cell needs {cell.chips} CUDA device(s); torch sees '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}',
              file=sys.stderr)
        return 3
    from . import trace as T
    print(json.dumps(dict(card=T.card_info())), file=sys.stderr, flush=True)
    result, notes = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), 'cuda',
                             started=started)
    found = forbidden_modules()
    if found:
        print(f'benchmark: the run loaded {", ".join(found)}; it may load no JAX module',
              file=sys.stderr)
        return 4
    for name, c in result['checks'].items():
        print(f'check {name} {c["value"]!r} limit {c["limit"]!r}', file=sys.stderr)
    sys.stderr.flush()
    if notes:
        print(json.dumps(notes), flush=True)
    print(json.dumps(result), flush=True)
    return 0
