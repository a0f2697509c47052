"""BENCHMARK.json against the contract's characters and shapes, and every
configuration, mix, job and metric loading by its name."""

import json
import re

import pytest

from benchmark import harness

MANIFEST = harness.load_manifest()
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
METRICS = MANIFEST['end_to_end'] + MANIFEST['per_layer']


def test_manifest_keys_and_names():
    assert set(MANIFEST) == {'command', 'paths', 'run_seconds', 'configs', 'workloads',
                             'end_to_end', 'per_layer'}
    names = [m['name'] for m in METRICS]
    names += [c['name'] for c in MANIFEST['configs']] + [w['name'] for w in MANIFEST['workloads']]
    names += [w['traffic'] for w in MANIFEST['workloads']]
    names += [k for c in MANIFEST['configs'] for k in c['reduced']]
    assert all(NAME.match(n) for n in names), names
    for group in ('configs', 'workloads'):
        assert len({x['name'] for x in MANIFEST[group]}) == len(MANIFEST[group])
    assert len({m['name'] for m in METRICS}) == len(METRICS)
    assert all(UNIT.match(m['unit']) and m['better'] in ('lower', 'higher') for m in METRICS)
    assert 1 <= MANIFEST['run_seconds'] <= 51 and isinstance(MANIFEST['run_seconds'], int)
    assert len(json.dumps(MANIFEST)) < 64 * 1024
    for text in ([c['source'] for c in MANIFEST['configs']] + [x['why'] for x in
                 MANIFEST['configs'] + MANIFEST['workloads']] + [m['layer'] for m in
                 MANIFEST['per_layer']] + MANIFEST['command']):
        assert 1 <= len(text) <= 200 and '\n' not in text and '\t' not in text


def test_metrics_follow_the_contract():
    e2e = {m['name']: m for m in MANIFEST['end_to_end']}
    assert 'setup_s' in e2e and e2e['setup_s']['bound'] <= 0.25
    for m in MANIFEST['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25 and m['source'] in ('host_clock', 'device_trace')
    for m in MANIFEST['per_layer']:
        assert m['moves'] in e2e and m['source'] in (
            'device_trace', 'program_span', 'program_counter', 'host_clock')
        # a cell that reads the metric reports the end-to-end metric it moves
        for cell in m['workloads']:
            assert cell in e2e[m['moves']].get('workloads', [cell])
        if 'roofline' in m['name']:
            assert m['name'].endswith('_roofline') and m['unit'] == '%'
    by_layer = {}
    for m in MANIFEST['per_layer']:
        by_layer.setdefault(m['layer'].lower(), set()).add(m['layer'])
    assert all(len(v) == 1 for v in by_layer.values())


def test_every_cell_reports_what_the_contract_asks():
    four = [w for w in MANIFEST['workloads'] if w['chips'] == 4]
    assert len(four) <= max(1, len(MANIFEST['workloads']) // 4)
    for w in MANIFEST['workloads']:
        cell = harness.load_cell(w['name'], MANIFEST)
        names = {m['name'] for m in cell.end_to_end}
        assert 'setup_s' in names and len(names) >= 2
        assert cell.per_layer
        assert w['chips'] in (1, 4)
    pairs = [(w['config'], w['traffic']) for w in MANIFEST['workloads']]
    assert len(set(pairs)) == len(pairs)
    used = {w['config'] for w in MANIFEST['workloads']}
    assert used == {c['name'] for c in MANIFEST['configs']}


@pytest.mark.parametrize('config', MANIFEST['configs'], ids=lambda c: c['name'])
def test_configuration_loads_by_name(config):
    data = json.loads((harness.ROOT / config['file']).read_text())
    assert config['file'].startswith(tuple(p + '/' for p in MANIFEST['paths']))
    assert data['name'] == config['name'] and data['reduced'] == config['reduced']


@pytest.mark.parametrize('cell', MANIFEST['workloads'], ids=lambda w: w['name'])
def test_mix_job_and_limits_load_by_name(cell):
    mix = harness.load_json('mixes', cell['traffic'])
    job = harness.load_module('jobs', mix['job'])
    assert callable(job.run) and callable(job.control)
    limits = harness.load_json('limits', cell['name'])
    assert limits and all(isinstance(v, (int, float)) and v >= 0 for v in limits.values())


@pytest.mark.parametrize('metric', [m for m in METRICS if m['name'] != 'setup_s'],
                         ids=lambda m: m['name'])
def test_metric_reader_loads_by_name(metric):
    assert callable(harness.load_module('metrics', metric['name']).read)


def test_files_are_named_from_name_characters():
    for path in harness.BENCH.rglob('*'):
        if '__pycache__' in path.parts:
            continue
        rel = path.relative_to(harness.ROOT).as_posix()
        assert re.match(r'^[A-Za-z0-9_./-]+$', rel), rel


SHARED = {'__init__', 'kernel_parts', 'peaks', 'work'}


@pytest.mark.parametrize('path', [p for p in sorted((harness.BENCH / 'metrics').glob('*.py'))
                                  if p.stem not in SHARED], ids=lambda p: p.stem)
def test_every_reader_file_loads(path):
    """Every reader file is a metric of BENCHMARK.json and loads."""
    assert path.stem in {m['name'] for m in METRICS}
    assert callable(harness.load_module('metrics', path.stem).read)
