"""Whole runs of each cell on the CPU at tiny widths: correct when sound,
not correct under each fault the cell can have, no JAX module loaded, the
same inputs from the same seed, and the control far above the program."""

import json
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny

SEED = 2 ** 31 + 11
CELLS = sorted(tiny.TINY)


@pytest.mark.parametrize('cell', CELLS)
def test_cpu_run_is_correct_and_loads_no_jax(cell):
    code = ('import json; from benchmark import harness; from benchmark.tests import tiny; '
            f'r = tiny.run({cell!r}, {SEED}); '
            'print(json.dumps(dict(r=r, found=harness.forbidden_modules())))')
    out = subprocess.run([sys.executable, '-c', code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=600, check=True).stdout.strip().splitlines()[-1]
    line = json.loads(out)
    assert line['found'] == []
    r = line['r']
    assert r['correct'], r['checks']
    assert r['failed'] == 0 and r['attempted'] > 0
    assert set(r['metrics']) == {'oake_img_per_s', 'setup_s'}
    assert list(r)[-1] == 'checks'


def _files(cell, seed):
    job = harness.load_module('jobs', tiny.cell(cell).mix['job'])
    make = getattr(job, 'make_split', None) or job.R.make_pool
    with tempfile.TemporaryDirectory() as tmp:
        split = make(tiny.cell(cell).mix, seed, pathlib.Path(tmp), 'cpu')
        return split, {p.name: p.read_bytes() for p in sorted(pathlib.Path(tmp).rglob('*'))
                       if p.is_file()}


@pytest.mark.parametrize('cell', CELLS)
def test_same_seed_same_inputs(cell):
    a, fa = _files(cell, SEED)
    _, fb = _files(cell, SEED)
    c, fc = _files(cell, SEED + 1)
    assert fa == fb
    assert fa['pool_000.jpg'] != fc['pool_000.jpg']
    if 'proposals.pkl' in fa:
        assert fa['proposals.pkl'] != fc['proposals.pkl']
        assert a['proposals'].shape == c['proposals'].shape
    # another seed draws other content over the same sizes in the same order
    assert np.array_equal(a['image_of'], c['image_of'])


def _objects_step(fault):
    from oadp_torch.oake.encoders import OakeSteps
    step = OakeSteps.objects_packed_step

    def altered(self, bufs, crop_rows, k_pad, k_own=None):
        out = step(self, bufs, crop_rows, k_pad, k_own).clone()
        out[[0, 1]] = out[[1, 0]]  # two answers swapped where they are made
        return out

    def half(self, bufs, crop_rows, k_pad, k_own=None):
        keep = max(1, len(bufs) // 2)
        out = step(self, bufs[:keep], crop_rows, k_pad, None if k_own is None else k_own[:keep])
        rest = out.float().mean(0, keepdim=True).to(out.dtype)
        return torch.cat([out, rest.expand((len(bufs) - keep) * crop_rows, -1)])

    return 'objects_packed_step', {'altered_answer': altered, 'half_batch_left_out': half}[fault]


STEPS = {'oake-objects-constant': _objects_step}


@pytest.mark.parametrize('fault', ['altered_answer', 'half_batch_left_out'])
@pytest.mark.parametrize('cell', CELLS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    from oadp_torch.oake.encoders import OakeSteps
    monkeypatch.setattr(OakeSteps, *STEPS[cell](fault))
    r = tiny.run(cell, SEED + 2)
    assert not r['correct'], r['checks']
    assert r['checks']['emb_gap_max']['value'] > r['checks']['emb_gap_max']['limit']


@pytest.mark.parametrize('cell', CELLS)
def test_control_reads_far_above_the_program(cell):
    c = tiny.cell(cell)
    job = harness.load_module('jobs', c.mix['job'])
    program = tiny.run(cell, SEED + 3)['checks']['emb_gap_max']
    with tempfile.TemporaryDirectory() as tmp:
        control = job.control(harness.Spec(c, SEED + 3, 0.0, False, 'cpu', pathlib.Path(tmp)))
    assert control['emb_gap_max'] > 10 * program['value']
    assert control['rows_missing'] == 0


@pytest.mark.parametrize('mix', [w['traffic'] for w in harness.load_manifest()['workloads']])
def test_a_window_reads_every_size(mix):
    """The ids in the order the OAKE runner takes them (``oadp_torch/oake/
    base.py:_items``: by size, then id) hold every size of the mix before
    the rest of the ids, which all have the size taken last."""
    m = harness.load_json('mixes', mix)
    m['sizes'] = [[w // 8, h // 8] for w, h in m['sizes']]  # the same order, small files
    with tempfile.TemporaryDirectory() as tmp:
        split = harness.load_module('jobs', 'oake_runner').make_pool(
            m, SEED, pathlib.Path(tmp), 'cpu')
    sizes = split['sizes']
    order = sorted(split['ids'], key=lambda i: (*sizes[split['image_of'][i - 1]], i))
    taken = [sizes[split['image_of'][i - 1]] for i in order]
    last = max(sizes)
    lead = (len(sizes) - sizes.count(last)) * m['ids_each']
    assert set(taken[:lead]) == set(sizes) - {last}
    assert set(taken[lead:]) == {last}
    assert len(taken) == m['ids'] and len(set(split['image_of'])) == len(sizes)
