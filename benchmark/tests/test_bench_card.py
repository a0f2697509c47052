"""On the card, at each cell's own size: the control (the reference in
the precision below the configuration's, in the program's place) fails
the cell's limits on three seeds, and the program passes them on the
same seeds. Run on the chip:
``python3 -m pytest -m cuda benchmark/tests/test_bench_card.py``."""

import pathlib
import tempfile

import pytest

from benchmark import harness

SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


@pytest.mark.cuda
@pytest.mark.parametrize('cell', [w['name'] for w in harness.load_manifest()['workloads']
                                  if w['chips'] == 1])
def test_control_fails_and_program_passes(card, cell):
    harness.use_checkout_caches()
    job = harness.load_module('jobs', harness.load_cell(cell).mix['job'])
    for seed in SEEDS:
        with tempfile.TemporaryDirectory() as tmp:
            spec = harness.Spec(harness.load_cell(cell), seed, 0.0, False, 'cuda', pathlib.Path(tmp))
            control = harness.checks_with_limits(spec.cell, job.control(spec))
        assert not all(c['ok'] for c in control.values()), control
        assert harness.run_cell(cell, seed, 3.0, False, 'cuda')[0]['correct']
