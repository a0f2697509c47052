"""Tests of the benchmark (``python -m pytest benchmark/tests``). Tests
marked ``cuda`` need a card and skip elsewhere, by the ``card`` fixture."""

import sys
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line('markers', 'cuda: needs a CUDA device; skips with a reason elsewhere')


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')
