"""The port stands alone: no module of ``oadp_torch`` nor ``chip_smoke.py``
imports ``jax`` or ``oadp_tpu``, and the CLI modules import in a process
where ``jax`` cannot be imported at all."""

import ast
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ('jax', 'jaxlib', 'oadp_tpu')


def _port_files():
    return sorted((REPO / 'oadp_torch').rglob('*.py')) + [REPO / 'chip_smoke.py']


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ''


@pytest.mark.parametrize(
    'path', _port_files(), ids=lambda p: str(p.relative_to(REPO))
)
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imports(path) if m.split('.')[0] in FORBIDDEN]
    assert not bad, f'{path}: imports {bad}'


def test_cli_modules_import_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['jaxlib'] = None; "
        "sys.modules['oadp_tpu'] = None; "
        "import oadp_torch.oake.objects, oadp_torch.oake.globals, chip_smoke; "
        "print('ok')"
    )
    out = subprocess.run(
        [sys.executable, '-c', code], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'ok'
