"""The port stands alone: no module of ``oadp_torch`` nor ``chip_smoke.py``
imports ``jax``, ``oadp_tpu`` or ``regex``, and the CLI, evaluator and
trainer modules import in a process where none of them can be imported at
all."""

import ast
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ('jax', 'jaxlib', 'oadp_tpu', 'regex')


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
        "import sys; sys.modules.update(dict.fromkeys(%r)); "
        "import oadp_torch.oake.objects, oadp_torch.oake.globals, oadp_torch.oake.blocks, "
        "oadp_torch.prompts.vild, oadp_torch.prompts.detpro, oadp_torch.dp.coco_eval, "
        "oadp_torch.dp.lvis_eval, oadp_torch.dp.test, oadp_torch.dp.evaluator, "
        "oadp_torch.models.detector, oadp_torch.dp.train, oadp_torch.dp.trainer, "
        "oadp_torch.dp.synthetic, oadp_torch.base.losses, oadp_torch.ops.assign, chip_smoke; "
        "print('ok')" % (FORBIDDEN,)
    )
    out = subprocess.run(
        [sys.executable, '-c', code], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'ok'
