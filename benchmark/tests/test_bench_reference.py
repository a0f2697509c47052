"""The plain reference against ``oadp_torch`` at tiny widths on the CPU
(the reference itself imports nothing of the port)."""

import ast

import numpy as np
import PIL.Image
import pytest
import torch

from benchmark import harness
from benchmark.reference import clip_vit, objects as ref
from benchmark.tests import tiny

CFG = tiny.cell('oake-objects-constant').config


def _image(seed=3, w=150, h=110):
    rng = np.random.default_rng(seed)
    return PIL.Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


def _proposals(seed, w, h, n=24):
    rng = np.random.default_rng(seed)
    side = np.exp(np.log(8) + rng.random((n, 2)) * (np.log([w, h]) - np.log(8)))
    x0 = rng.random((n, 2)) * ([w, h] - side)
    return np.concatenate([x0, x0 + side, rng.random((n, 1))], 1).astype(np.float32)


def test_reference_imports_nothing_of_the_port():
    for path in (harness.BENCH / 'reference').glob('*.py'):
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module or '' for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
        assert not any(n.split('.')[0] in ('oadp_torch', 'oadp_tpu', 'jax', 'jaxlib', 'flax')
                       for n in names), (path, names)


@pytest.mark.parametrize('mode', ['ADAPTIVE', 'CONSTANT'])
def test_crop_boxes_equal_the_ports(mode):
    from oadp_torch.ops import boxes as B
    for seed, (w, h) in enumerate([(150, 110), (480, 640), (640, 427)]):
        rows = ref.kept(_proposals(seed, w, h, 400), 4)
        np.testing.assert_array_equal(ref.expand(rows[:, :4], w, h, mode),
                                      B.expand_boxes(rows[:, :4], w, h, mode))


def test_constant_crop_masks_equal_the_ports():
    """224-px crops are 224 or 225 pixels wide, where the grid's nearest
    index is the same in float32 (the reference) and exactly (the port)."""
    from oadp_torch.ops import boxes as B
    for seed, (w, h) in enumerate([(640, 480), (427, 640), (640, 360), (360, 640)]):
        rows = ref.kept(_proposals(seed + 10, w, h, 1000), 4)
        crops = ref.expand(rows[:, :4], w, h, 'CONSTANT')
        fg = rows[:, :4] - np.concatenate([crops[:, :2]] * 2, 1)
        want = B.grid_mask(fg, crops, 14) > 0.5
        np.testing.assert_array_equal(ref.background(rows, crops, 14, 'cpu').numpy(), want)


def test_crop_pixels_equal_the_ports_fp32_resize():
    from oadp_torch.ops import preprocess as P
    image = _image(5, 160, 120)
    rows = ref.kept(_proposals(6, image.width, image.height), 4)
    crops = ref.expand(rows[:, :4], image.width, image.height, 'ADAPTIVE')
    meta = torch.from_numpy(P.clip_transform_meta(image.width, image.height, crops))
    pad = np.zeros((160, 160, 3), np.uint8)
    pad[:image.height, :image.width] = np.asarray(image)
    k = P.coeff_ksize(float(np.sqrt(8.0) * 160))
    coeffs = P.device_coeffs(meta, k)
    port = P.apply_resize_coeffs(torch.from_numpy(pad).float(), *coeffs)
    want = torch.from_numpy(ref.crop_pixels(image, crops)).float()
    assert (port - want).abs().max() <= 1.0
    assert ((port - want).abs() > 0).float().mean() <= 1e-3  # one uint8 step, rarely


def test_surgery_encoder_equals_the_ports():
    from benchmark.jobs.oake_runner import program_model
    from oadp_torch.models import clip as C
    params = clip_vit.random_params(CFG, 7, 'cpu', torch.float32)
    model = program_model(CFG, params, torch.device('cpu'), torch.float32)
    gen = torch.Generator().manual_seed(8)
    pixels = torch.randn((5, 3, 224, 224), generator=gen)
    bg = torch.rand((5, 14, 14), generator=gen) > 0.6
    port = C.image_encoder_surgery(model.surgery_params, pixels.permute(0, 2, 3, 1),
                                   bg.to(torch.uint8), model.surgery_config)
    want = clip_vit.surgery_encode(params, pixels, bg, CFG, clip_vit.surgery_positions(params, CFG))
    torch.testing.assert_close(port, want, rtol=1e-4, atol=1e-4)
