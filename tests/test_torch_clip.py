"""The port's CLIP image encoders (``oadp_torch.models.clip``) against
``oadp_tpu.models.clip`` on one shared random OpenAI-layout state dict,
fp32 on the CPU, at a reduced geometry (width 128, 2 layers, 2 heads of
64). Tolerances are those of ``tests/test_clip_parity.py``."""

import numpy as np
import pytest
import torch

from oadp_tpu.models import clip as jclip
from oadp_torch.models import clip as tclip

torch.set_num_threads(1)

TOL = dict(atol=2e-4, rtol=1e-3)
GEOM = dict(image_size=64, patch_size=16, stride=16, width=128, layers=2,
            heads=2, output_dim=32)


@pytest.fixture(scope='module')
def models():
    from tests.oracles import clip_torch
    torch.manual_seed(0)
    visual = clip_torch.VisionTransformer(
        input_resolution=64, patch_size=16, width=128, layers=2, heads=2,
        output_dim=32,
    ).eval()
    state = clip_torch.state_dict_openai_style(visual)
    jparams, _ = jclip.convert_torch_state_dict(state)
    return state, jparams, jclip.ViTConfig(**GEOM), tclip.ViTConfig(**GEOM)


def _leaves(tree, prefix=''):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f'{prefix}.{k}')
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f'{prefix}.{i}')
    else:
        yield prefix, tree


def test_state_dict_load_equals_from_jax_params(models):
    state, jparams, _, _ = models
    ours = dict(_leaves(tclip.load_openai_state_dict(state)))
    via_jax = dict(_leaves(tclip.from_jax_params(
        {k: v for k, v in jparams.items()}
    )))
    assert ours.keys() == via_jax.keys()
    for k in ours:
        assert ours[k].dtype == via_jax[k].dtype == torch.float32, k
        np.testing.assert_array_equal(ours[k].numpy(), via_jax[k].numpy(), k)


def test_init_shapes_match_loaded(models):
    state, _, _, tcfg = models
    init = dict(_leaves(tclip.init_vit_params(torch.Generator().manual_seed(0), tcfg)))
    loaded = dict(_leaves(tclip.load_openai_state_dict(state)))
    assert {k: tuple(v.shape) for k, v in init.items()} == {
        k: tuple(v.shape) for k, v in loaded.items()
    }
    again = dict(_leaves(tclip.init_vit_params(torch.Generator().manual_seed(0), tcfg)))
    assert all(torch.equal(init[k], again[k]) for k in init)


def test_upsample_equal(models):
    state, jparams, jcfg, tcfg = models
    jup, jc = jclip.upsample_vit_params(jparams, jcfg)
    tup, tc = tclip.upsample_vit_params(tclip.load_openai_state_dict(state), tcfg)
    assert (tc.stride, tc.grid, tc.tokens) == (jc.stride, jc.grid, jc.tokens)
    np.testing.assert_array_equal(
        tup['positional_embedding'].numpy(),
        np.asarray(jup['positional_embedding']),
    )


@pytest.mark.parametrize('interpret_fused', [False, True])
def test_image_encoder_matches(models, interpret_fused):
    state, jparams, jcfg, tcfg = models
    images = np.random.RandomState(1).randn(3, 64, 64, 3).astype(np.float32)
    want = np.asarray(jclip.image_encoder(
        jparams, images, jcfg, interpret_fused=interpret_fused
    ))
    got = tclip.image_encoder(
        tclip.load_openai_state_dict(state), torch.from_numpy(images), tcfg
    ).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize('interpret_fused', [False, True])
def test_image_encoder_surgery_matches(models, interpret_fused):
    state, jparams, jcfg, tcfg = models
    jup, jc = jclip.upsample_vit_params(jparams, jcfg)
    tup, tc = tclip.upsample_vit_params(tclip.load_openai_state_dict(state), tcfg)
    rng = np.random.RandomState(2)
    images = rng.randn(3, 64, 64, 3).astype(np.float32)
    masks = (rng.rand(3, 8, 8) > 0.5).astype(np.uint8)
    want = np.asarray(jclip.image_encoder_surgery(
        jup, images, masks.astype(np.float32), jc,
        interpret_fused=interpret_fused,
    ))
    got = tclip.image_encoder_surgery(
        tup, torch.from_numpy(images), torch.from_numpy(masks), tc
    ).numpy()
    np.testing.assert_allclose(got, want, **TOL)
