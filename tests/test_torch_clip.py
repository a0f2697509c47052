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
L14_GEOM = dict(GEOM, image_size=224, patch_size=14, stride=14)


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


@pytest.fixture(scope='module')
def l14_models():
    """ViT-L/14's geometry (14-px patches, image 224: under the surgery
    stride 7, a 32 x 32 grid and 1,025 tokens) at the reduced width."""
    from tests.oracles import clip_torch
    torch.manual_seed(0)
    visual = clip_torch.VisionTransformer(
        input_resolution=224, patch_size=14, width=128, layers=2, heads=2,
        output_dim=32,
    ).eval()
    state = clip_torch.state_dict_openai_style(visual)
    jparams, _ = jclip.convert_torch_state_dict(state)
    return state, jparams, jclip.ViTConfig(**L14_GEOM), tclip.ViTConfig(**L14_GEOM)


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


@pytest.mark.parametrize('geometry, interpret_fused', [
    pytest.param('models', False, id='False'),
    pytest.param('models', True, id='True'),
    pytest.param('l14_models', False, id='l14-False'),
    pytest.param('l14_models', True, id='l14-True'),
])
def test_image_encoder_surgery_matches(request, geometry, interpret_fused):
    """At patch 16 (an 8 x 8 grid) and at ViT-L/14's patch 14 at stride 7
    (odd patch, padding 6, positions interpolated to 32 x 32, 1,025
    tokens)."""
    state, jparams, jcfg, tcfg = request.getfixturevalue(geometry)
    jup, jc = jclip.upsample_vit_params(jparams, jcfg)
    tup, tc = tclip.upsample_vit_params(tclip.load_openai_state_dict(state), tcfg)
    assert tc.tokens == jc.tokens == (1025 if geometry == 'l14_models' else 65)
    rng = np.random.RandomState(2)
    images = rng.randn(3, tcfg.image_size, tcfg.image_size, 3).astype(np.float32)
    masks = (rng.rand(3, tc.grid, tc.grid) > 0.5).astype(np.uint8)
    want = np.asarray(jclip.image_encoder_surgery(
        jup, images, masks.astype(np.float32), jc,
        interpret_fused=interpret_fused,
    ))
    got = tclip.image_encoder_surgery(
        tup, torch.from_numpy(images), torch.from_numpy(masks), tc
    ).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize('b, wiring', [(3, 'split'), (8, 'fused')])
def test_surgery_wiring_by_shape(models, monkeypatch, b, wiring):
    """The surgery encoder picks its wiring by shape, as ``oadp_tpu``'s
    gates do on the TPU: B=3 takes the split wiring (kernel 4 in every
    layer but the last, kernel 5 in every layer), B=8 the fused one
    (kernels 1 and 2). Both agree with ``oadp_tpu``'s same wiring."""
    from oadp_torch.ops import attention as ta

    state, jparams, jcfg, tcfg = models
    jup, jc = jclip.upsample_vit_params(jparams, jcfg)
    tup, tc = tclip.upsample_vit_params(tclip.load_openai_state_dict(state), tcfg)
    rng = np.random.RandomState(4)
    images = rng.randn(b, 64, 64, 3).astype(np.float32)
    masks = (rng.rand(b, 8, 8) > 0.5).astype(np.uint8)
    calls = {}
    for name in ('fused_surgery_layer', 'fused_ln_mlp_rows', 'fused_mha_qkv',
                 'fused_side_attention'):
        def counted(*a, _fn=getattr(ta, name), _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(ta, name, counted)
    got = tclip.image_encoder_surgery(
        tup, torch.from_numpy(images), torch.from_numpy(masks), tc
    ).numpy()
    layers = tcfg.layers
    assert calls == ({'fused_mha_qkv': layers - 1, 'fused_side_attention': layers}
                     if wiring == 'split' else
                     {'fused_surgery_layer': layers, 'fused_ln_mlp_rows': layers})
    want = np.asarray(jclip.image_encoder_surgery(
        jup, images, masks.astype(np.float32), jc,
        interpret_fused=wiring == 'fused',
    ))
    np.testing.assert_allclose(got, want, **TOL)


def test_prepared_kernel_params_are_kmajor_copies(models):
    """``prepare_kernel_params`` adds, from the same arrays that
    ``from_jax_params`` carries across, the K-major ``(out, in)`` weights
    and fp32 LayerNorm pairs the CUDA kernels read, and leaves the
    ``(in, out)`` tree as it was."""
    _, jparams, _, _ = models
    params = tclip.from_jax_params({k: v for k, v in jparams.items()})
    before = {k: v.clone() for k, v in _leaves(params)}
    prepared = tclip.prepare_kernel_params(params)
    assert {k: v for k, v in _leaves(params)}.keys() == before.keys()
    assert all(torch.equal(v, before[k]) for k, v in _leaves(params))
    for i, (block, jblock) in enumerate(zip(prepared['blocks'], jparams['blocks'])):
        kern = block['kernel']
        for name, (group, key) in dict(qkv_wt=('attn', 'qkv_w'), out_wt=('attn', 'out_w'),
                                       fc_wt=('mlp', 'fc_w'), proj_wt=('mlp', 'proj_w')).items():
            assert kern[name].is_contiguous(), (i, name)
            np.testing.assert_array_equal(kern[name].numpy(), np.asarray(jblock[group][key]).T)
            np.testing.assert_array_equal(kern[name].numpy(), block[group][key].numpy().T)
        for ln in ('ln_1', 'ln_2'):
            scale, bias = kern[ln]
            assert scale.dtype == bias.dtype == torch.float32
            np.testing.assert_array_equal(scale.numpy(), np.asarray(jblock[ln]['scale']))
            np.testing.assert_array_equal(bias.numpy(), np.asarray(jblock[ln]['bias']))


@pytest.mark.parametrize('encoder', ['stock', 'surgery'])
def test_encoders_with_prepared_params_match(models, encoder):
    """The encoders given the prepared tree (as ``load_clip`` gives it on
    the card) still match ``oadp_tpu`` on the same numpy parameters."""
    state, jparams, jcfg, tcfg = models
    rng = np.random.RandomState(5)
    images = rng.randn(3, 64, 64, 3).astype(np.float32)
    if encoder == 'stock':
        want = np.asarray(jclip.image_encoder(jparams, images, jcfg))
        got = tclip.image_encoder(
            tclip.prepare_kernel_params(tclip.load_openai_state_dict(state)),
            torch.from_numpy(images), tcfg)
    else:
        jup, jc = jclip.upsample_vit_params(jparams, jcfg)
        tup, tc = tclip.upsample_vit_params(tclip.load_openai_state_dict(state), tcfg)
        masks = (rng.rand(3, 8, 8) > 0.5).astype(np.uint8)
        want = np.asarray(jclip.image_encoder_surgery(jup, images, masks.astype(np.float32), jc))
        got = tclip.image_encoder_surgery(
            tclip.prepare_kernel_params(tup), torch.from_numpy(images),
            torch.from_numpy(masks), tc)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize('width', [64, 128])
def test_stock_encoder_wiring_by_shape(monkeypatch, width):
    """The stock encoder takes kernel 3 iff ``D % 128 == 0``, as
    ``oadp_tpu``'s ``_use_fused_block`` does on the TPU, and ``_block``
    (exact softmax) otherwise. With ``qkv_w`` scaled by 12 the logits pass
    the fused softmax's clamp at 80, so the two wirings differ: at D = 64
    the port is held to ``oadp_tpu``'s ``_block``, at D = 128 to its fused
    block in interpret mode."""
    from oadp_torch.ops import attention as ta
    from tests.oracles import clip_torch

    torch.manual_seed(0)
    visual = clip_torch.VisionTransformer(
        input_resolution=64, patch_size=16, width=width, layers=2, heads=2,
        output_dim=32,
    ).eval()
    state = clip_torch.state_dict_openai_style(visual)
    for i in range(2):
        state[f'visual.transformer.resblocks.{i}.attn.in_proj_weight'] *= 12
    geom = dict(GEOM, width=width)
    tcfg = tclip.ViTConfig(**geom)
    params = tclip.load_openai_state_dict(state)
    images = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)

    # the first layer's largest attention logit passes the clamp
    x = tclip._layer_norm(tclip._embed_patches(torch.from_numpy(images), params, tcfg),
                          params['ln_pre'])
    block = params['blocks'][0]
    q, k, _ = (tclip._split_heads(t, 2) for t in (
        tclip._layer_norm(x, block['ln_1']) @ block['attn']['qkv_w']
        + block['attn']['qkv_b']).split(width, -1))
    assert float((q @ k.transpose(-1, -2)).max()) / (width // 2) ** 0.5 > ta.LOGIT_CLAMP

    calls = []
    fused = ta.fused_ln_qkv_attention
    monkeypatch.setattr(ta, 'fused_ln_qkv_attention',
                        lambda *a, **k: calls.append(1) or fused(*a, **k))
    got = tclip.image_encoder(params, torch.from_numpy(images), tcfg).numpy()
    assert len(calls) == (2 if width % 128 == 0 else 0)
    jparams, _ = jclip.convert_torch_state_dict(state)
    want = np.asarray(jclip.image_encoder(
        jparams, images, jclip.ViTConfig(**geom), interpret_fused=width % 128 == 0))
    np.testing.assert_allclose(got, want, **TOL)
