"""The CLIP patch embedding and ``ln_pre`` of the port's kernels route
(``oadp_torch.ops.embed``: im2col rows, the product with ``conv1`` K-major,
CLS + positions + ``ln_pre``) against ``oadp_tpu.models.clip``'s
``_embed_patches`` and ``_layer_norm(ln_pre)`` on one shared random
OpenAI-layout state dict (patch 32, width 64, 64 x 64 images), at the
surgery's half stride (16, padding 15) and the stock stride (32), with the
plain versions the entries take on the CPU; then what the encoders hand
each entry, and the shape gate.

Tolerances: fp32 as ``tests/test_torch_clip.py`` (atol 2e-4, rtol 1e-3);
bf16, where both sides round the product, the sum with the positions and
the LayerNorm to bf16 at the same places but sum the product in another
order, at most 2 bf16 units in the last place of the larger value (a
product within an ulp of a rounding boundary rounds apart, and LayerNorm
scales that step)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from oadp_tpu.models import clip as jclip
from oadp_torch.models import clip as tclip
from oadp_torch.ops import embed as EM

torch.set_num_threads(1)

TOL = dict(atol=2e-4, rtol=1e-3)
GEOM = dict(image_size=64, patch_size=32, stride=32, width=64, layers=1, heads=1,
            output_dim=32)


@pytest.fixture(scope='module')
def models():
    from tests.oracles import clip_torch
    torch.manual_seed(0)
    visual = clip_torch.VisionTransformer(
        input_resolution=64, patch_size=32, width=64, layers=1, heads=1, output_dim=32,
    ).eval()
    state = clip_torch.state_dict_openai_style(visual)
    jparams, _ = jclip.convert_torch_state_dict(state)
    tparams = tclip.load_openai_state_dict(state)
    jcfg, tcfg = jclip.ViTConfig(**GEOM), tclip.ViTConfig(**GEOM)
    jup, jc = jclip.upsample_vit_params(jparams, jcfg)
    tup, tc = tclip.upsample_vit_params(tparams, tcfg)
    return {32: (jparams, jcfg, tparams, tcfg), 16: (jup, jc, tup, tc)}


def _ours(images, params, cfg):
    """The kernels route's plain versions, entry by entry."""
    d = cfg.width
    rows = EM.patch_rows_plain(images, cfg.patch_size, cfg.stride)
    x = EM.patch_embed_plain(rows, params['conv1'].reshape(d, -1).to(images.dtype))
    ln = params['ln_pre']
    return EM.embed_ln_pre_plain(x.view(images.shape[0], -1, d), params['class_embedding'],
                                 params['positional_embedding'], ln['scale'], ln['bias'])


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


@pytest.mark.parametrize('stride', [16, 32])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_embedding_matches_oadp_tpu(models, stride, dtype):
    jparams, jcfg, tparams, tcfg = models[stride]
    images = np.random.RandomState(stride).randn(3, 64, 64, 3).astype(np.float32)
    if dtype == 'bfloat16':
        jparams = {k: (v if k == 'blocks' else jnp.asarray(v, jnp.bfloat16)
                       if not isinstance(v, dict) else
                       {kk: jnp.asarray(vv, jnp.bfloat16) for kk, vv in v.items()})
                   for k, v in jparams.items()}
        tparams = tclip.map_params(tparams, lambda t: t.bfloat16())
    jx = jnp.asarray(images, jnp.bfloat16 if dtype == 'bfloat16' else jnp.float32)
    want = np.asarray(jclip._layer_norm(jclip._embed_patches(jx, jparams, jcfg),
                                        jparams['ln_pre'])).astype(np.float32)
    got = _ours(torch.from_numpy(images).to(getattr(torch, dtype)), tparams, tcfg)
    assert got.shape == (3, tcfg.tokens, 64) and got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    if dtype == 'float32':
        np.testing.assert_allclose(got, want, **TOL)
    else:
        ulp = np.maximum(_bf16_ulp(got), _bf16_ulp(want))
        assert (np.abs(got - want) <= 2 * ulp).all(), float(np.abs(got - want).max())


@pytest.mark.parametrize('stride', [16, 32])
def test_patch_rows_in_the_k_order_of_conv1(stride):
    """``patch_rows_plain(x) @ conv1.reshape(D, -1).T`` is the conv: the
    columns are ``(c, i, j)`` over the ``(D, 3, P, P)`` layout, and windows
    crossing the padding read zeros (15 before, 1 after a 224 side at the
    half stride)."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(2, 224, 224, 3).astype(np.float32))
    conv1 = torch.from_numpy(rng.randn(8, 3, 32, 32).astype(np.float32))
    pad, g = EM.patch_geometry(224, 32, stride)
    assert (pad, g) == ((15, 14) if stride == 16 else (0, 7))
    rows = EM.patch_rows_plain(x, 32, stride)
    assert rows.shape == (2 * g * g, 3072)
    want = F.conv2d(x.permute(0, 3, 1, 2), conv1, stride=stride, padding=pad)
    got = (rows.double() @ conv1.reshape(8, -1).double().T).reshape(2, g, g, 8)
    np.testing.assert_allclose(got.numpy(), want.permute(0, 2, 3, 1).numpy(), atol=1e-3)
    if stride == 16:  # the last window of a row: columns 209..240, of which 224.. pad
        r = rows.reshape(2, g, g, 3, 32, 32)
        assert torch.equal(r[:, :, -1, :, :, -1], torch.zeros_like(r[:, :, -1, :, :, -1]))
        assert torch.equal(r[0, 0, 0, :, :15], torch.zeros_like(r[0, 0, 0, :, :15]))
        assert torch.equal(r[0, 1, 1, :, 15:, 15:], x[0, 16:33, 16:33].permute(2, 0, 1))


def test_gate():
    """The kernels take the ViT-B/32 and ViT-B/16 geometries; ``ln_gemm``'s
    depth must be a multiple of 64, the width a multiple of 8 and at most
    1024 (a warp's row in registers), the crop rows 16-byte words."""
    assert EM.patch_embed_supported(32, 768, 224)
    assert EM.patch_embed_supported(16, 768, 224)  # K = 768
    assert EM.patch_embed_supported(32, 1024, 224)
    assert not EM.patch_embed_supported(14, 1024, 224)  # K = 588
    assert not EM.patch_embed_supported(32, 1280, 224)
    assert not EM.patch_embed_supported(32, 764, 224)
    assert not EM.patch_embed_supported(32, 768, 220)


def test_prepared_embedding_params(models):
    """``prepare_kernel_params`` adds ``conv1`` K-major as ``(D, 3 * P * P)``
    (the rows' K order), the product's zero bias, and ``ln_pre`` as the
    fp32 pair of the scale and bias rounded to the parameters' dtype."""
    tparams = tclip.map_params(models[16][2], lambda t: t.bfloat16())
    kern = tclip.prepare_kernel_params(tparams)['kernel']
    assert kern['conv1_wt'].is_contiguous() and kern['conv1_wt'].dtype == torch.bfloat16
    assert torch.equal(kern['conv1_wt'], tparams['conv1'].reshape(64, -1))
    assert torch.equal(kern['conv1_b'], torch.zeros(64, dtype=torch.bfloat16))
    for got, key in zip(kern['ln_pre'], ('scale', 'bias')):
        assert got.dtype == torch.float32 and got.is_contiguous()
        assert torch.equal(got, tparams['ln_pre'][key].float())


@pytest.mark.parametrize('encoder', ['stock', 'surgery'])
def test_encoders_hand_the_entries_what_the_kernels_take(models, monkeypatch, encoder):
    """With the kernels route taken (forced here, on the CPU, where each
    entry takes its plain version), both encoders hand ``patch_rows`` bf16
    crops, ``patch_embed`` contiguous 16-byte aligned rows and the prepared
    weight, ``embed_ln_pre`` the product's rows as ``(B, g * g, D)`` and the
    fp32 ``ln_pre`` pair; one call of each an encode, and the encoding is
    the plain route's."""
    stride = 32 if encoder == 'stock' else 16
    _, _, tparams, tcfg = models[stride]
    params = tclip.prepare_kernel_params(tclip.map_params(tparams, lambda t: t.bfloat16()))
    images = torch.from_numpy(np.random.RandomState(4).randn(2, 64, 64, 3)).bfloat16()
    masks = torch.from_numpy((np.random.RandomState(5).rand(2, tcfg.grid, tcfg.grid) > .5)
                             .astype(np.uint8))

    def run():
        if encoder == 'stock':
            return tclip.image_encoder(params, images, tcfg)
        return tclip.image_encoder_surgery(params, images, masks, tcfg)

    want = run()
    seen = {}

    def spy(name):
        fn = getattr(EM, name)

        def call(*a, **k):
            seen.setdefault(name, []).append((a, k))
            return fn(*a, **k)
        return call

    for name in ('patch_rows', 'patch_embed', 'embed_ln_pre'):
        monkeypatch.setattr(EM, name, spy(name))
    monkeypatch.setattr(tclip, '_embed_on_kernels', lambda images, config: True)
    got = run()
    assert {k: len(v) for k, v in seen.items()} == {
        'patch_rows': 1, 'patch_embed': 1, 'embed_ln_pre': 1}
    (crops, p, s), _ = seen['patch_rows'][0]
    assert crops.dtype == torch.bfloat16 and crops.is_contiguous() and (p, s) == (32, stride)
    (rows, wt, bias), _ = seen['patch_embed'][0]
    g = tcfg.grid
    assert rows.shape == (2 * g * g, 3072) and rows.is_contiguous()
    assert rows.data_ptr() % 16 == 0 and wt.data_ptr() % 16 == 0
    assert wt is params['kernel']['conv1_wt'] and bias is params['kernel']['conv1_b']
    (x, cls, pos, scale, b), k = seen['embed_ln_pre'][0]
    assert x.shape == (2, g * g, 64) and x.is_contiguous() and x.dtype == torch.bfloat16
    assert k['ln32'] is params['kernel']['ln_pre']
    assert pos.shape == (g * g + 1, 64)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), atol=0.05, rtol=0.05)
    cos = F.cosine_similarity(got.float(), want.float(), -1)
    assert float(cos.min()) > 0.999


def test_entries_take_the_plain_versions_on_the_cpu():
    """On a CPU tensor each entry takes its plain version and launches
    nothing."""
    EM.reset_launches()
    x = torch.zeros(1, 64, 64, 3, dtype=torch.bfloat16)
    rows = EM.patch_rows(x, 32, 16)
    assert rows.shape == (16, 3072)
    wt = torch.ones(8, 3072, dtype=torch.bfloat16)
    y = EM.patch_embed(rows, wt).view(1, 16, 8)
    out = EM.embed_ln_pre(y, torch.zeros(8), torch.zeros(17, 8), torch.ones(8), torch.zeros(8))
    assert out.shape == (1, 17, 8)
    assert EM.LAUNCHES == {'patch_rows': 0, 'patch_embed': 0, 'embed_ln_pre': 0}


@pytest.mark.parametrize('name, part', [
    ('void oadp::(anonymous namespace)::gemm_kernel<256, 0>(oadp::(anonymous namespace)::Params)',
     'ln_gemm'),
    ('_ZN4oadp12_GLOBAL__N_115pingpong_kernelILi256ELi0EEEvNS0_6ParamsE', 'ln_gemm'),
    ('_ZN4oadp12_GLOBAL__N_111gemm_kernelILi128ELi2EEEvNS0_6ParamsE', 'ln_gemm_residual'),
    ('void oadp::(anonymous namespace)::resize_crops_kernel(oadp::(anonymous '
     'namespace)::ResizeArgs)', 'resize_crops_kernel'),
    ('_ZN4oadp12_GLOBAL__N_117patch_rows_kernelEPK13__nv_bfloat16iiiiiiPS1_',
     'patch_rows_kernel'),
    ('void oadp::(anonymous namespace)::embed_ln_pre_kernel(__nv_bfloat16 const*, '
     '__nv_bfloat16 const*, __nv_bfloat16 const*, float const*, float const*, int, int, int, '
     '__nv_bfloat16*)', 'embed_ln_pre_kernel'),
])
def test_profile_parts_of_the_embedding(name, part):
    """``profile_kernels``' split of a dispatch names the two new kernels of
    ``csrc/embed.cu`` and ``resize_crops`` as parts of their own; the patch
    product is ``ln_gemm`` without epilogue by name, as kernel 1's QKV
    product is (its profiler range tells them apart)."""
    from oadp_torch import profile_kernels

    assert profile_kernels._kernel_part(name) == part


_GEMM0 = ('void oadp::(anonymous namespace)::gemm_kernel<256, 0>(oadp::(anonymous '
          'namespace)::Params)')


_ROWS = '_ZN4oadp12_GLOBAL__N_117patch_rows_kernelEPK13__nv_bfloat16iiiiiiPS1_'


class _Event:
    """A kernel of ``prof.events()``: its name, the card, its time range."""

    def __init__(self, name, start, us):
        self.name, self.device_type = name, torch.autograd.DeviceType.CUDA
        self.time_range = type('Interval', (), dict(start=start, end=start + us))()


def _dispatch_events(encoders: int, fill: bool):
    """A profile's kernels, out of launch order: per encoder a QKV product
    before the rows, the rows, a fill (``fill``), the patch product, and
    12 QKV products after it."""
    events, t = [], 0.0
    for _ in range(encoders):
        seq = [_GEMM0, _ROWS] + ['elementwise_kernel'] * fill + [_GEMM0] * 13
        for name in seq:
            events.append(_Event(name, t, 900.0 if name == _GEMM0 else 10.0))
            t += 1000.0
    return events[::-1]


@pytest.mark.parametrize('encoders, fill', [(1, False), (2, False), (1, True)])
def test_patch_product_split_after_patch_rows(encoders, fill):
    """The dispatch's split names the first ``ln_gemm`` kernel after each
    ``patch_rows_kernel`` on the card the patch product and moves it from
    ``ln_gemm`` to ``ln_gemm_patch``, leaving the QKV products before and
    after it; another count than the entry's launches raises."""
    from oadp_torch import profile_kernels as PK

    patch = PK._patch_product(_dispatch_events(encoders, fill))
    assert patch == [(_GEMM0, 0.9)] * encoders
    parts = {'ln_gemm': dict(ms=0.9 * 14 * encoders, calls=14 * encoders)}
    PK._split_patch_product(parts, patch, encoders)
    assert parts['ln_gemm']['calls'] == 13 * encoders
    assert parts['ln_gemm']['ms'] == pytest.approx(0.9 * 13 * encoders)
    assert parts['ln_gemm_patch'] == dict(ms=pytest.approx(0.9 * encoders), calls=encoders)
    with pytest.raises(RuntimeError):
        PK._split_patch_product(parts, patch, encoders + 1)


@pytest.mark.cuda
@pytest.mark.parametrize('stride, crops', [(16, 24), (32, 24), (16, 2048), (32, 16)])
def test_embedding_kernels_on_card(stride, crops):
    """The three launches against their plain versions on the card at ViT-B/32
    width: ``patch_rows`` bit for bit, the product and ``embed_ln_pre``
    (cosine >= 0.999 row by row), the whole embedding against the
    block-product route (cosine >= 0.999); one launch of each. Also at an
    objects dispatch (2048 crops at the surgery's stride 16) and a globals
    dispatch (16 at the stock stride 32)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(stride)
    cfg = tclip.ViTConfig(stride=stride)
    params = tclip.init_vit_params(torch.Generator().manual_seed(0), cfg)
    if stride != cfg.patch_size:
        params = {**params, 'positional_embedding': torch.randn(cfg.tokens, cfg.width) * 0.02}
    params = tclip.prepare_kernel_params(tclip.map_params(
        params, lambda t: t.to(device=dev, dtype=torch.bfloat16)))
    kern = params['kernel']
    images = torch.randn(crops, 224, 224, 3, device=dev, generator=gen).bfloat16()
    EM.reset_launches()
    rows = EM.patch_rows(images, 32, stride)
    assert torch.equal(rows, EM.patch_rows_plain(images, 32, stride))
    x = EM.patch_embed(rows, kern['conv1_wt'], kern['conv1_b'])
    want = EM.patch_embed_plain(rows, kern['conv1_wt'])
    assert float(F.cosine_similarity(x.float(), want.float(), -1).min()) >= 0.999
    x = x.view(crops, cfg.grid ** 2, cfg.width)
    ln = params['ln_pre']
    args = (x, params['class_embedding'], params['positional_embedding'], ln['scale'], ln['bias'])
    got = EM.embed_ln_pre(*args, ln32=kern['ln_pre'])
    torch.cuda.synchronize()
    assert EM.LAUNCHES == {'patch_rows': 1, 'patch_embed': 1, 'embed_ln_pre': 1}
    want = EM.embed_ln_pre_plain(*args)
    assert float(F.cosine_similarity(got.float(), want.float(), -1).min()) >= 0.999
    whole = tclip._embed_ln_pre(images, params, cfg)
    block = tclip._layer_norm(tclip._embed_patches(images, params, cfg), params['ln_pre'])
    assert float(F.cosine_similarity(whole.float(), block.float(), -1).min()) >= 0.999
