"""The fused encoder layers' x-stream MLP and the stock encoder's
out-projection on ``ln_gemm`` (``oadp_torch.ops.attention``:
``ln_mlp_residual``, ``out_proj_residual``): the plain versions against
``oadp_tpu``'s XLA code (``x + _mlp(_layer_norm(x))`` and ``x + a @ out_w
+ out_b``) on the same numpy inputs, fp32 on the CPU at D = 128, hidden
512, 8 x 197 rows (atol 1e-4); the encoders' wiring by the entries' call
counts at 12 layers; and, ``cuda``-marked (they skip without a card),
both kernel routes against their plain versions on the card at the
objects (2048 x 197), blocks (728 x 50) and globals (16 x 50) shapes of
ViT-B/32, and on rows with a large mean by the bf16 excess of
``tests/card_checks.py``, which a dropped or wrong MLP fails (shown on the
CPU)."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from oadp_tpu.models import clip as jclip
from oadp_torch.models import clip as tclip
from oadp_torch.ops import attention as ta

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=0)
D, HIDDEN = 128, 512


def _sibling(name: str):
    """A module of this directory, loaded by path: on a host where an
    installed package is also called ``tests``, ``import tests.x`` finds
    that one (this directory has no ``__init__.py``)."""
    spec = importlib.util.spec_from_file_location(f'_{name}', pathlib.Path(__file__).with_name(
        f'{name}.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CC = _sibling('card_checks')


def _mlp_case(rng, shape):
    return dict(
        x=rng.standard_normal(shape).astype(np.float32),
        s=(1 + 0.1 * rng.standard_normal(D)).astype(np.float32),
        t=(0.1 * rng.standard_normal(D)).astype(np.float32),
        fc_w=(rng.standard_normal((D, HIDDEN)) * D ** -0.5).astype(np.float32),
        fc_b=(0.05 * rng.standard_normal(HIDDEN)).astype(np.float32),
        proj_w=(rng.standard_normal((HIDDEN, D)) * HIDDEN ** -0.5).astype(np.float32),
        proj_b=(0.05 * rng.standard_normal(D)).astype(np.float32),
    )


@pytest.mark.parametrize('layout', ['tokens', 'rows', 'large_mean'])
def test_ln_mlp_residual_plain_matches_oadp_tpu(layout):
    """``(B, N, D)`` tokens, flat ``(M, D)`` rows, and tokens with a large
    per-row mean and outlier columns, as CLIP residual streams carry."""
    rng = np.random.default_rng(40)
    c = _mlp_case(rng, (8 * 197, D) if layout == 'rows' else (8, 197, D))
    if layout == 'large_mean':
        c['x'] = c['x'] + rng.uniform(-50, 50, (8, 197, 1)).astype(np.float32)
        c['x'][..., [3, 40, 77]] += np.float32(100)
    mlp = {k: jnp.asarray(c[k]) for k in ('fc_w', 'fc_b', 'proj_w', 'proj_b')}
    x = jnp.asarray(c['x'])
    want = x + jclip._mlp(jclip._layer_norm(
        x, {'scale': jnp.asarray(c['s']), 'bias': jnp.asarray(c['t'])}), mlp)
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    args = (t['x'], t['s'], t['t'], t['fc_w'], t['fc_b'], t['proj_w'], t['proj_b'])
    got = ta.ln_mlp_residual(*args)
    assert torch.equal(got, ta.ln_mlp_residual_plain(*args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize('layout', ['tokens', 'rows'])
def test_out_proj_residual_plain_matches_oadp_tpu(layout):
    rng = np.random.default_rng(41)
    shape = (8 * 197, D) if layout == 'rows' else (8, 197, D)
    x, a = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    w = (rng.standard_normal((D, D)) * D ** -0.5).astype(np.float32)
    b = (0.05 * rng.standard_normal(D)).astype(np.float32)
    want = jnp.asarray(x) + (jnp.asarray(a) @ jnp.asarray(w) + jnp.asarray(b))
    got = ta.out_proj_residual(*map(torch.from_numpy, (x, a, w, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cpu_entries_keep_clip_rounding_in_bf16():
    """On the CPU in bf16 the entries compute ``models/clip.py``'s
    expressions bit for bit (each product rounded, quick_gelu on the
    rounded hidden), and count no launch."""
    rng = np.random.default_rng(42)
    c = {k: torch.from_numpy(v).bfloat16() for k, v in _mlp_case(rng, (4, 50, D)).items()}
    block = {'ln_2': {'scale': c['s'], 'bias': c['t']},
             'mlp': {k: c[k] for k in ('fc_w', 'fc_b', 'proj_w', 'proj_b')}}
    ta.reset_launches()
    got = ta.ln_mlp_residual(c['x'], c['s'], c['t'], c['fc_w'], c['fc_b'], c['proj_w'],
                             c['proj_b'])
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, c['x'] + tclip._mlp(tclip._layer_norm(c['x'], block['ln_2']),
                                                block['mlp']))
    a, w = c['x'].flip(0), c['fc_w'][:, :D]
    assert torch.equal(ta.out_proj_residual(c['x'], a, w, c['s']), c['x'] + (a @ w + c['s']))
    assert ta.LAUNCHES == {k: 0 for k in ta.LAUNCHES}


@pytest.mark.parametrize('encoder, width, batch, calls', [
    ('surgery', 128, 8, (11, 0)),  # fused wiring: every layer but the last
    ('surgery', 128, 3, (0, 0)),  # split wiring (B % 8 != 0): _mlp
    ('stock', 128, 3, (12, 12)),  # kernel 3's blocks
    ('stock', 64, 3, (0, 0)),  # _block (D % 128 != 0)
])
def test_encoder_wiring_calls_the_entries(monkeypatch, encoder, width, batch, calls):
    """Calls of ``ln_mlp_residual`` and ``out_proj_residual`` in one encode
    at 12 layers, by wiring."""
    cfg = tclip.ViTConfig(image_size=64, patch_size=16, stride=16, width=width, layers=12,
                          heads=width // 64, output_dim=32)
    params = tclip.init_vit_params(torch.Generator().manual_seed(0), cfg)
    counts = {'ln_mlp_residual': 0, 'out_proj_residual': 0}
    for name in counts:
        def counted(*a, _fn=getattr(ta, name), _name=name, **k):
            counts[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(ta, name, counted)
    rng = np.random.RandomState(3)
    images = torch.from_numpy(rng.randn(batch, 64, 64, 3).astype(np.float32))
    if encoder == 'stock':
        out = tclip.image_encoder(params, images, cfg)
    else:
        params, cfg = tclip.upsample_vit_params(params, cfg)
        masks = torch.from_numpy((rng.rand(batch, cfg.grid, cfg.grid) > 0.5).astype(np.uint8))
        out = tclip.image_encoder_surgery(params, images, masks, cfg)
    assert out.shape == (batch, 32) and torch.isfinite(out).all()
    assert (counts['ln_mlp_residual'], counts['out_proj_residual']) == calls


# ---------------------------------------------------------------------------
# On the card (skipped without one): the kernel routes against their plain
# versions at ViT-B/32's shapes, bf16
# ---------------------------------------------------------------------------

SHAPES = {'objects': (2048, 197), 'blocks': (728, 50), 'globals': (16, 50)}


def _card_weights(dev, gen, d=768):
    def r(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen) * scale).bfloat16()

    return dict(s=1 + r(d, scale=0.1), t=r(d, scale=0.1),
                fc_w=r(d, 4 * d, scale=d ** -0.5), fc_b=r(4 * d, scale=0.02),
                proj_w=r(4 * d, d, scale=(4 * d) ** -0.5), proj_b=r(d, scale=0.02),
                out_w=r(d, d, scale=d ** -0.5), out_b=r(d, scale=0.02))


def _large_mean(x, rng):
    """``x`` with a per-row offset in [-50, 50] and column 3 at +100."""
    x = x + rng(x.shape[:-1] + (1,))
    x[..., 3] += 100
    return x


@pytest.mark.parametrize('fault', [None, 'dropped_mlp', 'mlp_off_by_a_fifth'])
def test_large_mean_gate_sees_the_mlp(fault):
    """``bf16_excess`` on rows with a large mean: the kernel's
    rounding (the LN pass and the hidden written in bf16, quick_gelu and
    both products in fp32, one rounding of ``x + delta``) stays within
    ``LARGE_MEAN_EXCESS`` of the bf16 plain version; an MLP dropped, or
    off by a fifth, does not, though its output keeps a cosine >= 0.999."""
    rng = np.random.default_rng(11)
    c = _mlp_case(rng, (8, 197, D))
    x = _large_mean(torch.from_numpy(c['x']),
                    lambda shape: torch.from_numpy(rng.uniform(-50, 50, shape).astype(np.float32)))
    x = x.bfloat16()
    w = {k: torch.from_numpy(v).bfloat16() for k, v in c.items() if k != 'x'}
    want = ta.ln_mlp_residual_plain(x, w['s'], w['t'], w['fc_w'], w['fc_b'],
                                    w['proj_w'], w['proj_b'])
    f = {k: v.float() for k, v in w.items()}
    ln = torch.nn.functional.layer_norm(x.float(), (D,), f['s'], f['t'], 1e-5).bfloat16()
    h = ln.float() @ f['fc_w'] + f['fc_b']
    h = (h * torch.sigmoid(1.702 * h)).bfloat16()
    delta = h.float() @ f['proj_w'] + f['proj_b']
    share = {None: 1.0, 'dropped_mlp': 0.0, 'mlp_off_by_a_fifth': 0.8}[fault]
    got = (x.float() + share * delta).bfloat16()
    excess = CC.bf16_excess(got, want)
    if fault is None:
        assert excess <= CC.LARGE_MEAN_EXCESS
    else:
        assert CC.compare(got, want)[1] >= 0.999
        assert excess > CC.LARGE_MEAN_EXCESS


@pytest.mark.cuda
@pytest.mark.parametrize('rows', ['random', 'large_mean'])
@pytest.mark.parametrize('shape', ['objects', 'blocks', 'globals'])
def test_ln_mlp_residual_on_card(shape, rows):
    """The three launches against the plain version (cosine >= 0.999 of
    the outputs, row by row; on random rows also of their residual
    deltas, on large-mean rows within ``LARGE_MEAN_EXCESS``
    beyond one bf16 unit in the last place), with the prepared weights
    and with copies made per call; one launch counted per call."""
    dev = CC.card()
    gen = torch.Generator(device=dev).manual_seed(7)
    w = _card_weights(dev, gen)
    b, n = SHAPES[shape]
    x = torch.randn(b, n, 768, device=dev, generator=gen)
    if rows == 'large_mean':
        x = _large_mean(x, lambda shape: torch.empty(shape, device=dev).uniform_(
            -50, 50, generator=gen))
    x = x.bfloat16()
    args = (x, w['s'], w['t'], w['fc_w'], w['fc_b'], w['proj_w'], w['proj_b'])
    prepared = dict(fc_wt=ta.kmajor(w['fc_w']), proj_wt=ta.kmajor(w['proj_w']),
                    ln32=ta.ln_fp32(w['s'], w['t']))
    ta.reset_launches()
    got = ta.ln_mlp_residual(*args, **prepared)
    again = ta.ln_mlp_residual(*args)
    torch.cuda.synchronize()
    assert ta.LAUNCHES['ln_mlp_residual'] == 2
    assert torch.equal(got, again)
    want = ta.ln_mlp_residual_plain(*args)
    assert CC.compare(got, want)[1] >= 0.999
    if rows == 'random':
        assert CC.compare(got.float() - x.float(), want.float() - x.float())[1] >= 0.999
    else:  # the output's rounding swamps the delta: held beyond it
        assert CC.bf16_excess(got, want) <= CC.LARGE_MEAN_EXCESS


@pytest.mark.cuda
@pytest.mark.parametrize('shape', ['objects', 'blocks', 'globals'])
def test_out_proj_residual_on_card(shape):
    dev = CC.card()
    gen = torch.Generator(device=dev).manual_seed(8)
    w = _card_weights(dev, gen)
    b, n = SHAPES[shape]
    x, a = (torch.randn(b, n, 768, device=dev, generator=gen).bfloat16() for _ in range(2))
    ta.reset_launches()
    got = ta.out_proj_residual(x, a, w['out_w'], w['out_b'], out_wt=ta.kmajor(w['out_w']))
    torch.cuda.synchronize()
    assert ta.LAUNCHES['out_proj_residual'] == 1
    want = ta.out_proj_residual_plain(x, a, w['out_w'], w['out_b'])
    assert CC.compare(got, want)[1] >= 0.999
    assert CC.compare(got.float() - x.float(), want.float() - x.float())[1] >= 0.999


@pytest.mark.parametrize('name, part', [
    ('void oadp::(anonymous namespace)::gemm_kernel<256, 1>(oadp::(anonymous namespace)::Params)',
     'ln_gemm_gelu'),
    ('_ZN4oadp12_GLOBAL__N_111gemm_kernelILi128ELi2EEEvNS0_6ParamsE', 'ln_gemm_residual'),
    ('void oadp::(anonymous namespace)::gemm_kernel<64, 0>(oadp::(anonymous namespace)::Params)',
     'ln_gemm'),
    ('void oadp::(anonymous namespace)::pingpong_kernel<256, 1>(oadp::(anonymous '
     'namespace)::Params)', 'ln_gemm_gelu'),
    ('_ZN4oadp12_GLOBAL__N_115pingpong_kernelILi256ELi2EEEvNS0_6ParamsE', 'ln_gemm_residual'),
    ('void oadp::(anonymous namespace)::pingpong_kernel<256, 0>(oadp::(anonymous '
     'namespace)::Params)', 'ln_gemm'),
    ('void oadp::layer_norm_kernel(__nv_bfloat16 const*, int, __nv_bfloat16 const*, int, int)',
     'layer_norm_kernel'),
    ('void oadp::(anonymous namespace)::ln_qkv_attention_kernel<3>(oadp::Params)',
     'ln_qkv_attention_kernel'),
    ('void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<c10::BFloat16, '
     'float>(int, float, c10::BFloat16 const*)', 'torch_layer_norm'),
    ('sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x256x64_warpgroupsize2x1x1',
     'cublas_gemm'),
    ('nvjet_tst_192x192_64x3_2x1_v_bz_coopB_bias_NNN', 'cublas_gemm'),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::sigmoid_kernel_cuda',
     'torch_elementwise'),
])
def test_profile_parts_by_kernel_name(name, part):
    """``profile_kernels``' split of a dispatch by part: the port's kernels
    (``ln_gemm``'s two schedules by epilogue, the LN pass) apart from
    PyTorch's cuBLAS, LayerNorm and elementwise kernels of the same
    names."""
    from oadp_torch import profile_kernels

    assert profile_kernels._kernel_part(name) == part
