"""The plain versions of the port's fused layers
(``oadp_torch.ops.attention``) against the Pallas kernels of
``oadp_tpu.ops.attention`` run in interpret mode, on the same numpy
inputs in fp32 (atol 1e-4, rtol 1e-3), and the wrappers' device routing.
The CUDA kernels themselves are held against these plain versions on the
card by ``chip_smoke.py`` and by the ``cuda``-marked test below."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from oadp_tpu.ops import attention as ja
from oadp_torch.ops import attention as ta

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-3)


def _layer(rng, b, n, heads, hd=64, w_scale=0.05):
    d = heads * hd
    return dict(
        x=rng.standard_normal((b, n, d)).astype(np.float32),
        y=rng.standard_normal((b, d)).astype(np.float32),
        bias=np.concatenate([
            (rng.random((b, n - 1)) > 0.5).astype(np.float32) * -100.0,
            np.zeros((b, 1), np.float32),
        ], -1),
        s=rng.standard_normal(d).astype(np.float32),
        t=rng.standard_normal(d).astype(np.float32),
        w=(rng.standard_normal((d, 3 * d)) * w_scale).astype(np.float32),
        wb=(rng.standard_normal(3 * d) * 0.05).astype(np.float32),
        ow=(rng.standard_normal((d, d)) * 0.05).astype(np.float32),
        ob=(rng.standard_normal(d) * 0.05).astype(np.float32),
    )


def _surgery(p, heads, mod, conv, **kw):
    args = [conv(p[k]) for k in ('x', 'y', 'bias', 's', 't', 'w', 'wb')]
    extra = {}
    if kw.pop('fold_out', False):
        extra = dict(out_w=conv(p['ow']), out_b=conv(p['ob']))
    if mod is ja:
        kw['interpret'] = True
    return mod.fused_surgery_layer(
        *args, heads, 1.0 / math.sqrt(64), **kw, **extra
    )


@pytest.mark.parametrize('variant', ['fold_out', 'with_main', 'side_only'])
def test_surgery_layer_plain_matches_pallas(variant):
    rng = np.random.default_rng(5)
    heads = 2
    p = _layer(rng, 3, 17, heads)
    kw = dict(
        fold_out=dict(with_main=True, fold_out=True),
        with_main=dict(with_main=True),
        side_only=dict(with_main=False),
    )[variant]
    want = _surgery(p, heads, ja, jnp.asarray, **dict(kw))
    got = _surgery(p, heads, ta, torch.from_numpy, **dict(kw))
    if variant == 'side_only':
        want, got = (want,), (got,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_surgery_layer_clamp_engages():
    """Logits above 80 saturate instead of overflowing, in both."""
    rng = np.random.default_rng(6)
    heads = 2
    p = _layer(rng, 2, 9, heads, w_scale=1.5)
    want = _surgery(p, heads, ja, jnp.asarray, with_main=True, fold_out=True)
    got = _surgery(p, heads, ta, torch.from_numpy, with_main=True, fold_out=True)
    # the clamp is reached: recompute the largest main-stream logit
    x = torch.from_numpy(p['x'])
    qkv = ta._proj(ta.layer_norm(x, torch.from_numpy(p['s']), torch.from_numpy(p['t'])),
                   torch.from_numpy(p['w']), torch.from_numpy(p['wb']))
    q, k = qkv[..., :64], qkv[..., 128:192]
    assert float((q @ k.transpose(-1, -2)).max()) / 8 > ta.LOGIT_CLAMP
    for g, w in zip(got, want):
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize('rows', [13, 16])
def test_ln_mlp_rows_plain_matches_pallas(rows):
    rng = np.random.default_rng(7)
    d = 128
    arrays = [
        rng.standard_normal((rows, d)),
        rng.standard_normal(d), rng.standard_normal(d),
        rng.standard_normal((d, 4 * d)) * 0.05, rng.standard_normal(4 * d) * 0.05,
        rng.standard_normal((4 * d, d)) * 0.05, rng.standard_normal(d) * 0.05,
    ]
    arrays = [a.astype(np.float32) for a in arrays]
    want = ja.fused_ln_mlp_rows(*map(jnp.asarray, arrays), interpret=True)
    got = ta.fused_ln_mlp_rows(*map(torch.from_numpy, arrays))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize('b', [3, 4])
def test_ln_qkv_attention_plain_matches_pallas(b):
    rng = np.random.default_rng(8)
    heads, n = 2, 13
    p = _layer(rng, b, n, heads)
    args = [p[k] for k in ('x', 's', 't', 'w', 'wb')]
    scale = 1.0 / math.sqrt(64)
    want = ja.fused_ln_qkv_attention(
        *map(jnp.asarray, args), heads, scale, interpret=True
    )
    got = ta.fused_ln_qkv_attention(*map(torch.from_numpy, args), heads, scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bf16_plain_matches_pallas():
    """In bf16 the plain version rounds where the Pallas body rounds."""
    rng = np.random.default_rng(9)
    heads = 2
    p = _layer(rng, 2, 17, heads)
    want = _surgery(p, heads, ja, lambda a: jnp.asarray(a).astype(
        jnp.float32 if a.ndim == 2 and a.shape[-1] == 17 else jnp.bfloat16
    ), with_main=True, fold_out=True)
    got = _surgery(p, heads, ta, lambda a: torch.from_numpy(a).to(
        torch.float32 if a.ndim == 2 and a.shape[-1] == 17 else torch.bfloat16
    ), with_main=True, fold_out=True)
    for g, w in zip(got, want):
        g = g.float().numpy()
        w = np.asarray(w.astype(jnp.float32))
        # one bf16 ulp at the streams' magnitude, for rare rounding splits
        assert np.abs(g - w).max() <= 0.07
        assert (g == w).mean() > 0.98


def test_launch_counters_only_count_cuda_launches():
    ta.reset_launches()
    rng = np.random.default_rng(10)
    p = _layer(rng, 2, 5, 2)
    _surgery(p, 2, ta, torch.from_numpy, with_main=False)
    assert ta.LAUNCHES == {k: 0 for k in ta.LAUNCHES}


def test_wrappers_refuse_non_bf16_on_other_devices():
    """A tensor that is not on the CPU goes to the kernel or raises: a
    ``meta`` tensor is neither, so the wrapper's checks must refuse it."""
    x = torch.empty((2, 5, 128), device='meta')
    w = torch.empty((128, 384), device='meta')
    with pytest.raises(ValueError):
        ta.fused_ln_qkv_attention(
            x, w[:, 0], w[:, 1], w, w[0], 2, 0.125
        )


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """Each CUDA kernel against its plain version, bf16, on the card."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device; chip_smoke.py runs the full check')
    rng = np.random.default_rng(11)
    dev = torch.device('cuda')
    heads, b, n = 12, 8, 197
    p = _layer(rng, b, n, heads, w_scale=0.03)

    def conv(a):
        t = torch.from_numpy(a).to(dev)
        return t if (a.ndim == 2 and a.shape == (b, n)) else t.bfloat16()

    args = [conv(p[k]) for k in ('x', 'y', 'bias', 's', 't', 'w', 'wb')]
    kw = dict(out_w=conv(p['ow']), out_b=conv(p['ob']))
    got = ta.fused_surgery_layer(*args, heads, 0.125, **kw)
    want = ta.fused_surgery_layer_plain(*args, heads, 0.125, **kw)
    for g, w in zip(got, want):
        cos = torch.nn.functional.cosine_similarity(
            g.float().flatten(1), w.float().flatten(1)
        )
        assert float(cos.min()) > 0.999
