"""The plain versions of the port's fused layers
(``oadp_torch.ops.attention``) against the Pallas kernels of
``oadp_tpu.ops.attention`` run in interpret mode, on the same numpy
inputs in fp32 (atol 1e-4, rtol 1e-3), and the wrappers' device routing.
The CUDA kernels themselves are held against these plain versions on the
card by the ``cuda``-marked tests below (the main path's shapes and the
edge shapes of every kernel; they skip without a card)."""

import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from oadp_tpu.ops import attention as ja
from oadp_torch.ops import attention as ta

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-3)


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


def _offset_rows(rng, rows, outliers=(3, 40, 77)):
    """Rows as a CLIP residual stream carries them: a per-row offset in
    [-50, 50] and a few columns at +-100."""
    rows = rows + rng.uniform(-50, 50, rows.shape[:-1] + (1,)).astype(np.float32)
    rows[..., list(outliers)] += np.float32(100) * np.sign(
        rng.standard_normal(len(outliers))).astype(np.float32)
    return rows


def _large_mean(rng, p):
    return dict(p, x=_offset_rows(rng, p['x']), y=_offset_rows(rng, p['y']))


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


@pytest.mark.parametrize('variant', ['fold_out', 'with_main', 'side_only', 'large_mean'])
def test_surgery_layer_plain_matches_pallas(variant):
    """Each variant of the layer, and the folded layer on rows with a
    large per-row mean and outlier columns (fp32, atol 1e-4)."""
    rng = np.random.default_rng(5)
    heads = 2
    p = _layer(rng, 3, 17, heads)
    if variant == 'large_mean':
        p = _large_mean(rng, p)
    kw = dict(
        fold_out=dict(with_main=True, fold_out=True),
        with_main=dict(with_main=True),
        side_only=dict(with_main=False),
        large_mean=dict(with_main=True, fold_out=True),
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


def _ln_qkv_case(p, heads):
    """Kernel 3, Pallas in interpret mode and the port, on the same fp32
    inputs (atol 1e-4)."""
    args = [p[k] for k in ('x', 's', 't', 'w', 'wb')]
    scale = 1.0 / math.sqrt(64)
    want = ja.fused_ln_qkv_attention(
        *map(jnp.asarray, args), heads, scale, interpret=True
    )
    got = ta.fused_ln_qkv_attention(*map(torch.from_numpy, args), heads, scale)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize('b', [3, 4, 'large_mean', 'n50', 'n50_b6'])
def test_ln_qkv_attention_plain_matches_pallas(b):
    """Batches of 3 and 4, rows with a large per-row mean and outlier
    columns, and the stock encoder's N = 50 at 2 crops and at 6 (five
    crops and a ragged one, as the fused kernel's 128-row tiles cut them)
    (fp32, atol 1e-4)."""
    rng = np.random.default_rng(8)
    heads = 2
    shape = {'large_mean': (4, 13), 'n50': (2, 50), 'n50_b6': (6, 50)}.get(b, (b, 13))
    p = _layer(rng, *shape, heads)
    if b == 'large_mean':
        p = _large_mean(rng, p)
    _ln_qkv_case(p, heads)


def test_ln_qkv_attention_clamp_engages():
    """Kernel 3: logits above 80 saturate instead of overflowing, in both."""
    rng = np.random.default_rng(14)
    heads = 2
    p = _layer(rng, 2, 9, heads, w_scale=1.5)
    x = torch.from_numpy(p['x'])
    qkv = ta._proj(ta.layer_norm(x, torch.from_numpy(p['s']), torch.from_numpy(p['t'])),
                   torch.from_numpy(p['w']), torch.from_numpy(p['wb']))
    q, k = qkv[..., :64], qkv[..., 128:192]
    assert float((q @ k.transpose(-1, -2)).max()) / 8 > ta.LOGIT_CLAMP
    _ln_qkv_case(p, heads)


@pytest.mark.parametrize('n, d, fits', [
    (50, 768, True), (26, 768, True), (64, 256, True), (32, 1024, True),
    (197, 768, False), (65, 768, False), (25, 768, False), (17, 768, False),
    (50, 1088, False), (0, 768, False),
])
def test_ln_qkv_attention_route_by_shape(n, d, fits):
    """The fused kernel 3 takes the stock encoder's N = 50 and the
    sequences of at most 64 tokens whose crop slots (127 // N + 2 of them)
    fit beside two ring stages; N = 197 (the objects crops), N < 26 and
    widths past the LN pass's 1024 take the two families."""
    assert ta.ln_qkv_attention_fits(n, d) is fits


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


def _packed(rng, b, n, heads, w_scale=1.0):
    """A packed ``(B, N, 3D)`` qkv and side rows ``(B, 3D)`` as the split
    wiring makes them, with a ``(B, N)`` surgery bias."""
    d = heads * 64
    return dict(
        qkv=(rng.standard_normal((b, n, 3 * d)) * w_scale).astype(np.float32),
        qkv_y=(rng.standard_normal((b, 3 * d)) * w_scale).astype(np.float32),
        bias=np.concatenate([
            (rng.random((b, n - 1)) > 0.5).astype(np.float32) * -100.0,
            np.zeros((b, 1), np.float32),
        ], -1),
    )


@pytest.mark.parametrize('case', ['b3', 'b4', 'clamp', 'bf16'])
def test_mha_qkv_plain_matches_pallas(case):
    """Kernel 4: fp32 at a batch that takes 1 and 4 crops per Pallas grid
    cell, a case where the clamp engages, and bf16."""
    rng = np.random.default_rng(12)
    heads, n = 2, 17
    b = 3 if case == 'b3' else 4
    qkv = _packed(rng, b, n, heads, w_scale=8.0 if case == 'clamp' else 1.0)['qkv']
    scale = 1.0 / math.sqrt(64)
    if case == 'clamp':
        q, k = qkv[..., :64], qkv[..., 128:192]
        assert (q @ k.transpose(0, 2, 1)).max() * scale > ta.LOGIT_CLAMP
    if case == 'bf16':
        want = ja.fused_mha_qkv(jnp.asarray(qkv, jnp.bfloat16), heads, scale, interpret=True)
        got = ta.fused_mha_qkv(torch.from_numpy(qkv).bfloat16(), heads, scale)
        g, w = got.float().numpy(), np.asarray(want.astype(jnp.float32))
        assert np.abs(g - w).max() <= 2 ** -6 * max(1.0, np.abs(w).max())
        assert (g == w).mean() > 0.98
        return
    want = ja.fused_mha_qkv(jnp.asarray(qkv), heads, scale, interpret=True)
    got = ta.fused_mha_qkv(torch.from_numpy(qkv), heads, scale)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _side_args(p, conv, kv_only=False):
    """``k, v, qy, ky, vy, bias`` as row-strided views: k and v are column
    slices of the packed qkv (row stride 3D), or of a kv (row stride 2D)
    as in the last split layer."""
    d = p['qkv'].shape[-1] // 3
    qkv, qkv_y = conv(p['qkv']), conv(p['qkv_y'])
    kv = qkv[..., d:] if not kv_only else conv(np.ascontiguousarray(p['qkv'][..., d:]))
    k, v = kv[..., :d], kv[..., d:]
    return k, v, qkv_y[:, :d], qkv_y[:, d:2 * d], qkv_y[:, 2 * d:], conv(p['bias'])


@pytest.mark.parametrize('case', ['qkv_views', 'kv_views', 'b16', 'clamp', 'bf16'])
def test_side_attention_plain_matches_pallas(case):
    """Kernel 5 on row-strided views of a packed qkv (or kv), at batches
    of 1 and 8 crops per Pallas grid cell, with the clamp engaged, and in
    bf16."""
    rng = np.random.default_rng(13)
    heads, n = 2, 17
    b = 16 if case == 'b16' else 3
    p = _packed(rng, b, n, heads, w_scale=8.0 if case == 'clamp' else 1.0)
    kv_only = case == 'kv_views'
    if case == 'bf16':
        want = ja.fused_side_attention(*_side_args(p, lambda a: jnp.asarray(
            a, jnp.float32 if a.shape == p['bias'].shape else jnp.bfloat16)), heads, interpret=True)
        got = ta.fused_side_attention(*_side_args(p, lambda a: torch.from_numpy(a).to(
            torch.float32 if a.shape == p['bias'].shape else torch.bfloat16)), heads)
        g, w = got.float().numpy(), np.asarray(want.astype(jnp.float32))
        assert np.abs(g - w).max() <= 2 ** -6 * max(1.0, np.abs(w).max())
        assert (g == w).mean() > 0.98
        return
    want = ja.fused_side_attention(*_side_args(p, jnp.asarray, kv_only), heads, interpret=True)
    args = _side_args(p, torch.from_numpy, kv_only)
    assert args[0].stride(1) == (2 if kv_only else 3) * 128  # views, not copies
    got = ta.fused_side_attention(*args, heads)
    if case == 'clamp':
        s = (args[0][:, 1:, :64] @ args[2][:, :64, None])[..., 0] / 8 + args[5][:, :-1]
        assert float(s.max()) > ta.LOGIT_CLAMP
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gates_follow_oadp_tpu_rules(monkeypatch):
    """The port's shape gates are ``oadp_tpu``'s with its backend test
    taken as passed."""
    monkeypatch.setattr(ja, 'supports_fused_mha', lambda: True)
    for heads in (1, 2, 3, 4, 8, 12, 16):
        for hd in (16, 32, 48, 64, 80, 96, 128, 256):
            for name in ('fused_mha_qkv_supported', 'fused_side_attention_supported',
                         'fused_surgery_layer_supported'):
                assert getattr(ta, name)(heads, hd) == getattr(ja, name)(heads, hd), (
                    name, heads, hd)
    for rows in (1, 3, 7, 8, 12, 16, 999, 1000, 2048):
        for width in (64, 128, 200, 256, 768):
            assert ta.fused_ln_mlp_rows_supported(rows, width) == \
                ja.fused_ln_mlp_rows_supported(rows, width), (rows, width)


def test_launch_counters_only_count_cuda_launches():
    ta.reset_launches()
    rng = np.random.default_rng(10)
    p = _layer(rng, 2, 5, 2)
    _surgery(p, 2, ta, torch.from_numpy, with_main=False)
    q = _packed(rng, 2, 5, 2)
    ta.fused_mha_qkv(torch.from_numpy(q['qkv']), 2, 0.125)
    ta.fused_side_attention(*_side_args(q, torch.from_numpy), 2)
    x, s, w = (torch.from_numpy(p[k]) for k in ('x', 's', 'ow'))
    ta.ln_mlp_residual(x, s, s, w, s, w, s)
    ta.out_proj_residual(x, x, w, s)
    assert set(ta.LAUNCHES) == {
        'fused_surgery_layer', 'fused_ln_mlp_rows', 'fused_ln_qkv_attention',
        'fused_mha_qkv', 'fused_side_attention', 'ln_mlp_residual', 'out_proj_residual'}
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
    qkv = torch.empty((2, 5, 384), device='meta', dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        ta.fused_mha_qkv(qkv, 2, 0.125)
    rows = torch.empty((2, 128), device='meta', dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        ta.fused_side_attention(qkv[..., :128], qkv[..., 128:256], rows, rows, rows,
                                torch.empty((2, 5), device='meta'), 2)
    fc, proj = torch.empty((128, 512), device='meta'), torch.empty((512, 128), device='meta')
    with pytest.raises(ValueError):
        ta.ln_mlp_residual(x, w[:, 0], w[:, 1], fc, fc[0], proj, proj[0])
    with pytest.raises(ValueError):
        ta.out_proj_residual(x, x, w[:, :128], w[0, :128])


def _ln_gemm_walk(plan, segs, grid):
    """Every tile a consumer warpgroup of ``ln_gemm`` writes, as the kernel
    walks them (``csrc/ln_gemm.cu:gemm_body``) with ``grid`` blocks:
    ``(block, consumer, row set, first row, first column)`` of each 64-row
    tile. A block takes units ``block // cluster``, plus ``grid // cluster``
    at a time; cooperative consumers split each unit's 128 rows, ping-pong
    consumers take alternate units, and block rank ``block % 2`` of a
    ping-pong cluster the rank-th 64-row half of the unit's 128 rows."""
    cl, rows = plan.cluster, plan.rows
    bounds, walk = [], 0  # (first unit, column tiles) of each row set
    for m, n in segs:
        bounds.append((walk, -(-n // plan.tile_n)))
        walk += ta.ln_gemm_units(plan, [(m, n)])
    for block in range(grid):
        for i, unit in enumerate(range(block // cl, walk, grid // cl)):
            s = 1 if len(bounds) > 1 and unit >= bounds[1][0] else 0
            local, tiles_n = unit - bounds[s][0], bounds[s][1]
            m0 = (cl * (local // tiles_n) + block % cl) * rows
            n0 = (local % tiles_n) * plan.tile_n
            if plan.schedule == 'cooperative':
                yield from ((block, c, s, m0 + 64 * c, n0) for c in range(2))
            else:
                yield block, i % 2, s, m0, n0


_OBJ, _BLOCKS, _GLOB = 2048 * 197, 728 * 50, 16 * 50


@pytest.mark.parametrize('launch, segs, k, epilogue, plan', [
    # an objects dispatch (2048 crops of 197 tokens, the y rows riding in
    # kernel 1's launches): kernel 1's QKV, its side-only QKV (the K and V
    # columns of the x rows) and its out-projection, kernel 2's fc and
    # proj, and the x-stream MLP's fc and proj
    ('objects qkv', [(_OBJ, 2304), (2048, 2304)], 768, 0, 'cooperative256'),
    ('objects side-only qkv', [(_OBJ, 1536), (2048, 2304)], 768, 0, 'cooperative256'),
    ('objects out-projection', [(_OBJ, 768), (2048, 768)], 768, 2, 'cooperative128'),
    ('objects kernel 2 fc', [(2048, 3072)], 768, 1, 'cooperative128'),
    ('objects kernel 2 proj', [(2048, 768)], 3072, 2, 'cooperative128'),
    ('objects x-stream fc', [(_OBJ, 3072)], 768, 1, 'pingpong256'),
    ('objects x-stream proj', [(_OBJ, 768)], 3072, 2, 'cooperative256'),
    # a blocks dispatch (728 crops of 50 tokens) and a globals one (16):
    # the x-stream MLP and the stock out-projection
    ('blocks x-stream fc', [(_BLOCKS, 3072)], 768, 1, 'pingpong256'),
    ('blocks x-stream proj', [(_BLOCKS, 768)], 3072, 2, 'cooperative128'),
    ('blocks out-projection', [(_BLOCKS, 768)], 768, 2, 'cooperative128'),
    ('globals x-stream fc', [(_GLOB, 3072)], 768, 1, 'cooperative256'),
    ('globals x-stream proj', [(_GLOB, 768)], 3072, 2, 'cooperative64'),
    ('globals out-projection', [(_GLOB, 768)], 768, 2, 'cooperative64'),
    # the patch product (no LayerNorm, epilogue 0) of each dispatch: 2048
    # crops of 14 x 14 patches, 728 and 16 of 7 x 7
    ('objects patch product', [(2048 * 196, 768)], 3072, 0, 'cooperative256'),
    ('blocks patch product', [(728 * 49, 768)], 3072, 0, 'cooperative256'),
    ('globals patch product', [(16 * 49, 768)], 3072, 0, 'cooperative64'),
])
def test_ln_gemm_plan_by_launch(launch, segs, k, epilogue, plan):
    """The plan of each ``ln_gemm`` launch of the three dispatches at
    ViT-B/32 width on 132 SMs, and its walk as the kernel takes it: every
    64-row tile of every row set is written by exactly one consumer of one
    block (no plan splits K, so bias and residual are added once), and
    only the second 64-row half of a row set's last 128 rows (the second
    cooperative consumer's, or a cluster's second block's) lies past M;
    ping-pong consumers take a block's tiles in turn."""
    got = ta.ln_gemm_plan(segs, k, epilogue, 132)
    assert f'{got.schedule}{got.tile_n}' == plan
    grid = got.cluster * min(ta.ln_gemm_units(got, segs), 132 // got.cluster)
    written = {}
    for block, consumer, s, m0, n0 in _ln_gemm_walk(got, segs, grid):
        m, n = segs[s]
        assert m0 % 64 == 0 and n0 < n
        if m0 >= m:  # the second half of a row set's last 128 rows
            assert (m0 // 64) % 2 == 1 and m0 - 64 < m
            assert consumer == 1 if got.schedule == 'cooperative' else block % 2 == 1
            continue
        key = (s, m0, n0)
        assert key not in written, f'{key} written twice'
        written[key] = (block, consumer)
    assert len(written) == sum(-(-m // 64) * -(-n // got.tile_n) for m, n in segs)
    if got.schedule == 'pingpong':
        turns = {}
        for block, consumer in written.values():
            turns.setdefault(block, []).append(consumer)
        assert all(sorted(set(c)) == [0, 1] for c in turns.values())


def _card_layer(dev, b, n, heads, seed, large_mean=False):
    """A surgery layer's bf16 inputs on the card, drawn there (the objects
    dispatch's 2048 crops would take seconds in numpy): ``x, y, bias, ln
    scale, ln bias, qkv_w, qkv_b`` as :func:`_layer` scales them, with
    -100 on a random half of the patches, and the out-projection's
    ``out_w``, ``out_b``; with ``large_mean`` the rows of ``x`` and ``y``
    offset as :func:`_offset_rows` offsets them."""
    d = heads * 64
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=g) * scale

    x, y = r(b, n, d), r(b, d)
    if large_mean:
        sign = torch.randint(0, 2, (3,), device=dev, generator=g) * 2 - 1
        for t in (x, y):
            t += torch.empty(*t.shape[:-1], 1, device=dev).uniform_(-50, 50, generator=g)
            t[..., [3, 40, 77]] += 100 * sign
    mask = torch.rand(b, n - 1, device=dev, generator=g) > 0.5
    bias = torch.cat([mask.float() * -100.0, torch.zeros(b, 1, device=dev)], 1)
    args = [x.bfloat16(), y.bfloat16(), bias] + [t.bfloat16() for t in (
        r(d), r(d), r(d, 3 * d, scale=0.03), r(3 * d, scale=0.05))]
    return args, dict(out_w=r(d, d, scale=0.05).bfloat16(), out_b=r(d, scale=0.05).bfloat16())


@pytest.mark.cuda
@pytest.mark.parametrize('b', [8, 999, 2048])
def test_kernels_match_plain_on_card(b):
    """Each CUDA kernel against its plain version, bf16, on the card, at
    N = 197 and 12 heads: kernel 1 (fold_out) and kernel 2 where the fused
    wiring takes them (B % 8 == 0), kernel 4, and kernel 5 on K and V as
    views of a packed qkv (row stride 3D) and of a kv (2D); at 8 crops,
    the split wiring's 999 and the objects dispatch's 2048."""
    dev = CC.card()
    heads, n, d = 12, 197, 768
    got, want = (), ()
    if b % 8 == 0:
        args, fold = _card_layer(dev, b, n, heads, seed=b)
        got += ta.fused_surgery_layer(*args, heads, 0.125, **fold)
        want += ta.fused_surgery_layer_plain(*args, heads, 0.125, **fold)
        y, s, t = args[1], args[3], args[4]
        g = torch.Generator(device=dev).manual_seed(b + 1)
        mlp = (y, s, t) + tuple((torch.randn(*shape, device=dev, generator=g) * sc).bfloat16()
                                for shape, sc in (((d, 4 * d), d ** -0.5), ((4 * d,), 0.02),
                                                  ((4 * d, d), (4 * d) ** -0.5), ((d,), 0.02)))
        got += (ta.fused_ln_mlp_rows(*mlp),)
        want += (ta.fused_ln_mlp_rows_plain(*mlp),)
        del args, fold, mlp
    g = torch.Generator(device=dev).manual_seed(b + 2)
    qkv = torch.randn(b, n, 3 * d, device=dev, generator=g).bfloat16()
    qkv_y = torch.randn(b, 3 * d, device=dev, generator=g).bfloat16()
    mask = torch.rand(b, n - 1, device=dev, generator=g) > 0.5
    bias = torch.cat([mask.float() * -100.0, torch.zeros(b, 1, device=dev)], 1)
    got += (ta.fused_mha_qkv(qkv, heads, 0.125),)
    want += (ta.fused_mha_qkv_plain(qkv, heads, 0.125),)
    for kv in (qkv[..., d:], qkv[..., d:].contiguous()):
        args = (*kv.split(d, -1), *qkv_y.split(d, -1), bias)
        got += (ta.fused_side_attention(*args, heads),)
        want += (ta.fused_side_attention_plain(*args, heads),)
    torch.cuda.synchronize()
    for gt, w in zip(got, want):
        assert CC.compare(gt, w)[1] > 0.999


def _assert_close_on_card(got, want, atol):
    err, cos = CC.compare(got, want)
    assert cos > 0.999
    assert err <= atol


@pytest.mark.cuda
@pytest.mark.parametrize('n, b, layout', [
    (197, 5, 'qkv'), (50, 7, 'qkv'), (16, 3, 'qkv'), (197, 3, 'kv'), (50, 5, 'kv'),
])
def test_attention_main_rows_on_card(n, b, layout):
    """The ``attention`` main rows against their plain version in bf16:
    the objects (197), globals (50) and a one-tile (16) sequence, odd
    crop counts, Q/K/V as column slices of a packed qkv (row stride 3D),
    or Q on its own and K/V as slices of a kv (row stride 2D)."""
    dev = CC.card()
    heads = 4
    d = heads * 64
    rng = np.random.default_rng(20 + n + b)
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * d)).astype(np.float32)).to(dev).bfloat16()
    if layout == 'qkv':
        q, k, v = qkv.split(d, -1)
    else:
        q = qkv[..., :d].contiguous()
        k, v = qkv[..., d:].contiguous().split(d, -1)
        assert k.stride(1) == 2 * d
    out = torch.empty((b, n, d), dtype=torch.bfloat16, device=dev)
    ta._attention(q, k, v, heads, 0.125, out=out)
    want = ta._main_attention(torch.cat([q, k, v], -1), heads, 0.125)
    torch.cuda.synchronize()
    _assert_close_on_card(out, want, atol=0.02)


@pytest.mark.cuda
@pytest.mark.parametrize('b', [5, 8, 2048])
def test_attention_main_and_side_rows_on_card(b):
    """Main rows and the side row of one launch (kernel 1 without the
    out-projection), from the same staged K and V, at N = 197, up to the
    objects dispatch's 2048 crops."""
    dev = CC.card()
    heads, n = 12, 197
    args, _ = _card_layer(dev, b, n, heads, seed=30 + b)
    got = ta.fused_surgery_layer(*args, heads, 0.125)
    want = ta.fused_surgery_layer_plain(*args, heads, 0.125)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _assert_close_on_card(g, w, atol=0.05)


def _plan(spec):
    """A plan from its short name: ``auto`` (the plan function's), ``c256``
    (cooperative, 256 wide), ``p256`` (ping-pong)."""
    if spec == 'auto':
        return None
    return ta.GemmPlan('cooperative' if spec[0] == 'c' else 'pingpong', int(spec[1:]))


def _ln_gemm_want(x, w, wb, col0, epilogue, res, ln=None):
    h = ta.layer_norm(x, *ln) if ln is not None else x
    want = ta._proj(h, w[:, col0:col0 + res.shape[1]], wb[col0:col0 + res.shape[1]])
    if epilogue == 1:
        want = want * torch.sigmoid(1.702 * want)
    if epilogue == 2:
        want = res.float() + want
    return want.bfloat16()


@pytest.mark.cuda
@pytest.mark.parametrize('m, m2, k, n, epilogue, col0, ln, plan', [
    (333, 0, 768, 768, 0, 0, True, 'auto'),
    (333, 0, 768, 3072, 1, 0, True, 'auto'),
    (333, 0, 3072, 768, 2, 0, False, 'auto'),
    (2048, 0, 768, 3072, 1, 0, True, 'c128'),
    (1000, 0, 768, 2304, 0, 0, True, 'c256'),
    (130, 0, 768, 1536, 0, 768, True, 'auto'),
    (77, 0, 768, 768, 2, 0, False, 'c64'),
    # ping-pong: the globals rows (M = 800), M off both tile heights, two
    # row sets, a column slice
    (800, 0, 768, 3072, 1, 0, True, 'p256'),
    (800, 0, 768, 768, 2, 0, False, 'p256'),
    (197 * 5 + 3, 0, 768, 3072, 1, 0, True, 'p256'),
    (197 * 5 + 3, 0, 3072, 768, 2, 0, False, 'p256'),
    (77, 0, 768, 768, 0, 0, True, 'p256'),
    (77, 0, 768, 768, 2, 0, False, 'p256'),
    (130, 0, 768, 1536, 0, 768, True, 'p256'),
    (130, 0, 768, 768, 2, 768, False, 'p256'),
    (197 * 5 + 3, 130, 768, 2304, 0, 0, True, 'p256'),
    (197 * 5 + 3, 77, 768, 768, 2, 0, False, 'p256'),
    (800, 77, 768, 1536, 0, 768, True, 'p256'),
    (800, 77, 768, 1536, 0, 768, True, 'c128'),
    # every plan on the main path's few-tile or deep-K launches (K = 3072,
    # N = 768): the patch product at the globals (784 rows) and objects
    # (401,408) dispatches, the globals x-stream proj (800 rows) and kernel
    # 2's proj (2048 rows), both with the residual
    *[(rows, 0, 3072, 768, epilogue, 0, False, f'{p.schedule[0]}{p.tile_n}')
      for rows, epilogue in ((784, 0), (2048 * 196, 0), (800, 2), (2048, 2))
      for p in ta.GEMM_RATES],
])
def test_ln_gemm_on_card(m, m2, k, n, epilogue, col0, ln, plan):
    """``ln_gemm`` against its plain version in bf16: M not a multiple of
    either tile height, N = 768 and 3072 with each epilogue, a column slice
    (``col0``) of a prepared weight, each schedule and tile width, and a
    second row set (``m2`` rows, the whole weight from column
    0) in the same launch; the launch takes the plan it was given. With
    the residual epilogue the residual deltas (``out - residual``) are held
    to the plain version's too: the residual would hide a product's
    error."""
    dev = CC.card()
    gen = torch.Generator(device=dev).manual_seed(40 + m + n + m2)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    x, x2 = r(m, k).bfloat16(), r(max(m2, 1), k).bfloat16()
    w = r(k, col0 + n, scale=k ** -0.5).bfloat16()
    wb = r(col0 + n, scale=0.05).bfloat16()
    res, res2 = r(m, n).bfloat16(), r(max(m2, 1), col0 + n).bfloat16()
    lnp = (1 + r(k, scale=0.1), r(k, scale=0.1)) if ln else None
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    out2 = torch.empty((max(m2, 1), col0 + n), dtype=torch.bfloat16, device=dev)
    rows2 = (x2, out2, res2 if epilogue == 2 else None, 0) if m2 else None
    took = ta._ln_gemm(x, ta.kmajor(w), wb, out, ln32=ta.ln_fp32(*lnp) if ln else None,
                       epilogue=epilogue, residual=res if epilogue == 2 else None,
                       col0=col0, plan=_plan(plan), rows2=rows2)
    torch.cuda.synchronize()
    assert plan == 'auto' or took == _plan(plan)
    for got, x_, res_, c0 in ((out, x, res, col0),) + (((out2, x2, res2, 0),) if m2 else ()):
        want = _ln_gemm_want(x_, w, wb, c0, epilogue, res_, lnp)
        _assert_close_on_card(got, want, atol=0.05)
        if epilogue == 2:
            assert CC.compare(got.float() - res_.float(), want.float() - res_.float())[1] > 0.999


@pytest.mark.cuda
@pytest.mark.parametrize('m, n, col0, plan', [
    (197 * 5 + 3, 768, 0, 'auto'),
    (197 * 5 + 3, 768, 0, 'c256'),
    (197 * 5 + 3, 768, 0, 'c128'),
    (197 * 5 + 3, 768, 0, 'c64'),
    (197 * 5 + 3, 2304, 0, 'c256'),
    (197 * 5 + 3, 2304, 0, 'c128'),
    (130, 768, 768, 'auto'),
    (130, 768, 768, 'c64'),
    (197 * 5 + 3, 768, 0, 'p256'),
    (197 * 5 + 3, 2304, 0, 'p256'),
    (800, 768, 0, 'p256'),
    (77, 768, 0, 'p256'),
    (130, 768, 768, 'p256'),
])
def test_ln_gemm_residual_on_card(m, n, col0, plan):
    """The residual epilogue, R loaded by TMA into the staging tiles and
    added there, against its plain version in bf16: M off both tile
    heights, N = 768 and 2304, a column slice (``col0``) of a prepared
    weight, each schedule and tile width."""
    dev = CC.card()
    rng = np.random.default_rng(60 + m + n + col0 + len(plan))

    def r(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    x = r(m, 768).bfloat16()
    w = r(768, col0 + n, scale=768 ** -0.5).bfloat16()
    wb = r(col0 + n, scale=0.05).bfloat16()
    res = r(m, n).bfloat16()
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    ta._ln_gemm(x, ta.kmajor(w), wb, out, epilogue=2, residual=res, col0=col0,
                plan=_plan(plan))
    torch.cuda.synchronize()
    _assert_close_on_card(out, _ln_gemm_want(x, w, wb, col0, 2, res), atol=0.05)


@pytest.mark.cuda
@pytest.mark.parametrize('k, rows, epilogue, plan', [
    (768, 'random', 0, 'auto'),
    (768, 'large_mean', 0, 'auto'),
    (1024, 'large_mean', 0, 'auto'),
    (768, 'large_mean', 1, 'c128'),
    (1024, 'random', 0, 'c64'),
    (768, 'large_mean', 0, 'c256'),
    (1024, 'large_mean', 1, 'c256'),
    (768, 'large_mean', 1, 'p256'),
    (1024, 'large_mean', 0, 'p256'),
    (768, 'random', 1, 'p256'),
])
def test_ln_gemm_ln_rows_on_card(k, rows, epilogue, plan):
    """``ln_gemm`` with LayerNorm against the plain LN and product in bf16:
    K = 768 and 1024, rows with a per-row offset of +-50 and +-100 outlier
    columns (a CLIP residual stream), each schedule and tile width, with
    and without quick_gelu."""
    dev = CC.card()
    m, n = 197 * 5 + 3, 2304
    rng = np.random.default_rng(80 + k + len(plan) + epilogue)
    xs = rng.standard_normal((m, k)).astype(np.float32)
    if rows == 'large_mean':
        xs = _offset_rows(rng, xs)
    x = torch.from_numpy(xs).to(dev).bfloat16()

    def r(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    w = r(k, n, scale=k ** -0.5).bfloat16()
    wb = r(n, scale=0.05).bfloat16()
    lnp = (1 + r(k, scale=0.1), r(k, scale=0.1))
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    ta._ln_gemm(x, ta.kmajor(w), wb, out, ln32=ta.ln_fp32(*lnp), epilogue=epilogue,
                plan=_plan(plan))
    torch.cuda.synchronize()
    _assert_close_on_card(out, _ln_gemm_want(x, w, wb, 0, epilogue, out, lnp), atol=0.05)


@pytest.mark.cuda
@pytest.mark.parametrize('b', [5, 8, 2048])
@pytest.mark.parametrize('rows', ['random', 'large_mean'])
def test_surgery_layer_merged_rows_on_card(b, rows):
    """Kernel 1 with the y rows riding in the x rows' launches (the QKV
    product, and with ``out_w`` the out-projection), folded and side-only,
    against its plain version in bf16, on random and large-mean rows, up
    to the objects dispatch's 2048 crops; on large-mean rows the folded
    streams also within ``LARGE_MEAN_EXCESS`` beyond one bf16 unit in the
    last place, where the residual swamps the delta in a cosine."""
    dev = CC.card()
    heads, n = 12, 197
    args, kw = _card_layer(dev, b, n, heads, seed=90 + b, large_mean=rows == 'large_mean')
    ta.reset_launches()
    got = ta.fused_surgery_layer(*args, heads, 0.125, **kw)
    got += (ta.fused_surgery_layer(*args, heads, 0.125, with_main=False),)
    assert ta.LAUNCHES['fused_surgery_layer'] == 2
    want = ta.fused_surgery_layer_plain(*args, heads, 0.125, **kw)
    want += (ta.fused_surgery_layer_plain(*args, heads, 0.125, with_main=False),)
    torch.cuda.synchronize()
    # the folded streams: a bf16 step at their magnitude (~4, or ~160 with
    # the offsets); the side row is O(1)
    step = 1.0 if rows == 'large_mean' else 0.0625
    for g, w, atol in zip(got, want, (step, step, 0.05)):
        _assert_close_on_card(g, w, atol=atol)
    if rows == 'large_mean':
        assert max(CC.bf16_excess(g, w) for g, w in zip(got[:2], want[:2])) <= \
            CC.LARGE_MEAN_EXCESS


def _k3_on_card(dev, b, n, heads, rng, w_scale=0.03, large_mean=False):
    """Kernel 3's inputs on the card (bf16; fp32 LN parameters prepared
    as the encoders hold them) and its output beside the plain version's."""
    p = _layer(rng, b, n, heads, w_scale=w_scale)
    if large_mean:
        p = _large_mean(rng, p)
    x, s, t, w, wb = (torch.from_numpy(p[k]).to(dev).bfloat16()
                      for k in ('x', 's', 't', 'w', 'wb'))
    got = ta.fused_ln_qkv_attention(x, s, t, w, wb, heads, 0.125, qkv_wt=ta.kmajor(w),
                                    ln32=ta.ln_fp32(s, t))
    want = ta.fused_ln_qkv_attention_plain(x, s, t, w, wb, heads, 0.125)
    torch.cuda.synchronize()
    return got, want, (x, s, t, w, wb)


@pytest.mark.cuda
@pytest.mark.parametrize('n', [50, 32])
@pytest.mark.parametrize('b', [1, 5, 6, 16, 728])
def test_ln_qkv_attention_on_card(b, n):
    """The fused kernel 3 against its plain version in bf16: one crop,
    five, a ragged sixth, the globals batch and the blocks batch, at the
    stock encoder's N = 50 and at a short N = 32 (five crop slots, two ring
    stages)."""
    dev = CC.card()
    got, want, _ = _k3_on_card(dev, b, n, 12, np.random.default_rng(100 + b + n))
    # one bf16 step at the outputs' magnitude (2-4)
    _assert_close_on_card(got, want, atol=2 ** -5)


@pytest.mark.cuda
@pytest.mark.parametrize('case, b', [('large_mean', 16), ('large_mean', 728), ('clamp', 6)])
def test_ln_qkv_attention_edge_rows_on_card(case, b):
    """The fused kernel 3 on rows with a per-row offset of +-50 and +-100
    outlier columns (a CLIP residual stream) at the globals (16) and
    blocks (728) batches, and with logits past the clamp of 80."""
    dev = CC.card()
    rng = np.random.default_rng(120)
    if case == 'large_mean':
        got, want, _ = _k3_on_card(dev, b, 50, 12, rng, large_mean=True)
        # a bf16 step at the outputs' magnitude: below 4 at the globals
        # batch; the blocks batch's 45x more outputs reach past 4
        _assert_close_on_card(got, want, atol=0.03 if b == 16 else 2 ** -5)
        return
    got, want, (x, s, t, w, wb) = _k3_on_card(dev, b, 50, 4, rng, w_scale=0.5)
    qkv = ta._proj(ta.layer_norm(x, s, t), w, wb)
    q, k = qkv[..., :64], qkv[..., 256:320]
    assert float((q @ k.transpose(-1, -2)).max()) / 8 > ta.LOGIT_CLAMP
    # a bf16 step at the outputs' magnitude (the values of v, ~10)
    _assert_close_on_card(got, want, atol=float(want.float().abs().max()) * 2 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize('n', [50, 17, 197])
def test_ln_qkv_attention_route_on_card(n):
    """By shape: N = 50 launches the LN pass and the fused kernel and no
    product or attention kernel of the two families; N = 17 and N = 197
    launch those instead. Each matches the plain version and counts one."""
    from torch.profiler import ProfilerActivity, profile

    dev = CC.card()
    got, want, (x, s, t, w, wb) = _k3_on_card(dev, 3, n, 12, np.random.default_rng(130 + n))
    _assert_close_on_card(got, want, atol=0.03)
    prepared = dict(qkv_wt=ta.kmajor(w), ln32=ta.ln_fp32(s, t))
    torch.cuda.synchronize()
    ta.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ta.fused_ln_qkv_attention(x, s, t, w, wb, 12, 0.125, **prepared)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    fused = any('ln_qkv_attention_kernel' in k for k in names)
    families = any('gemm_kernel' in k or ('attention_kernel' in k and 'ln_qkv' not in k)
                   for k in names)
    fits = ta.ln_qkv_attention_fits(n, 768)
    assert fits == (n == 50)
    assert (fused, families) == (fits, not fits), names
    assert ta.LAUNCHES['fused_ln_qkv_attention'] == 1
