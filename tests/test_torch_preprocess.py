"""The port's preprocessing (``oadp_torch.ops.preprocess``) against
``oadp_tpu.ops.preprocess`` on the same numpy inputs: host and device
coefficients bit-identical, the fp32 resize bit-identical, the bf16
single-pass resize within 2 uint8 steps; ``resize_crops``' plain version
(the bf16 crops of the objects and globals steps in one call) identical to
``oadp_tpu``'s bf16 ``prep_one`` + ``normalize_clip`` on pixels, and a
float32 numpy model of its kernel's tap prologue, in the kernel's order
with no FMA, bit-identical to both packages' ``device_coeffs``.

The fp32 resize sums up to ``pad`` rounded fp32 products. The port's CPU
path takes them in the order of XLA's CPU dot; any other order moves a
value that lands within an ulp of a .5 tie to the neighbouring uint8
(a CPU GEMM did so for 5 of the 1.8M values here)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from oadp_tpu.ops import preprocess as jpp
from oadp_torch.ops import preprocess as tpp

torch.set_num_threads(1)

PAD = 320


@pytest.fixture(scope='module')
def case():
    rng = np.random.RandomState(0)
    h, w = 240, 300
    image = rng.randint(0, 256, (h, w, 3)).astype(np.float32)
    padded = np.zeros((PAD, PAD, 3), np.float32)
    padded[:h, :w] = image
    n = 12
    sides = rng.uniform(16, 260, n)
    x0 = rng.uniform(-20, w - 16, n)
    y0 = rng.uniform(-20, h - 16, n)
    boxes = np.stack([x0, y0, x0 + sides, y0 + sides * 1.1], -1)
    boxes[0] = [0, 0, 224, 224]  # identity crop
    meta = tpp.clip_transform_meta(w, h, boxes)
    k = tpp.coeff_ksize(float(sides.max() * 1.1))
    return padded, meta, k


def test_host_part_is_a_copy():
    boxes = np.asarray([[5.5, 3.2, 101.7, 99.0], [0, 0, 300, 240]])
    np.testing.assert_array_equal(
        tpp.clip_transform_meta(300, 240, boxes),
        jpp.clip_transform_meta(300, 240, boxes),
    )
    for args in ((300.0, 0.0, 300.0, 224), (97.0, 0.0, 97.0, 250)):
        for a, b in zip(tpp.resample_coeffs(*args), jpp.resample_coeffs(*args)):
            np.testing.assert_array_equal(a, b)
    assert tpp.coeff_ksize(640 * 2.8) == jpp.coeff_ksize(640 * 2.8)
    assert tpp.CLIP_MEAN == jpp.CLIP_MEAN and tpp.CLIP_STD == jpp.CLIP_STD


def test_device_coeffs_bit_identical(case):
    _, meta, k = case
    ours = tpp.device_coeffs(torch.from_numpy(meta), k)
    ref = jpp.device_coeffs(jnp.asarray(meta), k)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_expand_coeffs_bit_identical(case):
    _, meta, k = case
    wx_w, wx_s, _, _ = jpp.device_coeffs(jnp.asarray(meta), k)
    ours = tpp.expand_coeffs(
        torch.from_numpy(np.array(wx_w)), torch.from_numpy(np.array(wx_s)), PAD
    )
    ref = jpp.expand_coeffs(wx_w, wx_s, PAD)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_fp32_resize_matches(case):
    padded, meta, k = case
    coeffs = [np.array(a) for a in jpp.device_coeffs(jnp.asarray(meta), k)]
    ref = np.asarray(jpp.apply_resize_coeffs(jnp.asarray(padded), *coeffs))
    ours = tpp.apply_resize_coeffs(
        torch.from_numpy(padded), *(torch.from_numpy(c) for c in coeffs)
    ).numpy()
    assert ours.shape == (len(meta), 224, 224, 3)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(
        tpp.normalize_clip(torch.from_numpy(ref)).numpy(),
        np.asarray(jpp.normalize_clip(jnp.asarray(ref))),
    )


def test_bf16_resize_within_two_steps(case):
    padded, meta, k = case
    coeffs = [np.array(a) for a in jpp.device_coeffs(jnp.asarray(meta), k)]
    ref = np.asarray(jpp.apply_resize_coeffs(
        jnp.asarray(padded), *coeffs, compute_dtype=jnp.bfloat16
    ))
    ours = tpp.apply_resize_coeffs(
        torch.from_numpy(padded), *(torch.from_numpy(c) for c in coeffs),
        compute_dtype=torch.bfloat16,
    ).numpy()
    assert np.abs(ours - ref).max() <= 2.0


@pytest.mark.parametrize('layout', ['single', 'paired'])
def test_resize_pair_layouts(case, layout):
    padded, meta, k = case
    wx_w, wx_s, wy_w, wy_s = jpp.device_coeffs(jnp.asarray(meta[:3]), k)
    wx = np.array(jpp.expand_coeffs(wx_w, wx_s, PAD))
    wy = np.array(jpp.expand_coeffs(wy_w, wy_s, PAD))
    image = padded if layout == 'single' else np.stack([padded] * 3)
    ref = np.asarray(jpp.apply_resize_pair(
        jnp.asarray(image), jnp.asarray(wx), jnp.asarray(wy)
    ))
    ours = tpp.apply_resize_pair(
        torch.from_numpy(image), torch.from_numpy(wx), torch.from_numpy(wy)
    ).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)


def test_plain_resize_matrices_are_a_copy():
    for args in ((300, 240, 200, 160, PAD, PAD), (224, 232, 149, 154, 256, 300)):
        for a, b in zip(tpp.plain_resize_matrices(*args),
                        jpp.plain_resize_matrices(*args)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('pad', [PAD, 640])
def test_pyramid_level_resize_matches(case, pad):
    """A blocks pyramid level: paired images, dense ``(pad, pad)`` level
    matrices (rows past the level's size are zero), fp32, bit-identical."""
    padded = np.zeros((pad, pad, 3), np.float32)
    padded[:PAD, :PAD] = case[0]
    images = np.stack([padded, padded[:, ::-1].copy()])
    wx = np.zeros((2, pad, pad), np.float32)
    wy = np.zeros((2, pad, pad), np.float32)
    for i, (w1, h1) in enumerate(((200, 160), (133, 106))):
        wx[i, :w1], wy[i, :h1] = tpp.plain_resize_matrices(300, 240, w1, h1, pad, pad)
    ref = np.asarray(jpp.apply_resize_pair(*map(jnp.asarray, (images, wx, wy))))
    ours = tpp.apply_resize_pair(*map(torch.from_numpy, (images, wx, wy))).numpy()
    np.testing.assert_array_equal(ours, ref)


# ---------------------------------------------------------------------------
# resize_crops: the bf16 crops of a dispatch in one launch
# ---------------------------------------------------------------------------


def _jax_crops(image, meta, k):
    """``oadp_tpu``'s bf16 ``prep_one`` (``oake/encoders.py``) on one
    source image: pixels in [0, 255] before normalisation."""
    coeffs = jpp.device_coeffs(jnp.asarray(meta), k)
    return np.asarray(jpp.apply_resize_coeffs(
        jnp.asarray(image.astype(np.float32)), *coeffs, compute_dtype=jnp.bfloat16))


def _plain_pixels(images, meta, k):
    """``resize_crops_plain``'s pixels: normalized with mean 0 and std 1,
    which bf16 holds exactly for integers up to 256."""
    out = tpp.resize_crops_plain(torch.from_numpy(images), torch.from_numpy(meta), k,
                                 (0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
    return out.float().numpy()


def _image(rng, h=240, w=300, pad=PAD):
    padded = np.zeros((pad, pad, 3), np.uint8)
    padded[:h, :w] = rng.randint(0, 256, (h, w, 3))
    return padded


def _boxes(kind, rng, n=10, h=240, w=300):
    if kind == 'identity':  # 224-wide crops: PIL skips the resample
        x0, y0 = rng.randint(-30, w - 200, n), rng.randint(-30, h - 200, n)
        return np.stack([x0, y0, x0 + 224, y0 + 224], -1).astype(np.float64)
    if kind == 'past_edges':  # every edge crossed, and crops wholly outside
        return np.asarray([[-40, -30, w + 35, h + 20], [-80.4, 10, 20, 90],
                           [w - 10, h - 5, w + 60, h + 70], [-50, -50, -5, -2],
                           [w + 3, 5, w + 90, 80], [100, -60, 180, h + 60]], np.float64)
    if kind == 'one_pixel_wide':
        x0, y0 = rng.uniform(0, w - 2, n), rng.uniform(0, h - 100, n)
        return np.stack([x0, y0, x0 + 1.0, y0 + rng.uniform(20, 90, n)], -1)
    sides = rng.uniform(8, 260, n)  # random, and the largest k_pad's scales
    x0, y0 = rng.uniform(-20, w - 16, n), rng.uniform(-20, h - 16, n)
    boxes = np.stack([x0, y0, x0 + sides, y0 + sides * rng.uniform(0.5, 2, n)], -1)
    if kind == 'largest_k':  # the CLI's worst case, a sqrt(8)-expanded 640 side: 35 taps
        side = np.sqrt(8.0) * 640 * np.asarray([1.0, 0.9, 0.8])
        boxes[:3] = np.stack([w / 2 - side / 2, h / 2 - side / 2,
                              w / 2 + side / 2, h / 2 + side * 0.6], -1)
    return boxes


@pytest.mark.parametrize('kind', ['identity', 'past_edges', 'one_pixel_wide', 'random',
                                  'largest_k'])
def test_resize_crops_plain_matches_oadp_tpu(kind):
    """Pixels identical to ``oadp_tpu``'s bf16 route before normalisation
    (the products are exact, so only the sums' order could differ; none of
    these pixels moves), and the normalized crops identical to its
    ``normalize_clip(..., bfloat16)``."""
    rng = np.random.RandomState(['identity', 'past_edges', 'one_pixel_wide', 'random',
                                 'largest_k'].index(kind))
    image = _image(rng)
    meta = tpp.clip_transform_meta(300, 240, _boxes(kind, rng))
    if kind == 'identity':
        assert (meta[:, 8] == 1).all()
    k = 35 if kind == 'largest_k' else tpp.coeff_ksize(
        float(np.maximum(meta[:, 2] / meta[:, 4], meta[:, 3] / meta[:, 5]).max() * 224))
    if kind == 'largest_k':
        assert tpp.coeff_ksize(np.sqrt(8.0) * 640) == 35
        assert tpp.coeff_ksize(float(meta[0, 2] / meta[0, 4] * 224)) == 35
    want = _jax_crops(image, meta, k)
    got = _plain_pixels(image, meta, k)
    assert got.shape == want.shape == (len(meta), 224, 224, 3)
    np.testing.assert_array_equal(got, want)
    normed = tpp.resize_crops_plain(torch.from_numpy(image), torch.from_numpy(meta), k)
    assert normed.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        normed.float().numpy(),
        np.asarray(jpp.normalize_clip(jnp.asarray(want), jnp.bfloat16)).astype(np.float32))


def test_resize_crops_plain_groups_and_pairs():
    """G = 2 chunks in one call equal two single-chunk calls (``objects_
    packed_step``'s one launch); paired images, a crop each (``globals_
    step``), equal ``oadp_tpu``'s paired bf16 resize."""
    rng = np.random.RandomState(7)
    images = np.stack([_image(rng), _image(rng)])
    metas = [tpp.clip_transform_meta(300, 240, _boxes('random', rng, 6)) for _ in range(2)]
    k = 21
    both = _plain_pixels(images, np.concatenate(metas), k)
    for g in range(2):
        np.testing.assert_array_equal(both[6 * g:6 * (g + 1)],
                                      _plain_pixels(images[g], metas[g], k))
    # globals: whole images of two sizes, paired
    meta = np.concatenate([tpp.clip_transform_meta(300, 240, np.asarray([[0.0, 0, 300, 240]])),
                           tpp.clip_transform_meta(250, 310, np.asarray([[0.0, 0, 250, 310]]))])
    coeffs = jpp.device_coeffs(jnp.asarray(meta), 13)
    want = np.asarray(jpp.apply_resize_coeffs(
        jnp.asarray(images.astype(np.float32)), *coeffs, compute_dtype=jnp.bfloat16))
    np.testing.assert_array_equal(_plain_pixels(images, meta, 13), want)


def _kernel_taps(meta: np.ndarray, k_pad: int, out: int = 224, k_own=None, counts=False):
    """The tap prologue of ``csrc/preprocess.cu`` (``axis_taps``) in float32
    numpy, op for op in the kernel's order (numpy rounds every operation;
    the kernel's ``_rn`` intrinsics forbid FMA contraction); ``k_own`` one
    tap count a crop, whose split the crop's tap sum takes. With
    ``counts``, each axis also gives the taps that may be nonzero (the
    kernel's ``count``): ``(wx, sx, nx, wy, sy, ny)``."""
    f = np.float32
    x0, y0, cw, ch, ow, oh, left, top, ident = (meta[:, i:i + 1].astype(f) for i in range(9))
    o = np.arange(out, dtype=f)[None]
    own = np.full(len(meta), k_pad) if k_own is None else np.asarray(k_own)
    split = np.asarray([tpp.tap_sum_half(int(k)) for k in own])[:, None]  # (B, 1)

    def axis(crop0, size, n_out, offset):
        scale = size / n_out
        filterscale = np.maximum(scale, f(1))
        support = f(2) * filterscale
        center = (((o + offset) + f(0.5)) * size) / n_out
        xmin = np.maximum(np.trunc((center - support) + f(0.5)), f(0))
        xend = np.minimum(np.trunc((center + support) + f(0.5)), size)
        valid = xend - xmin
        w = np.zeros(center.shape + (k_pad,), f)
        ww = rest = np.zeros(center.shape, f)
        for k in range(k_pad):
            kf = f(k)
            ax = np.abs((((kf + xmin) - center) + f(0.5)) / filterscale)
            near = (((f(1.5) * ax) - f(2.5)) * ax) * ax + f(1)
            far = ((((ax - f(5)) * ax) + f(8)) * ax - f(4)) * f(-0.5)
            v = np.where(kf < valid, np.where(ax < 1, near, np.where(ax < 2, far, f(0))), f(0))
            w[..., k] = v
            # left to right, in two parts past 32 taps: [0, split), [split, k_pad)
            ww = np.where(k < split, v if k == 0 else ww + v, ww)
            rest = np.where(k == split, v, np.where(k > split, rest + v, rest))
        ww = np.where(split < k_pad, ww + rest, ww)
        v = w / np.where(ww == 0, f(1), ww)[..., None]
        half = np.where(v > 0, f(0.5), np.where(v < 0, f(-0.5), f(0)))
        q = f(1 << tpp.PRECISION_BITS)
        w = np.trunc(v * q + half) / q
        start = (xmin + crop0).astype(np.int32)
        unit = np.zeros_like(w)
        unit[..., 0] = 1
        ident_b = ident.astype(bool)
        w = np.where(ident_b[..., None], unit, w)
        start = np.where(ident_b, ((crop0 + offset) + o).astype(np.int32), start)
        count = np.where(valid <= 0, 0, np.minimum(k_pad, valid.astype(np.int32)))
        count = np.where(ident_b, 1, count)
        return (w, start, count) if counts else (w, start)

    return (*axis(x0, cw, ow, left), *axis(y0, ch, oh, top))


@pytest.mark.parametrize('k', [13, 35, 49])
def test_kernel_tap_prologue_is_device_coeffs(k):
    """The kernel derives each crop's taps itself; its order of operations,
    modelled in float32 numpy, gives ``device_coeffs``' taps bit for bit,
    the port's and ``oadp_tpu``'s, on crops of every kind (identity, past
    the edges, a pixel wide, scales from 1/28 to 8 and the largest k_pad)
    and on crops whose taps fill ``k`` (one left-to-right sum at 13, two
    halves at 35 and 49). Reordering the center's multiply and divide, the
    tap sum or the quantisation in the model makes this fail (checked by
    mutation)."""
    rng = np.random.RandomState(11)
    boxes = np.concatenate([_boxes(kind, rng, 60) for kind in (
        'identity', 'past_edges', 'one_pixel_wide', 'random', 'largest_k')])
    if k != 35:  # crops whose taps fill k: scales near (k - 1) / 4
        side = 56 * (k - 1) * rng.uniform(0.93, 1.0, 40)
        x0, y0 = rng.uniform(-100, 100, 40), rng.uniform(-100, 100, 40)
        boxes = np.concatenate([boxes[:300 - 40 * (k > 13)], np.stack(
            [x0, y0, x0 + side, y0 + side * rng.uniform(1.0, 1.05, 40)], -1)])
    meta = tpp.clip_transform_meta(300, 240, boxes)
    model = _kernel_taps(meta, k)
    ours = tpp.device_coeffs(torch.from_numpy(meta), k)
    ref = jpp.device_coeffs(jnp.asarray(meta), k)
    for m, a, b in zip(model, ours, ref):
        np.testing.assert_array_equal(m, a.numpy())
        np.testing.assert_array_equal(m, np.asarray(b))


def _bucket_boxes(rng, own: int, n: int = 40):
    """``n`` crops of a 640 x 480 image whose tap counts reach ``own``:
    scales from 3/4 of ``(own - 1) / 4`` up to it."""
    side = rng.uniform(0.75, 1.0, n) * 56 * (own - 1)
    x0, y0 = rng.uniform(-200, 200, n), rng.uniform(-200, 200, n)
    return np.stack([x0, y0, x0 + side, y0 + side * rng.uniform(0.9, 1.0, n)], -1)


@pytest.mark.parametrize('own', [21, 33])
def test_own_tap_bucket_at_a_larger_k_pad(own):
    """An image of tap bucket ``own`` in a group run at the objects CLI's
    largest, 35: with ``k_own`` its crops' weights are ``oadp_tpu``'s at
    ``own`` bit for bit (the program ``oadp_tpu`` compiles for that
    bucket), the taps past ``own`` exactly 0, and the kernel's prologue
    (the numpy model) agrees. Without ``k_own`` the tap sums split at 35's
    half and weights move (the data exercises the split)."""
    rng = np.random.RandomState(own)
    meta = tpp.clip_transform_meta(640, 480, _bucket_boxes(rng, own, 80))
    ks = 2 * np.ceil(2 * np.maximum(meta[:, 2] / meta[:, 4], meta[:, 3] / meta[:, 5])) + 1
    assert ks.max() == own
    ref = jpp.device_coeffs(jnp.asarray(meta), own)
    k_own = torch.full((len(meta),), own)
    ours = tpp.device_coeffs(torch.from_numpy(meta), 35, k_own=k_own)
    model = _kernel_taps(meta, 35, k_own=k_own.numpy())
    wide = tpp.device_coeffs(torch.from_numpy(meta), 35)
    moved = 0
    for r, a, m, w in zip(ref, ours, model, wide):
        r, a, w = np.asarray(r), a.numpy(), w.numpy()
        np.testing.assert_array_equal(m, a)
        if a.ndim == 3:
            np.testing.assert_array_equal(a[..., :own], r)
            assert not a[..., own:].any()
            moved += int((w[..., :own] != r).sum())
        else:
            np.testing.assert_array_equal(a, r)
    assert moved > 0


def test_resize_crops_plain_mixed_buckets_one_call():
    """One call for two images of tap buckets 21 and 35 at ``k_pad`` 35
    (``objects_packed_step``'s group) equals each image alone at its own
    bucket and ``oadp_tpu``'s bf16 pixels there (at most 1e-5 of them one
    uint8 step off); the taps it derives (80 crops an image, on 16 x 16
    images, most taps reading the zero fill) are ``oadp_tpu``'s at each
    image's bucket, where some of the 21-tap image's weights move at 35's
    split without ``k_own``; ``k_own`` is checked (one count an image,
    within ``k_pad``)."""
    rng = np.random.RandomState(5)
    images = np.stack([_image(rng, 480, 640, 640), _image(rng, 480, 640, 640)])
    metas = [tpp.clip_transform_meta(640, 480, _bucket_boxes(rng, k, 6)) for k in (21, 35)]
    both = tpp.resize_crops_plain(torch.from_numpy(images), torch.from_numpy(
        np.concatenate(metas)), 35, (0.0,) * 3, (1.0,) * 3, k_own=(21, 35)).float().numpy()
    for g, k in enumerate((21, 35)):
        alone = _plain_pixels(images[g], metas[g], k)
        np.testing.assert_array_equal(both[6 * g:6 * (g + 1)], alone)
        # the plain version's sums run in another order than oadp_tpu's dense
        # product: a sum within an ulp of a .5 tie may round one step apart
        steps = np.abs(alone - _jax_crops(images[g], metas[g], k))
        assert steps.max() <= 1 and (steps > 0).sum() <= 1e-5 * steps.size
    rng = np.random.RandomState(21)
    metas = [tpp.clip_transform_meta(640, 480, _bucket_boxes(rng, k, 80)) for k in (21, 35)]
    small = torch.from_numpy(np.stack([_image(rng, 16, 16, 16), _image(rng, 16, 16, 16)]))
    _, taps = tpp.resize_crops_plain(small, torch.from_numpy(np.concatenate(metas)), 35,
                                     k_own=(21, 35), return_taps=True)
    for g, k in enumerate((21, 35)):
        for got, want in zip(taps, jpp.device_coeffs(jnp.asarray(metas[g]), k)):
            got = got[80 * g:80 * (g + 1)].numpy()
            np.testing.assert_array_equal(got[..., :k] if got.ndim == 3 else got,
                                          np.asarray(want))
    wide = tpp.device_coeffs(torch.from_numpy(metas[0]), 35)
    assert any((w[..., :21].numpy() != np.asarray(r)).any()
               for w, r in zip(wide[::2], jpp.device_coeffs(jnp.asarray(metas[0]), 21)[::2]))
    for bad in ((21,), (21, 36), (0, 35)):
        with pytest.raises(ValueError):
            tpp.resize_crops_args(small, torch.from_numpy(np.concatenate(metas)), 35,
                                  k_own=bad)


@pytest.mark.parametrize('k_pad, on_kernel', [(35, True), (64, True), (65, False)])
def test_crops_take_the_kernel_up_to_its_taps(k_pad, on_kernel, monkeypatch):
    """A bf16 model's crops take ``resize_crops``' kernel on the card up to
    ``RESIZE_MAX_TAPS`` taps; past it (the objects CLI's ``k_max`` once
    ``max_image_size`` is above ~1227) the dense route, as on the CPU.
    Here the images say they are on the card; at 65 the dense route runs
    (on the CPU tensors behind them) and the kernel's entry is not called."""
    from oadp_torch.oake import encoders as E

    model = E.load_clip(None, 'bfloat16', vit=dict(width=64, layers=1, heads=1, output_dim=32),
                        device='cpu')
    steps = E.OakeSteps(model, PAD, PAD)
    assert tpp.resize_crops_supported(k_pad) == on_kernel
    assert steps._on_kernel(torch.empty(0), k_pad) is False

    class OnCard(torch.Tensor):
        @property
        def device(self):
            return torch.device('cuda')

    image = torch.from_numpy(_image(np.random.RandomState(1)))
    meta = torch.from_numpy(tpp.clip_transform_meta(300, 240, np.asarray([[0.0, 0, 300, 240]])))
    assert steps._on_kernel(image.as_subclass(OnCard), k_pad) == on_kernel
    if not on_kernel:
        def refuse(*a, **k):
            raise AssertionError('resize_crops called past its taps')

        monkeypatch.setattr(tpp, 'resize_crops', refuse)
        monkeypatch.setattr(E.OakeSteps, '_on_kernel',
                            lambda self, images, k: E.P.resize_crops_supported(k))
        got = steps._crops(image, meta, k_pad)
        want = tpp.normalize_clip(tpp.apply_resize_coeffs(
            image.float(), *tpp.device_coeffs(meta, k_pad), compute_dtype=torch.bfloat16),
            torch.bfloat16)
        assert torch.equal(got, want)


def test_objects_batch_hands_each_chunk_its_tap_bucket():
    """``ObjectsPipeline.execute_batch`` runs chunks of one crop bucket as one
    group at the group's largest tap bucket and hands each chunk its own
    (``k_own``), so a chunk's weights are its bucket's."""
    from oadp_torch.oake.objects import ObjectsPipeline

    calls = []

    class Steps:
        def objects_packed_step(self, bufs, b, k_pad, k_own=None):
            calls.append((len(bufs), b, k_pad, list(k_own)))
            return torch.zeros(len(bufs) * b, 4)

    pipe = ObjectsPipeline.__new__(ObjectsPipeline)
    pipe.steps = Steps()
    item = lambda k, chunks: dict(  # noqa: E731
        k=k, chunks=[(np.zeros(8, np.uint8), b, b) for b in chunks],
        bboxes=np.zeros((1, 4)), objectness=np.zeros((1, 1)))
    pipe.execute_batch([item(21, [16]), item(35, [16, 4]), item(33, [16])])
    assert calls == [(3, 16, 35, [21, 35, 33]), (1, 4, 35, [35])]


def test_resize_crops_args_what_the_kernel_takes():
    """What ``resize_crops`` hands its kernel: uint8 images whose each
    ``(PH, PW, 3)`` is contiguous (the packed chunks' view of one buffer,
    read at its row stride), contiguous fp32 ``(G * B, 9)`` scalars, the
    crops per image; anything else is refused before a build."""
    g, b, pad = 2, 4, 32
    n_img = pad * pad * 3
    buf = torch.zeros((g, n_img + 100 + b * 36), dtype=torch.uint8)
    images = buf[:, :n_img].reshape(g, pad, pad, 3)
    assert not images.is_contiguous()
    meta = torch.zeros((g * b, 9))
    assert tpp.resize_crops_args(images, meta, 35) == (g, b, buf.shape[1])
    assert tpp.resize_crops_args(images[0], meta[:b], 5) == (1, b, n_img)
    with pytest.raises(TypeError):
        tpp.resize_crops_args(images.float(), meta, 35)
    with pytest.raises(ValueError):
        tpp.resize_crops_args(images.transpose(1, 2), meta, 35)
    with pytest.raises(ValueError):
        tpp.resize_crops_args(images, meta.double(), 35)
    with pytest.raises(ValueError):
        tpp.resize_crops_args(images, meta[:7], 35)
    with pytest.raises(ValueError):
        tpp.resize_crops_args(images, meta, tpp.RESIZE_MAX_TAPS + 1)
    tpp.reset_launches()
    tpp.resize_crops(images, torch.from_numpy(tpp.clip_transform_meta(
        pad, pad, np.asarray([[0.0, 0, 20, 30]] * g * b))), 9)
    assert tpp.LAUNCHES == {'resize_crops': 0}


def test_steps_hand_resize_crops_one_call_a_step(monkeypatch):
    """With a bf16 model on the card the objects and globals steps cut their
    crops with one ``resize_crops`` call a step (forced here on the CPU,
    where the entry takes its plain version): the packed chunks' view of
    one buffer and the chunks' scalars as one ``(G * B, 9)`` tensor, a
    multi step's images gathered by index, the globals' paired images, each
    chunk's own tap bucket (``k_own``) where the packed step is given one;
    the embeddings equal the matmul route's."""
    from oadp_torch.oake import encoders as E

    model = E.load_clip(None, 'bfloat16', vit=dict(width=64, layers=1, heads=1, output_dim=32),
                        device='cpu')
    steps = E.OakeSteps(model, PAD, PAD)
    rng = np.random.RandomState(9)
    images = [_image(rng), _image(rng)]
    metas = [tpp.clip_transform_meta(300, 240, _boxes('random', rng, 4)) for _ in range(3)]
    masks = [(rng.rand(4, model.grid, model.grid) > .5).astype(np.uint8) for _ in range(3)]
    bufs = np.stack([np.concatenate([images[i].reshape(-1), masks[i].reshape(-1),
                                     metas[i].view(np.uint8).reshape(-1)]) for i in range(2)])
    gmeta = np.repeat(tpp.clip_transform_meta(300, 240, np.asarray([[0.0, 0, 300, 240]])), 2, 0)
    runs = {
        'objects_step': lambda: steps.objects_step(images[0], metas[0], masks[0], 21),
        'objects_multi_step': lambda: steps.objects_multi_step(images, [0, 1, 0], metas, masks, 21),
        'objects_packed_step': lambda: steps.objects_packed_step(bufs, 4, 35),
        'objects_packed_own': lambda: steps.objects_packed_step(bufs, 4, 35, k_own=(21, 35)),
        'globals_step': lambda: steps.globals_step(np.stack(images), gmeta, 13),
    }
    want = {name: run().numpy() for name, run in runs.items()}
    seen = []
    plain = tpp.resize_crops
    seen_own = []
    monkeypatch.setattr(tpp, 'resize_crops', lambda *a, **k: seen.append(a) or seen_own.append(
        k.get('k_own')) or plain(*a, **k))
    monkeypatch.setattr(E.OakeSteps, '_on_kernel', lambda self, images, k_pad: True)
    for name, run in runs.items():
        seen.clear()
        seen_own.clear()
        got = run().numpy()
        assert len(seen) == 1, name
        imgs, meta, k = seen[0]
        g, per, stride = tpp.resize_crops_args(imgs, meta, k)
        assert (g, per) == {'objects_step': (1, 4), 'objects_multi_step': (3, 4),
                            'objects_packed_step': (2, 4), 'objects_packed_own': (2, 4),
                            'globals_step': (2, 1)}[name]
        assert seen_own[0] == (None if name != 'objects_packed_own' else (21, 35))
        assert meta.dtype == torch.float32 and meta.is_contiguous()
        if name == 'objects_packed_step':
            assert stride == bufs.shape[1]  # read in place from the packed buffer
        np.testing.assert_array_equal(got, want[name], name)


# ---------------------------------------------------------------------------
# resize_crops' kernel, stage by stage, in numpy
# ---------------------------------------------------------------------------

_TWO23 = np.float32(2 ** 23)


def _byte_perm(x, y, sel):
    """CUDA's ``__byte_perm(x, y, sel)``: byte n of the result is byte
    ``(sel >> 4n) & 7`` of the 8 bytes ``y:x`` (x's bytes first)."""
    pool = np.asarray([x, y], np.uint32).view(np.uint8)
    return np.asarray([pool[(sel >> (4 * n)) & 7] for n in range(4)], np.uint8).view(np.uint32)[0]


def _widen(word, byte):
    """The kernel's ``widen<byte>``: the byte under 2^23's exponent, minus
    2^23."""
    return np.uint32(_byte_perm(word, 0x4B000000, 0x7440 + byte)).view(np.float32) - _TWO23


def _round_u8(v):
    """The kernel's ``round_u8``: ``t = v + 0.5`` in fp32, then 2^23 added
    rounding down (floor(t) in the mantissa for 0 <= t < 2^23, a negative
    integer below it for t < 0), the integer clamped to 0..255."""
    t = (v + np.float32(0.5)).astype(np.float32)
    s = (t + _TWO23).astype(np.float32)  # to nearest; step down where it rounded up
    up = s.astype(np.float64) > t.astype(np.float64) + 2.0 ** 23
    s = np.where(up, np.nextafter(s, np.float32(0)), s).astype(np.float32)
    return np.clip(s.view(np.int32).astype(np.int64) - 0x4B000000, 0, 255).astype(np.uint8)


def _norm_table(mean, std):
    """The kernel's normalisation table: ``bf16((v - mean) / std)`` for
    every uint8 v of each channel, in fp32 (3, 256)."""
    v = np.arange(256, dtype=np.float32)
    t = (v[None] - np.asarray(mean, np.float32)[:, None]) / np.asarray(std, np.float32)[:, None]
    return torch.from_numpy(t).bfloat16().float().numpy()


def _clip_taps(start, count, limit):
    lo, hi = np.maximum(0, -start), np.minimum(count, limit - start)
    live = hi > lo
    return np.where(live, start + lo, 0), np.where(live, lo, 0), np.where(live, hi - lo, 0)


def _kernel_crops(images, meta, k_pad, mean=tpp._MEAN, std=tpp._STD, out=224, band=None):
    """``csrc/preprocess.cu:resize_crops_kernel`` in numpy, a block (crop,
    band of ``band`` output rows) at a time, stage by stage: the taps cut
    to the image, the normalisation table, the sub-bands (each reaching at
    most the ring's rows), the staged chunks (each within the cap, only the
    byte columns the crop's taps reach, 16-byte units), the horizontal
    pass once a source row into the ring (an FMA a tap is the exact
    product added: numpy's product then sum), the vertical pass from the
    ring and the table. Returns the crops (crops, out, out, 3) in fp32 and
    the blocks' plans; asserts as it goes that each output row is written
    once and each source row's horizontal pass runs once a block."""
    images = images[None] if images.ndim == 3 else images
    g, ph, pw = images.shape[:3]
    per, rp = len(meta) // g, out * 3
    wx, sx, nx, wy, sy, ny = _kernel_taps(meta, k_pad, out, counts=True)
    wx, wy = (torch.from_numpy(w).bfloat16().float().numpy() for w in (wx, wy))
    ring_rows, cap = tpp.resize_stage_plan(k_pad, pw, out)
    table = _norm_table(mean, std)
    band = band or out
    res = np.empty((len(meta), out, rp), np.float32)
    plans = []
    for c in range(len(meta)):
        img = images[c // per].reshape(ph, pw * 3)
        xs, xk, xn = _clip_taps(sx[c], nx[c], pw)
        ys, yk, yn = _clip_taps(sy[c], ny[c], ph)
        live = xn > 0
        c_lo = xs[live].min() & ~15 if live.any() else 0
        px = ((xs + xn)[live].max() - c_lo + 15) & ~15 if live.any() else 16
        chunk = max(1, cap // (4 * px))
        for e0 in range(0, out, band):
            e1 = min(e0 + band, out)
            ring = np.zeros((ring_rows, rp), np.uint8)
            done, r, written, passed, plan = 0, e0, [], [], []
            while r < e1:
                lo, hi, r1 = np.iinfo(np.int32).max, np.iinfo(np.int32).min, r
                while r1 < e1:
                    if yn[r1]:
                        lo2, hi2 = min(lo, ys[r1]), max(hi, ys[r1] + yn[r1])
                        if hi2 - lo2 > ring_rows:
                            break
                        lo, hi = lo2, hi2
                    r1 += 1
                for c0 in range(max(lo, done), hi, chunk):
                    c1 = min(hi, c0 + chunk)
                    # 16-pixel units of 48 bytes, zero past the row, a word a
                    # pixel; each channel widened as a tap reads it
                    raw = np.zeros((c1 - c0, 3 * px), np.uint8)
                    width = min(3 * px, 3 * pw - 3 * c_lo)
                    raw[:, :width] = img[c0:c1, 3 * c_lo:3 * c_lo + width]
                    staged = ((raw.astype(np.uint32) | 0x4B000000).view(np.float32)
                              - _TWO23).reshape(c1 - c0, px, 3)
                    plan.append(((c1 - c0) * px * 4, c0, c1))
                    acc = np.zeros((c1 - c0, out, 3), np.float32)
                    for k in range(k_pad):
                        col = np.where(k < xn, xs + k - c_lo, 0)
                        w = wx[c, np.arange(out), np.minimum(xk + k, k_pad - 1)][:, None]
                        acc = np.where((k < xn)[:, None], acc + w * staged[:, col], acc)
                    ring[np.arange(c0, c1) % ring_rows] = _round_u8(acc).reshape(c1 - c0, rp)
                    passed += range(c0, c1)
                done = max(done, hi)
                rows = np.arange(r, r1)
                acc = np.zeros((len(rows), rp), np.float32)
                for k in range(k_pad):
                    on = (k < yn[rows])[:, None]
                    vals = ring[(ys[rows] + k) % ring_rows].astype(np.float32)
                    w = wy[c, rows, np.minimum(yk[rows] + k, k_pad - 1)][:, None]
                    acc = np.where(on, acc + w * vals, acc)
                res[c, rows] = table[np.arange(rp) % 3, _round_u8(acc).astype(np.int64)]
                written += list(rows)
                r = r1
            assert written == list(range(e0, e1)), 'an output row written twice or never'
            assert len(passed) == len(set(passed)), 'a source row passed twice'
            plans.append(dict(px=px, chunk=chunk, staged=plan))
    return res.reshape(len(meta), out, out, 3), plans


def test_resize_norm_table_is_the_division():
    """The kernel's 3 x 256 bf16 table (built with the plain version's
    ``bf16((v - mean) / std)``) against the plain version's per-pixel
    division, for every uint8 v and each channel: the CLIP mean and std,
    and mean 0 / std 1 (the integers themselves)."""
    v = torch.arange(256, dtype=torch.float32)[:, None].expand(256, 3)
    for mean, std in ((tpp._MEAN, tpp._STD), ((0.0,) * 3, (1.0,) * 3)):
        want = ((v - torch.from_numpy(np.asarray(mean, np.float32)))
                / torch.from_numpy(np.asarray(std, np.float32))).bfloat16().float()
        np.testing.assert_array_equal(_norm_table(mean, std).T, want.numpy())


def test_resize_byte_widening_is_exact():
    """Each byte 0..255, in each position of a word, widened as the kernel
    does (byte_perm under 0x4B, minus 2^23) is the byte; sixteen pixels of
    48 bytes held as 12 words become a word each (``pixel_word``: bytes
    3p..3p+2 from word 3p / 4, or from it and the next when they straddle)
    whose three channels widen to the pixel's bytes."""
    for b in range(256):
        for pos in range(4):
            word = np.uint32(b << (8 * pos)) | np.uint32(0x5A5A5A5A & ~(0xFF << (8 * pos)))
            assert _widen(word, pos) == np.float32(b)
    unit = np.random.RandomState(5).randint(0, 256, 48).astype(np.uint8)
    words = unit.view(np.uint32)
    for p in range(16):
        i, off = (3 * p) >> 2, (3 * p) & 3
        px = _byte_perm(words[i], words[i + 1] if off > 1 else 0,
                        off | (off + 1) << 4 | (off + 2) << 8)
        assert [_widen(px, c) for c in range(3)] == list(unit[3 * p:3 * p + 3].astype(np.float32))


def test_resize_round_u8_without_conversions():
    """The kernel's rounding to uint8 (2^23 added rounding down, the
    mantissa read, the integer clamped) equals ``round_u8``'s
    ``clamp(floor(v + 0.5), 0, 255)`` on every fp32 value near each .5
    tie from -3 to 258, on zeros of both signs and far outside the range."""
    ties = np.arange(-3, 259, dtype=np.float32) + np.float32(0.5)
    near = np.concatenate([ties, np.nextafter(ties, np.float32(-1e9)),
                           np.nextafter(ties, np.float32(1e9)), ties - np.float32(0.5)])
    near = np.concatenate([near, np.float32([0.0, -0.0, 1e-30, -1e-30, 1e6, -1e6, 255.49998])])
    v = near - np.float32(0.5)  # the kernel adds the 0.5 itself
    v = np.concatenate([v, near])
    want = tpp.round_u8(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(_round_u8(v).astype(np.float32), want)


@pytest.mark.parametrize('kind, k', [
    ('identity', 5), ('past_edges', 13), ('one_pixel_wide', 13), ('largest_k', 35),
    ('bucket', 21), ('bucket', 35), ('bucket', 64),
])
def test_resize_kernel_model_matches_plain_and_oadp_tpu(kind, k):
    """The numpy model of the redesigned kernel (staged source, widening,
    FMA tap sums in the plain version's order, ring, table) bit for bit
    equal to ``resize_crops_plain`` and to ``oadp_tpu``'s bf16 pixels and
    ``normalize_clip``, on identity, past-edge, one-pixel and
    sqrt(8)-expanded crops and on crops whose taps reach 21, 35 and 64, as
    one crop a block and in bands of 16 rows (the globals launch); its
    sub-band planner writes every output row once, passes every source row
    once a block, and stages at most the cap a chunk."""
    rng = np.random.RandomState(k + len(kind))
    if kind == 'bucket':
        image = _image(rng, 480, 640, 640)
        # at 64 taps a crop spans the image: one source row a chunk
        meta = tpp.clip_transform_meta(640, 480, _bucket_boxes(rng, k, 2 if k == 64 else 6))
    else:
        image = _image(rng)
        meta = tpp.clip_transform_meta(300, 240, _boxes(kind, rng, 6))
    zero, one = (0.0,) * 3, (1.0,) * 3
    plain = _plain_pixels(image, meta, k)
    np.testing.assert_array_equal(plain, _jax_crops(image, meta, k))
    ring_rows, cap = tpp.resize_stage_plan(k, image.shape[1])
    for band in (None, 16) if k < 64 else (None,):
        got, plans = _kernel_crops(image, meta, k, zero, one, band=band)
        np.testing.assert_array_equal(got, plain)
        assert all(b <= cap and b % 16 == 0 for p in plans for b, _, _ in p['staged'])
        assert all(p['px'] % 16 == 0 for p in plans)
    normed, _ = _kernel_crops(image, meta, k)
    np.testing.assert_array_equal(normed, tpp.resize_crops_plain(
        torch.from_numpy(image), torch.from_numpy(meta), k).float().numpy())
    assert ring_rows >= k and tpp.resize_smem(ring_rows, 224, 224, cap, k) <= 232448


def test_resize_stage_plan_fits_two_blocks_an_sm():
    """The ring and cap leave two blocks an SM at the objects CLI's tap
    buckets on its 640-pixel pad (one block an SM only past them, at 64
    taps), and the kernel's shared memory stays under its 227 KB."""
    for k in (5, 9, 13, 21, 35):
        ring, cap = tpp.resize_stage_plan(k, 640)
        assert tpp.resize_smem(ring, 224, 224, cap, k) <= tpp.RESIZE_SMEM_TWO
        assert cap >= 4 * 656 and ring == k + tpp.RESIZE_RING_SLACK  # a row of 640
    ring, cap = tpp.resize_stage_plan(64, 640)
    assert tpp.resize_smem(ring, 224, 224, cap, 64) <= 232448


def test_resize_smem_is_the_kernels():
    """The wrapper's shared-memory size is the kernel's: ``smem_bytes`` and
    the two offsets it adds up (``csrc/preprocess.cu``), read from the
    source and evaluated as Python, equal :func:`resize_smem` over the
    layouts the planners give (bands of 16 rows to the whole crop, every
    tap bucket, pads of 1 to 1280 pixels). The kernel refuses a launch
    whose size differs; this finds the drift before the card does."""
    import pathlib
    import re

    src = (pathlib.Path(tpp.__file__).parent.parent / 'csrc' / 'preprocess.cu').read_text()
    scope = {}
    for name in ('smem_source', 'smem_ints', 'smem_bytes'):
        found = re.search(r'int ' + name + r'\(([^)]*)\)\s*\{\s*return ([^;]*);', src)
        assert found, name
        args = ', '.join(a.split()[-1] for a in found.group(1).split(','))
        exec(f'def {name}({args}):\n    return {found.group(2)}\n', scope)
    for k in (1, 5, 13, 21, 35, 64):
        for pw in (1, 224, 640, 1280):
            ring, cap = tpp.resize_stage_plan(k, pw)
            for crops in (1, 16, 100, 2048):
                bands, band = tpp.resize_bands(crops, 224, 132)
                assert (bands - 1) * band < 224 <= bands * band and band >= 16
                assert (scope['smem_bytes'](ring, 224, band, cap, k)
                        == tpp.resize_smem(ring, 224, band, cap, k))


def _card_resize_inputs(shape, rng):
    """Padded uint8 images and their crops' metas: ``small``, two 300 x
    240 images at pad 320, eight crops of each kind an image (six past
    the edges); ``objects``, an objects dispatch, two 640 x 480 images at
    pad 640 and 1024 crops each (eight identity, six past the edges, eight
    a pixel wide, the rest random with three sqrt(8)-expanded whole
    images, 35 taps); ``globals``, a globals dispatch, 16 640 x 480
    images, each whole."""
    if shape == 'globals':
        images = np.stack([_image(rng, 480, 640, 640) for _ in range(16)])
        whole = tpp.clip_transform_meta(640, 480, np.asarray([[0.0, 0, 640, 480]]))
        return images, np.repeat(whole, 16, 0)
    h, w, pad, n = (480, 640, 640, 1002) if shape == 'objects' else (240, 300, PAD, 8)
    images = np.stack([_image(rng, h, w, pad) for _ in range(2)])
    metas = np.concatenate([tpp.clip_transform_meta(w, h, np.concatenate(
        [_boxes(kind, rng, 8, h, w) for kind in ('identity', 'past_edges', 'one_pixel_wide')]
        + ([_boxes('random', rng, 8, h, w)] if shape == 'small' else [])
        + [_boxes('largest_k', rng, n, h, w)])) for _ in range(2)])
    return images, metas


@pytest.mark.cuda
@pytest.mark.parametrize('k, shape', [(5, 'small'), (13, 'small'), (35, 'small'), (64, 'small'),
                                      (35, 'objects'), (13, 'globals')])
def test_resize_crops_on_card(k, shape):
    """The kernel against its plain version on the card: taps bit for bit
    ``device_coeffs``' (on the card and on the CPU), pixels equal (at most
    1e-5 of them one uint8 step off, none more), normalized crops equal;
    the chunks of one packed buffer (a view) in one launch, and paired
    images. At small images, and at an objects and a globals dispatch."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    dev = torch.device('cuda')
    images, metas = _card_resize_inputs(shape, np.random.RandomState(k))
    g, pad = len(images), images.shape[1]
    n_img = pad * pad * 3
    buf = torch.zeros((g, n_img + 40), dtype=torch.uint8)
    buf[:, :n_img] = torch.from_numpy(images.reshape(g, -1))
    buf = buf.to(dev)
    imgs = buf[:, :n_img].reshape(g, pad, pad, 3)
    meta = torch.from_numpy(metas).to(dev)
    tpp.reset_launches()
    crops, taps = tpp.resize_crops(imgs, meta, k, return_taps=True)
    torch.cuda.synchronize()
    assert tpp.LAUNCHES['resize_crops'] == 1 and crops.dtype == torch.bfloat16
    for got, want, cpu in zip(taps, tpp.device_coeffs(meta, k),
                              tpp.device_coeffs(meta.cpu(), k)):
        assert torch.equal(got, want) and torch.equal(got.cpu(), cpu)
    zero, one = (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)
    px = tpp.resize_crops(imgs, meta, k, zero, one).float()
    steps = (px - tpp.resize_crops_plain(imgs, meta, k, zero, one).float()).abs()
    assert float(steps.max()) <= 1 and int((steps > 0).sum()) <= 1e-5 * steps.numel()
    plain = tpp.resize_crops_plain(imgs, meta, k)
    assert float((crops.float() - plain.float()).abs().max()) <= (
        0.0 if int((steps > 0).sum()) == 0 else 0.02)
    if len(meta) > g:  # a crop an image
        paired = meta[::len(meta) // g].contiguous()
        assert torch.equal(tpp.resize_crops(imgs, paired, k),
                           tpp.resize_crops_plain(imgs, paired, k))


@pytest.mark.cuda
def test_resize_crops_on_card_own_buckets():
    """Two images of tap buckets 21 and 33 in one launch at ``k_pad`` 35, each
    split where its own bucket splits: the taps bit for bit ``device_coeffs``'
    with ``k_own`` (the 21-tap image's equal to ``oadp_tpu``'s at 21 on the
    CPU test), the pixels within one uint8 step of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    dev = torch.device('cuda')
    rng = np.random.RandomState(21)
    images = torch.from_numpy(np.stack([_image(rng, 480, 640, 640),
                                        _image(rng, 480, 640, 640)])).to(dev)
    meta = torch.from_numpy(np.concatenate([tpp.clip_transform_meta(
        640, 480, _bucket_boxes(rng, k, 16)) for k in (21, 33)])).to(dev)
    tpp.reset_launches()
    crops, taps = tpp.resize_crops(images, meta, 35, return_taps=True, k_own=(21, 33))
    torch.cuda.synchronize()
    assert tpp.LAUNCHES['resize_crops'] == 1
    own = torch.tensor([21] * 16 + [33] * 16)
    for got, want in zip(taps, tpp.device_coeffs(meta.cpu(), 35, k_own=own)):
        assert torch.equal(got.cpu(), want)
    zero, one = (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)
    px = tpp.resize_crops(images, meta, 35, zero, one, k_own=(21, 33)).float()
    want = tpp.resize_crops_plain(images, meta, 35, zero, one, k_own=(21, 33)).float()
    steps = (px - want).abs()
    assert float(steps.max()) <= 1 and int((steps > 0).sum()) <= 1e-5 * steps.numel()
