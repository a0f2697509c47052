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


def _kernel_taps(meta: np.ndarray, k_pad: int, out: int = 224, k_own=None):
    """The tap prologue of ``csrc/preprocess.cu`` (``axis_taps``) in float32
    numpy, op for op in the kernel's order (numpy rounds every operation;
    the kernel's ``_rn`` intrinsics forbid FMA contraction); ``k_own`` one
    tap count a crop, whose split the crop's tap sum takes."""
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
        return w, start

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


@pytest.mark.cuda
@pytest.mark.parametrize('k', [5, 13, 35, 64])
def test_resize_crops_on_card(k):
    """The kernel against its plain version on the card: taps bit for bit
    ``device_coeffs``' (on the card and on the CPU), pixels equal (at most
    1e-5 of them one uint8 step off, none more), normalized crops equal;
    two chunks of one packed buffer (a view) in one launch, and paired
    images."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device; chip_smoke.py runs the full check')
    dev = torch.device('cuda')
    rng = np.random.RandomState(k)
    images = np.stack([_image(rng), _image(rng)])
    metas = np.concatenate([tpp.clip_transform_meta(300, 240, np.concatenate(
        [_boxes(kind, rng, 8) for kind in ('identity', 'past_edges', 'one_pixel_wide',
                                            'random', 'largest_k')])) for _ in range(2)])
    n_img = PAD * PAD * 3
    buf = torch.zeros((2, n_img + 40), dtype=torch.uint8)
    buf[:, :n_img] = torch.from_numpy(images.reshape(2, -1))
    buf = buf.to(dev)
    imgs = buf[:, :n_img].reshape(2, PAD, PAD, 3)
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
    paired = tpp.resize_crops(imgs, meta[::8].contiguous(), k)  # a crop an image
    assert torch.equal(paired, tpp.resize_crops_plain(imgs, meta[::8].contiguous(), k))


@pytest.mark.cuda
def test_resize_crops_on_card_own_buckets():
    """Two images of tap buckets 21 and 33 in one launch at ``k_pad`` 35, each
    split where its own bucket splits: the taps bit for bit ``device_coeffs``'
    with ``k_own`` (the 21-tap image's equal to ``oadp_tpu``'s at 21 on the
    CPU test), the pixels within one uint8 step of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device; chip_smoke.py runs the full check')
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
