"""The port's preprocessing (``oadp_torch.ops.preprocess``) against
``oadp_tpu.ops.preprocess`` on the same numpy inputs: host and device
coefficients bit-identical, the fp32 resize bit-identical, the bf16
single-pass resize within 2 uint8 steps.

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
