"""The port's detector building blocks against ``oadp_tpu``'s on the same
inputs (numpy, from a seed), fp32 on the CPU: layers, ResNet (both
styles), FPN, anchors (exact), the delta coder, the NMS family (identical
keep sets), RoIAlign, the RPN, the RoI heads and the mask head, at the
small geometry of ``tests/test_dp_e2e.py`` (base 8, FPN 16, fc 32,
embedding 32, blocks (1, 1, 1, 1))."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oadp_tpu.models import fpn as jfpn
from oadp_tpu.models import heads as jheads
from oadp_tpu.models import layers as jlayers
from oadp_tpu.models import mask_head as jmask
from oadp_tpu.models import resnet as jresnet
from oadp_tpu.models import rpn as jrpn
from oadp_tpu.ops import anchors as janchors
from oadp_tpu.ops import coder as jcoder
from oadp_tpu.ops import nms as jnms
from oadp_tpu.ops import roi_align as jroi
from oadp_torch.models import fpn as tfpn
from oadp_torch.models import heads as theads
from oadp_torch.models import layers as tlayers
from oadp_torch.models import mask_head as tmask
from oadp_torch.models import resnet as tresnet
from oadp_torch.models import rpn as trpn
from oadp_torch.ops import anchors as tanchors
from oadp_torch.ops import coder as tcoder
from oadp_torch.ops import nms as tnms
from oadp_torch.ops import roi_align as troi

torch.set_num_threads(1)

ATOL = 1e-4


def jax_tree(tree, roi_channels: int = 16, path=()):
    """The port's parameter tree as ``oadp_tpu``'s (numpy leaves): conv
    weights OIHW -> HWIO, the mask head's transposed conv ``(in, out, kH,
    kW)`` -> ``(kH, kW, in, out)``, and the rows of each ConvFC head's first
    fc from (C, H, W) to (H, W, C) order (C: the head's last conv's
    channels, else ``roi_channels``)."""
    if isinstance(tree, dict):
        out = {k: jax_tree(v, roi_channels, path + (k,)) for k, v in tree.items()}
        if out.get('fcs') and 'cls' in out:
            w = out['fcs'][0]['w']
            c = out['convs'][-1]['conv']['w'].shape[-1] if out['convs'] else roi_channels
            roi = int(round((w.shape[0] // c) ** 0.5))
            out['fcs'][0]['w'] = np.ascontiguousarray(
                w.reshape(c, roi, roi, -1).transpose(1, 2, 0, 3).reshape(w.shape[0], -1))
        return out
    if isinstance(tree, (list, tuple)):
        return [jax_tree(v, roi_channels, path + (i,)) for i, v in enumerate(tree)]
    a = tree.detach().cpu().numpy()
    if a.ndim == 4:
        a = a.transpose(2, 3, 0, 1) if 'upsample' in path else a.transpose(2, 3, 1, 0)
    return np.ascontiguousarray(a)


def randomize_bn(tree, gen):
    """Non-trivial batch norms in place: affines and running statistics
    drawn from ``gen``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if isinstance(v, torch.Tensor) and k in ('scale', 'var'):
                tree[k] = 0.5 + torch.rand(v.shape, generator=gen)
            elif isinstance(v, torch.Tensor) and k in ('bias', 'mean'):
                tree[k] = 0.1 * torch.randn(v.shape, generator=gen)
            else:
                randomize_bn(v, gen)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            randomize_bn(v, gen)
    return tree


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def close(got: torch.Tensor, want, atol=ATOL, nhwc=False):
    got = got.detach().float().numpy()
    if nhwc:
        got = got.transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# layers, backbone, neck
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('k,stride,padding,bias', [
    (3, 1, 1, True), (1, 2, 0, False), (7, 2, 3, False), (3, 2, 2, True)])
def test_conv_matches(k, stride, padding, bias):
    gen = torch.Generator().manual_seed(0)
    p = tlayers.init_conv(gen, k, 5, 7, bias=bias)
    x = np.random.default_rng(0).standard_normal((2, 19, 23, 5)).astype(np.float32)
    want = jlayers.conv(jnp.asarray(x), jax_tree(p), stride, padding)
    close(tlayers.conv(nchw(x), p, stride, padding), want, nhwc=True)


def test_batch_norm_and_max_pool_match():
    gen = torch.Generator().manual_seed(1)
    p, s = randomize_bn(tlayers.init_bn(6), gen)
    x = np.random.default_rng(1).standard_normal((2, 9, 11, 6)).astype(np.float32) * 3
    want, _ = jlayers.batch_norm(jnp.asarray(x), jax_tree(p), jax_tree(s), False)
    close(tlayers.batch_norm(nchw(x), p, s), want, nhwc=True)
    for window, stride, pad in ((3, 2, 1), (1, 2, 0)):
        close(tlayers.max_pool(nchw(x), window, stride, pad),
              jlayers.max_pool(jnp.asarray(x), window, stride, pad), nhwc=True, atol=0)


def _resnet(style):
    cfg = dict(style=style, base_channels=8, blocks=(1, 1, 1, 1))
    gen = torch.Generator().manual_seed(2)
    p, s = tresnet.init_resnet_params(gen, tresnet.ResNetConfig(**cfg))
    return cfg, randomize_bn(p, gen), randomize_bn(s, gen)


@pytest.mark.parametrize('style', ['caffe', 'pytorch'])
def test_resnet_matches(style):
    cfg, p, s = _resnet(style)
    x = np.random.default_rng(2).standard_normal((2, 64, 96, 3)).astype(np.float32)
    want, _ = jax.jit(lambda p, s, x: jresnet.resnet_forward(
        p, s, x, jresnet.ResNetConfig(**cfg)))(jax_tree(p), jax_tree(s), jnp.asarray(x))
    got, got_stats = tresnet.resnet_forward(p, s, nchw(x), tresnet.ResNetConfig(**cfg))
    assert len(got) == 4 and got_stats is s
    for g, w in zip(got, want):
        close(g, w, nhwc=True)


def test_conv_bn_eval_bf16_folds_in_fp32():
    """The fold is made in fp32 and cast after: the bf16 conv then sees the
    folded weights ``oadp_tpu`` sees, so the outputs agree to bf16's
    rounding of the products."""
    _, p, s = _resnet('caffe')
    blk, st = p['layer1'][0], s['layer1'][0]
    x = np.random.default_rng(3).standard_normal((1, 12, 12, 8)).astype(np.float32)
    want = jresnet._conv_bn_eval(jnp.asarray(x, jnp.bfloat16), jax_tree(blk['conv2']),
                                 jax_tree(blk['bn2']), jax_tree(st['bn2']), padding=1)
    got = tresnet._conv_bn_eval(nchw(x).bfloat16(), blk['conv2'], blk['bn2'], st['bn2'],
                                padding=1)
    assert got.dtype == torch.bfloat16
    close(got, np.asarray(want, np.float32), atol=0.05, nhwc=True)


def test_fpn_matches():
    gen = torch.Generator().manual_seed(4)
    chans = (32, 64, 128, 256)
    p, s = tfpn.init_fpn_params(gen, chans, 16)
    randomize_bn(p, gen)
    randomize_bn(s, gen)
    rng = np.random.default_rng(4)
    feats = [rng.standard_normal((2, 24 // 2 ** i, 32 // 2 ** i, c)).astype(np.float32)
             for i, c in enumerate(chans)]
    want, _ = jfpn.fpn_forward(jax_tree(p), jax_tree(s), [jnp.asarray(f) for f in feats])
    got = tfpn.fpn_forward(p, s, [nchw(f) for f in feats])
    assert len(got) == 5
    for g, w in zip(got, want):
        close(g, w, nhwc=True)


# ---------------------------------------------------------------------------
# anchors and the coder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('canvas', [(192, 256), (832, 1344), (1344, 832)])
def test_anchors_exact(canvas):
    sizes = [(-(-canvas[0] // s), -(-canvas[1] // s)) for s in (4, 8, 16, 32, 64)]
    for got, want in zip(tanchors.AnchorGenerator().grid_anchors(sizes),
                         janchors.AnchorGenerator().grid_anchors(sizes)):
        np.testing.assert_array_equal(got, want)


def test_coder_matches():
    rng = np.random.default_rng(5)
    xy = rng.uniform(0, 200, (50, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(1, 90, (50, 2))], 1).astype(np.float32)
    gts = boxes[::-1] + rng.normal(0, 5, boxes.shape).astype(np.float32)
    deltas = rng.normal(0, 2, (50, 4)).astype(np.float32)
    stds = (0.1, 0.1, 0.2, 0.2)
    tb, tg, td = map(torch.from_numpy, (boxes, np.ascontiguousarray(gts), deltas))
    close(tcoder.encode_deltas(tb, tg, stds=stds),
          jcoder.encode_deltas(boxes, gts, stds=stds), atol=1e-5)
    close(tcoder.decode_deltas(tb, td, stds=stds),
          jcoder.decode_deltas(boxes, deltas, stds=stds), atol=1e-5)
    close(tcoder.pairwise_iou(tb, tg), jcoder.pairwise_iou(boxes, gts), atol=1e-5)
    hw = np.asarray([150.0, 170.0], np.float32)
    close(tcoder.clip_boxes(tb, torch.from_numpy(hw)), jcoder.clip_boxes(boxes, hw), atol=0)


# ---------------------------------------------------------------------------
# NMS: identical keep sets
# ---------------------------------------------------------------------------


def _boxes(rng, n, clustered=False, span=300.0):
    if clustered:
        centers = rng.uniform(0, span * 0.6, (6, 2))
        xy = centers[rng.integers(0, 6, n)] + rng.normal(0, 4, (n, 2))
        wh = rng.uniform(20, 40, (n, 2))
    else:
        xy = rng.uniform(0, span, (n, 2))
        wh = rng.uniform(5, 80, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _nms_case(name):
    rng = np.random.default_rng(6)
    if name == 'random':
        return _boxes(rng, 300), rng.random(300).astype(np.float32), 0.5, 100
    if name == 'clustered':
        return _boxes(rng, 300, True), rng.random(300).astype(np.float32), 0.5, 1000
    if name == 'more_than_max_out':
        return _boxes(rng, 400), rng.random(400).astype(np.float32), 0.7, 20
    if name == 'ties':
        scores = np.round(rng.random(200) * 4).astype(np.float32) / 4
        return _boxes(rng, 200, True), scores, 0.5, 100
    if name == 'invalid':
        scores = rng.random(100).astype(np.float32)
        scores[rng.random(100) < 0.4] = tnms.NEG_INF
        return _boxes(rng, 100, True), scores, 0.5, 100
    if name == 'chain':
        boxes = np.asarray([[0, 0, 10, 10], [4, 0, 14, 10], [9, 0, 19, 10]], np.float32)
        return boxes, np.asarray([0.9, 0.8, 0.7], np.float32), 0.3, 3
    if name == 'oscillating':  # tests/test_det_ops.py: the 2-cycle input
        rng = np.random.default_rng(0)
        return (rng.uniform(0, 50000, (3250, 4)).astype(np.float32),
                rng.random(3250).astype(np.float32), 0.5, 300)
    if name == 'nan_box':  # the highest-scored box is NaN: it suppresses nothing
        boxes = np.asarray([[np.nan] * 4, [0, 0, 10, 10], [20, 20, 30, 30]], np.float32)
        return boxes, np.asarray([0.9, 0.8, 0.7], np.float32), 0.5, 3
    if name == 'nan_scattered':
        return (_nan_boxes(rng, _boxes(rng, 300, True)), rng.random(300).astype(np.float32),
                0.5, 300)
    raise KeyError(name)


def _nan_boxes(rng, boxes, every=7):
    """``boxes`` with one coordinate (x0, y0, x1, y1 in turn) of every
    ``every``-th box NaN, and one box NaN whole."""
    boxes = boxes.copy()
    rows = np.arange(rng.integers(0, every), len(boxes), every)
    boxes[rows, np.arange(len(rows)) % 4] = np.nan
    boxes[rng.integers(0, len(boxes))] = np.nan
    return boxes


NMS_CASES = ['random', 'clustered', 'more_than_max_out', 'ties', 'invalid', 'chain',
             'oscillating', 'nan_box', 'nan_scattered']


@pytest.mark.parametrize('case', NMS_CASES)
def test_nms_keep_sets_identical(case):
    boxes, scores, thr, max_out = _nms_case(case)
    j_idx, j_valid = jax.jit(lambda b, s: jnms.nms(b, s, thr, max_out))(
        jnp.asarray(boxes), jnp.asarray(scores))
    t_idx, t_valid = tnms.nms(torch.from_numpy(boxes), torch.from_numpy(scores), thr, max_out)
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(j_valid))
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    if case == 'chain':
        assert list(t_idx.numpy()[t_valid.numpy()]) == [0, 2]
    if case == 'nan_box':
        assert list(t_idx.numpy()[t_valid.numpy()]) == [0, 1, 2]


@pytest.mark.parametrize('case', ['random', 'clustered', 'ties'])
def test_batched_nms_keep_sets_identical(case):
    boxes, scores, _, max_out = _nms_case(case)
    ids = np.random.default_rng(7).integers(0, 5, len(boxes)).astype(np.int32)
    j_idx, j_valid = jnms.batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                      jnp.asarray(ids), 0.7, max_out)
    t_idx, t_valid = tnms.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                                      torch.from_numpy(ids), 0.7, max_out)
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(j_valid))
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))


def _mc_case(name):
    rng = np.random.default_rng(8)
    c, n = {'shared': (65, 150), 'per_class_boxes': (65, 60), 'lvis_1203': (1203, 24),
            'ties': (20, 100), 'no_survivors': (65, 50), 'few_candidates': (3, 40),
            'nan_boxes': (20, 100)}[name]
    boxes = _boxes(rng, n, clustered=True)
    if name == 'per_class_boxes':
        boxes = np.concatenate([_boxes(rng, n, clustered=True) for _ in range(c)], 1)
    if name == 'nan_boxes':  # NaN boxes among the candidates, with finite scores
        boxes = _nan_boxes(rng, boxes)
    scores = (rng.random((n, c + 1)) ** 4).astype(np.float32)
    scores[rng.random((n, c + 1)) < 0.3] = 0.0
    if name == 'ties':
        scores = np.round(scores * 3) / 3
    if name == 'no_survivors':
        scores[:, :c] = 0.0  # strict > score_thr drops exact zeros
    return boxes, scores.astype(np.float32), c, (500 if name == 'few_candidates' else 100)


@pytest.mark.parametrize('case', ['shared', 'per_class_boxes', 'lvis_1203', 'ties',
                                  'no_survivors', 'few_candidates', 'nan_boxes'])
def test_multiclass_nms_identical(case):
    boxes, scores, c, max_per_img = _mc_case(case)
    want = jnms.multiclass_nms(jnp.asarray(boxes), jnp.asarray(scores), 0.0, 0.5,
                               max_per_img, c)
    got = tnms.multiclass_nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.0, 0.5,
                              max_per_img, c)
    for g, w in zip(got, want):  # dets, labels, rows, valid
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if case == 'no_survivors':
        assert not got[3].any()
    if case == 'nan_boxes':  # kept, and in the top max_per_img
        assert np.isnan(got[0][:, :4].numpy()).any()


@pytest.mark.parametrize('case', ['lvis_1203', 'per_class_boxes'])
def test_multiclass_nms_class_chunks_identical(case, monkeypatch):
    """Classes taken in chunks (the port's ``_BLOCK_ELEMENTS`` cut to 100
    classes a chunk, ``oadp_tpu``'s ``class_chunk`` to 128, its scan path):
    the same keep sets as in one go."""
    boxes, scores, c, max_per_img = _mc_case(case)
    n = scores.shape[0]
    want = jnms.multiclass_nms(jnp.asarray(boxes), jnp.asarray(scores), 0.0, 0.5,
                               max_per_img, c, class_chunk=128 if c > 128 else 16)
    monkeypatch.setattr(tnms, '_BLOCK_ELEMENTS', n * n * (100 if c > 100 else 7))
    got = tnms.multiclass_nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.0, 0.5,
                              max_per_img, c)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# greedy_keep_sorted: the kernel's function, its IoU order and its scan
# ---------------------------------------------------------------------------


def _sorted_problem(boxes, scores):
    order = np.argsort(-scores.astype(np.float32), kind='stable')
    return boxes[order], scores[order] > tnms.NEG_INF / 2, order


@pytest.mark.parametrize('cap', ['max_out', 'half'])
@pytest.mark.parametrize('case', NMS_CASES + ['all_dead'])
def test_greedy_keep_sorted_matches_reference_nms(case, cap):
    """The first ``max_keep`` of the greedy set on the CPU are
    ``oadp_tpu``'s ``nms`` keeps at ``max_out = max_keep``, also with the cap
    below the keep count."""
    if case == 'all_dead':
        boxes, scores, thr, max_out = _nms_case('random')
        scores = np.full_like(scores, tnms.NEG_INF)
    else:
        boxes, scores, thr, max_out = _nms_case(case)
    sboxes, alive, order = _sorted_problem(boxes, scores)
    full = tnms.greedy_keep_sorted(torch.from_numpy(sboxes)[None], torch.from_numpy(alive)[None],
                                   thr, len(boxes))[0].numpy()
    max_keep = max_out if cap == 'max_out' else max(1, int(full.sum()) // 2)
    got = tnms.greedy_keep_sorted(torch.from_numpy(sboxes)[None], torch.from_numpy(alive)[None],
                                  thr, max_keep)[0].numpy()
    j_idx, j_valid = jax.jit(lambda b, s: jnms.nms(b, s, thr, max_keep))(
        jnp.asarray(boxes), jnp.asarray(scores))
    np.testing.assert_array_equal(order[got], np.asarray(j_idx)[np.asarray(j_valid)])
    assert got.sum() == min(max_keep, full.sum())
    if case == 'all_dead':
        assert not full.any()


@pytest.mark.parametrize('case', ['shared', 'per_class_boxes', 'lvis_1203', 'ties',
                                  'no_survivors', 'few_candidates', 'nan_boxes'])
def test_greedy_keep_sorted_matches_reference_multiclass(case):
    """Per-class keep sets (shared boxes read through ``order``, or each
    class's own boxes) equal ``oadp_tpu``'s ``_sorted_block_nms_lazy``,
    whole and cut to ``max_per_img``."""
    boxes, scores, c, max_per_img = _mc_case(case)
    n = scores.shape[0]
    sc = np.where(scores[:, :c] > 0.0, scores[:, :c], tnms.NEG_INF).T.astype(np.float32)
    order = np.argsort(-sc, axis=-1, kind='stable')
    sc_sorted = np.take_along_axis(sc, order, -1)
    if boxes.shape[1] == 4:
        sboxes = boxes[order]
        got = tnms.greedy_keep_sorted(torch.from_numpy(boxes), torch.from_numpy(
            sc_sorted > tnms.NEG_INF / 2), 0.5, n, order=torch.from_numpy(order))
    else:
        sboxes = np.take_along_axis(boxes.reshape(n, c, 4).transpose(1, 0, 2),
                                    order[..., None], 1)
        got = tnms.greedy_keep_sorted(torch.from_numpy(sboxes), torch.from_numpy(
            sc_sorted > tnms.NEG_INF / 2), 0.5, n)
    want = np.asarray(jnms._sorted_block_nms_lazy(jnp.asarray(sboxes), jnp.asarray(sc_sorted),
                                                  0.5, 64))
    np.testing.assert_array_equal(got.numpy(), want)
    capped = tnms.greedy_keep_sorted(torch.from_numpy(sboxes), torch.from_numpy(
        sc_sorted > tnms.NEG_INF / 2), 0.5, max_per_img).numpy()
    np.testing.assert_array_equal(capped, want & (np.cumsum(want, -1) <= max_per_img))


def _nan_max(a, b):
    """``csrc/nms.cu:nan_max``, ``a > b || a != a ? a : b``."""
    return np.where((a > b) | (a != a), a, b)


def _nan_min(a, b):
    """``csrc/nms.cu:nan_min``, ``a < b || a != a ? a : b``."""
    return np.where((a < b) | (a != a), a, b)


def _area_np(b):
    zero = np.float32(0)
    return _nan_max(b[..., 2] - b[..., 0], zero) * _nan_max(b[..., 3] - b[..., 1], zero)


def _iou_kernel_order(a, b):
    """``csrc/nms.cu``'s IoU in numpy fp32 with the kernel's helpers
    (``box_area``, ``suppresses``), one rounding an operation, in its
    order: clamped overlap, inter, union ``(area_a + area_b) - inter``
    floored at 1e-6, one division; 0 where inter is 0 (a NaN inter is
    not)."""
    zero = np.float32(0)
    w = _nan_max(_nan_min(a[:, None, 2], b[None, :, 2]) - _nan_max(a[:, None, 0], b[None, :, 0]),
                 zero)
    h = _nan_max(_nan_min(a[:, None, 3], b[None, :, 3]) - _nan_max(a[:, None, 1], b[None, :, 1]),
                 zero)
    inter = w * h
    union = _nan_max((_area_np(a)[:, None] + _area_np(b)[None]) - inter, np.float32(1e-6))
    with np.errstate(divide='ignore', invalid='ignore'):
        return np.where(inter == 0, zero, inter / union)


def _near_threshold_pairs(rng, thr, n=4000):
    """Box pairs whose IoU sits at the threshold: b is a shifted along x
    by the shift that gives IoU = thr for equal boxes, plus a few ulps."""
    a = _boxes(rng, n, span=1000.0)
    w = a[:, 2] - a[:, 0]
    shift = w * (1 - thr) / (1 + thr)
    b = a.copy()
    b[:, [0, 2]] += (shift * (1 + rng.integers(-4, 5, n) * 2e-7))[:, None].astype(np.float32)
    return a, b


@pytest.mark.parametrize('thr', [0.3, 0.5, 0.7])
def test_kernel_iou_order_is_pair_iou_bit_for_bit(thr):
    rng = np.random.default_rng(21)
    a, b = _near_threshold_pairs(rng, thr)
    pairs = [(a, b), (_boxes(rng, 300, True), _boxes(rng, 200, True)),
             (_nan_boxes(rng, _boxes(rng, 300, True)), _nan_boxes(rng, _boxes(rng, 200, True)))]
    near = 0
    for x, y in pairs:
        want = tnms._pair_iou(torch.from_numpy(x), torch.from_numpy(y)).numpy()
        got = _iou_kernel_order(x, y)
        np.testing.assert_array_equal(got, want)  # NaN where want is NaN
        np.testing.assert_array_equal(got > np.float32(thr),
                                      (tnms._pair_iou(torch.from_numpy(x), torch.from_numpy(y))
                                       > thr).numpy())
        near += int((np.abs(got - np.float32(thr)) <= 4e-7).sum())
    assert near >= 100  # the pairs do reach the threshold's last bits


def _kernel_model(sboxes, alive, thr, max_keep, cl=1, tile=64):
    """``csrc/nms.cu``'s walk in numpy for a cluster of ``cl`` blocks and
    ``tile`` candidates a tile: the kept list dealt round-robin over the
    blocks' slices (kept candidate g in slice g % cl), each slice's hits on
    the tile's alive columns OR-ed into one word, the tile's column words
    (bit i of column j: i < j, both alive, i suppresses j), and the tile
    decided as every block decides it, in passes: keep each undecided
    column that no kept or undecided column before it suppresses, drop each
    one that a kept column suppresses, until none is undecided; the kept
    columns past ``max_keep`` cut, the rest dealt to the slices in order.
    The walk ends after the last alive candidate or at ``max_keep``."""
    n = len(alive)
    sup = _iou_kernel_order(sboxes, sboxes) > np.float32(thr)
    end = int(np.flatnonzero(alive)[-1]) + 1 if alive.any() else 0
    keep, slices, count = np.zeros(n, bool), [[] for _ in range(cl)], 0
    base = 0
    while base < end and count < max_keep:
        cols = np.arange(base, min(base + tile, n))
        live = alive[cols]
        hit = np.zeros(len(cols), bool)
        for kept_slice in slices:
            hit |= live & sup[np.ix_(kept_slice, cols)].any(0)
        words = (sup[np.ix_(cols, cols)] & np.triu(np.ones((len(cols),) * 2, bool), 1)
                 & live[:, None] & live[None, :])  # [i, j]
        und, kept = live & ~hit, np.zeros(len(cols), bool)
        while und.any():
            by_kept = (words & kept[:, None]).any(0)
            by_und = (words & und[:, None]).any(0)
            new_kept, dropped = und & ~by_kept & ~by_und, und & by_kept
            assert new_kept.any() or dropped.any()  # the first undecided is decided
            kept |= new_kept
            und &= ~(new_kept | dropped)
        kept &= np.cumsum(kept) <= max_keep - count
        for j in np.flatnonzero(kept):
            slices[count % cl].append(base + j)
            count += 1
        keep[cols] = kept
        base += tile
    return keep


def _scan_case(name, n, rng):
    alive = np.ones(n, bool)
    thr = 0.5
    if name == 'clustered':
        boxes = _boxes(rng, n, clustered=True)
    elif name == 'chain':  # each box suppresses the next only: every other kept
        x = np.arange(n, dtype=np.float32)[:, None] * 4
        boxes = np.concatenate([x, 0 * x, x + 10, 0 * x + 10], 1).astype(np.float32)
        thr = 0.3
    elif name == 'identical':
        boxes = np.tile(np.asarray([[5, 5, 25, 30]], np.float32), (n, 1))
    elif name == 'zero_area':
        boxes = _boxes(rng, n, clustered=True)
        boxes[::2, 2] = boxes[::2, 0]  # x1 == x0
        boxes[1::3] = boxes[1::3, :1].repeat(4, 1)  # points
    elif name == 'holes':  # dead candidates inside the alive range
        boxes = _boxes(rng, n, clustered=True)
        alive = rng.random(n) > 0.3
    elif name == 'all_dead':
        boxes = _boxes(rng, n)
        alive[:] = False
    elif name == 'nan':  # NaN coordinates: such a box suppresses nothing
        boxes = _nan_boxes(rng, _boxes(rng, n, clustered=True))
    else:
        raise KeyError(name)
    return boxes, alive, thr


SCAN_CASES = ['clustered', 'chain', 'identical', 'zero_area', 'holes', 'all_dead', 'nan']


@pytest.mark.parametrize('n', [1, 63, 64, 65, 127, 128, 129, 300])
@pytest.mark.parametrize('case', SCAN_CASES)
def test_kernel_scan_model_matches_greedy_keep(case, n):
    rng = np.random.default_rng(n)
    boxes, alive, thr = _scan_case(case, n, rng)
    want = tnms.greedy_keep_sorted_plain(torch.from_numpy(boxes)[None],
                                         torch.from_numpy(alive)[None], thr, n)[0].numpy()
    np.testing.assert_array_equal(_kernel_model(boxes, alive, thr, n), want)
    cap = max(1, int(want.sum()) // 3)
    np.testing.assert_array_equal(_kernel_model(boxes, alive, thr, cap),
                                  want & (np.cumsum(want) <= cap))
    if case == 'chain':
        assert want[::2].all() and not want[1::2].any()
    if case == 'identical':
        assert want.sum() == 1


@pytest.mark.parametrize('tile', [64, 128])
@pytest.mark.parametrize('cl', [1, 2, 8, 16])
@pytest.mark.parametrize('case', SCAN_CASES)
def test_cluster_walk_model_matches_greedy_keep(case, cl, tile):
    """The kernel's walk for a problem spread over a cluster of ``cl``
    blocks equals the greedy keep set, whole and cut to ``max_keep``."""
    for n in (1, 63, 64, 65, 129, 300):
        rng = np.random.default_rng(n + 7 * cl)
        boxes, alive, thr = _scan_case(case, n, rng)
        want = tnms.greedy_keep_sorted_plain(torch.from_numpy(boxes)[None],
                                             torch.from_numpy(alive)[None], thr, n)[0].numpy()
        np.testing.assert_array_equal(_kernel_model(boxes, alive, thr, n, cl, tile), want)
        for cap in {1, max(1, int(want.sum()) // 3), max(1, int(want.sum()) - 1)}:
            np.testing.assert_array_equal(_kernel_model(boxes, alive, thr, cap, cl, tile),
                                          want & (np.cumsum(want) <= cap), err_msg=f'{n} {cap}')


def test_grouped_plain_matches_per_image_loop(monkeypatch):
    """Shared box sets (one an image, ``P // S`` classes each) in one call
    of the plain version equal the call image by image, also when its
    blocks of problems straddle images."""
    rng = np.random.default_rng(12)
    b, c, n = 3, 5, 70
    boxes = np.stack([_boxes(rng, n, clustered=True) for _ in range(b)])
    boxes[2] = _nan_boxes(rng, boxes[2])
    order = np.argsort(-rng.random((b * c, n)), axis=-1, kind='stable')
    alive = rng.random((b * c, n)) > 0.2
    alive[c:2 * c] = False  # an image with no alive candidate
    args = [torch.from_numpy(x) for x in (boxes, alive, order)]
    for cap in (n, 9):
        want = torch.cat([tnms.greedy_keep_sorted_plain(
            args[0][i], args[1][i * c:(i + 1) * c], 0.5, cap, order=args[2][i * c:(i + 1) * c])
            for i in range(b)])
        got = tnms.greedy_keep_sorted(args[0], args[1], 0.5, cap, order=args[2])
        assert torch.equal(got, want)
        monkeypatch.setattr(tnms, '_BLOCK_ELEMENTS', n * n * 3)  # 3 problems a block
        assert torch.equal(tnms.greedy_keep_sorted_plain(args[0], args[1], 0.5, cap,
                                                         order=args[2]), want)
        monkeypatch.undo()
    assert not want[c:2 * c].any() and want.any()


def _batch(rng, case, b=3, n=200):
    """A batch of ``b`` images' boxes ``(b, n, 4)`` and scores ``(b, n)``:
    ``dead`` has no alive candidate in image 1, ``nan`` NaN boxes in image
    2 only."""
    boxes = np.stack([_boxes(rng, n, clustered=i % 2 == 0) for i in range(b)])
    scores = rng.random((b, n)).astype(np.float32)
    if case == 'dead':
        scores[1] = tnms.NEG_INF
    if case == 'nan':
        boxes[2] = _nan_boxes(rng, boxes[2])
    return boxes, scores


@pytest.mark.parametrize('case', ['plain', 'dead', 'nan'])
def test_batched_nms_matches_vmap(case):
    """``nms`` and ``batched_nms`` over a batch of 3 equal ``jax.vmap`` of
    ``oadp_tpu``'s, and the port's own calls image by image."""
    rng = np.random.default_rng(13)
    boxes, scores = _batch(rng, case)
    ids = rng.integers(0, 5, scores.shape).astype(np.int32)
    tb, ts, ti = (torch.from_numpy(x) for x in (boxes, scores, ids))
    for thr, max_out in ((0.5, 60), (0.7, 250)):
        want = jax.vmap(lambda b, s: jnms.nms(b, s, thr, max_out))(boxes, scores)
        got = tnms.nms(tb, ts, thr, max_out)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        for i in range(len(boxes)):
            assert all(torch.equal(g[i], w) for g, w in zip(got, tnms.nms(tb[i], ts[i], thr,
                                                                           max_out)))
        want = jax.vmap(lambda b, s, d: jnms.batched_nms(b, s, d, thr, max_out))(
            boxes, scores, ids)
        got = tnms.batched_nms(tb, ts, ti, thr, max_out)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if case == 'dead':
        assert not got[1][1].any() and got[1][0].any()


@pytest.mark.parametrize('case', ['shared', 'per_class', 'dead', 'nan'])
def test_batched_multiclass_nms_matches_vmap(case):
    """``multiclass_nms`` over a batch of 3 (shared or per-class boxes, an
    image with no candidate above the threshold, NaN boxes in one image)
    equals ``jax.vmap`` of ``oadp_tpu``'s and the port image by image."""
    rng = np.random.default_rng(14)
    b, n, c = 3, 80, 8
    boxes = np.stack([_boxes(rng, n, clustered=True) for _ in range(b)])
    if case == 'per_class':
        boxes = np.concatenate([boxes + rng.normal(0, 3, boxes.shape).astype(np.float32)
                                for _ in range(c)], -1)
    if case == 'nan':
        boxes[2] = _nan_boxes(rng, boxes[2])
    scores = (rng.random((b, n, c + 1)) ** 3).astype(np.float32)
    scores[rng.random(scores.shape) < 0.3] = 0.0
    if case == 'dead':
        scores[0, :, :c] = 0.0
    want = jax.vmap(lambda x, y: jnms.multiclass_nms(x, y, 0.0, 0.5, 50, c))(boxes, scores)
    tb, ts = torch.from_numpy(boxes), torch.from_numpy(scores)
    got = tnms.multiclass_nms(tb, ts, 0.0, 0.5, 50, c)
    for g, w in zip(got, want):  # dets, labels, rows, valid
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for i in range(b):
        one = tnms.multiclass_nms(tb[i], ts[i], 0.0, 0.5, 50, c)
        for g, w in zip(got, one):
            np.testing.assert_array_equal(g[i].numpy(), w.numpy())
    if case == 'dead':
        assert not got[3][0].any() and got[3][1].any()
    if case == 'nan':
        assert np.isnan(got[0][2, :, :4].numpy()).any()
        assert not np.isnan(got[0][:2].numpy()).any()


@pytest.mark.parametrize('images', [None, 1, 3])
def test_entry_points_hand_the_kernel_contiguous_tensors(images, monkeypatch):
    """What ``nms``, ``batched_nms`` and ``multiclass_nms`` (shared and
    per-class boxes) pass to ``greedy_keep_sorted`` is what the kernel
    takes: contiguous, of its types, one call a batch (``images``: None for
    one image without a batch dimension)."""
    seen = []
    keep_fn = tnms.greedy_keep_sorted

    def capture(*a, **k):
        seen.append((a, k))
        return keep_fn(*a, **k)

    monkeypatch.setattr(tnms, 'greedy_keep_sorted', capture)
    rng = np.random.default_rng(15)
    b = images or 1
    boxes = torch.from_numpy(np.stack([_boxes(rng, 90, True) for _ in range(b)]))
    scores = torch.from_numpy(rng.random((b, 90, 6)).astype(np.float32))
    per_class = boxes.repeat(1, 1, 5)
    ids = torch.from_numpy(rng.integers(0, 3, (b, 90)).astype(np.int32))
    one = (lambda t: t[0]) if images is None else (lambda t: t)
    tnms.nms(one(boxes), one(scores[..., 0]), 0.5, 40)
    tnms.batched_nms(one(boxes), one(scores[..., 0]), one(ids), 0.5, 40)
    tnms.multiclass_nms(one(boxes), one(scores), 0.0, 0.5, 40, 5)
    tnms.multiclass_nms(one(per_class), one(scores), 0.0, 0.5, 40, 5)
    assert len(seen) == 4
    for a, k in seen:
        bx, alive = a[0], a[1]
        order = k.get('order')
        for t in (bx, alive) + (() if order is None else (order,)):
            assert t.is_contiguous(), (tuple(t.shape), t.stride())
        assert bx.dtype == torch.float32 and alive.dtype == torch.bool
        assert order is None or order.dtype == torch.int64


def test_nms_plan_at_main_path_shapes():
    """Few problems (the RPN's, one an image) take a cluster each, as wide
    as the card holds them side by side; many (a batch's images x classes)
    a block each; every plan is one the kernel is built for."""
    sms = 132
    for p, n in ((1, 8819), (2, 8819), (2, 4819)):  # train; test (1000 a level)
        plan = tnms.nms_plan(p, n, sms)
        assert plan.cluster == 16 and plan.threads == 1024 and plan.tile == 128
    assert tnms.nms_plan(1, 1000, sms) == tnms.NmsPlan(1, 1024, 128)  # OV-COCO, one image
    assert tnms.nms_plan(65, 1000, sms) == tnms.NmsPlan(1, 1024, 128)
    assert tnms.nms_plan(32 * 65, 1000, sms) == tnms.NmsPlan(1, 128, 64)  # a rescore batch
    for p in (1203, 2 * 1203):  # OV-LVIS
        assert tnms.nms_plan(p, 1000, sms).cluster == 1
    for p in (1, 2, 3, 7, 33, 65, 66, 130, 133, 300, 2080, 2406, 10 ** 5):
        for n in (1, 64, 65, 1000, 2048, 8819):
            plan = tnms.nms_plan(p, n, sms)
            assert plan in tnms.NMS_PLANS, (p, n)
            assert plan.cluster == 1 or p * plan.cluster <= sms  # side by side
    assert tnms.nms_plan(2, 50, sms).cluster == 1  # one tile: nothing to spread


def test_greedy_keep_sorted_checks_before_building():
    """Shapes and types are refused before the kernel is built; a CPU
    tensor takes the plain version and launches nothing."""
    tnms.reset_launches()
    boxes = torch.zeros((2, 5, 4), device='meta')
    with pytest.raises(ValueError):
        tnms.greedy_keep_sorted(boxes, torch.zeros((2, 6), dtype=torch.bool, device='meta'),
                                0.5, 3)
    with pytest.raises(TypeError):
        tnms.greedy_keep_sorted(boxes.double(), torch.zeros((2, 5), dtype=torch.bool,
                                                            device='meta'), 0.5, 3)
    with pytest.raises(ValueError):
        tnms.greedy_keep_sorted(boxes[0], torch.zeros((2, 5), dtype=torch.bool, device='meta'),
                                0.5, 3, order=torch.zeros((2, 4), dtype=torch.int64,
                                                          device='meta'))
    b, s, thr, max_out = _nms_case('clustered')
    tnms.nms(torch.from_numpy(b), torch.from_numpy(s), thr, max_out)
    assert tnms.LAUNCHES == {'greedy_nms': 0}


@pytest.mark.cuda
def test_greedy_nms_kernel_matches_plain_on_card():
    """The kernel against the plain version on the card: identical keep
    sets over random, clustered and adversarial problems, capped and not,
    for sorted and shared (``order``, one set or one an image) boxes, under
    every plan it is built for, and the three entry points on batches."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    dev = torch.device('cuda')
    rng = np.random.default_rng(5)
    for case in SCAN_CASES:
        # 9000 uncapped: a block's kept list past shared memory, in a workspace
        for n in [1, 63, 64, 65, 129, 2049, 5000] + [9000] * (case in ('clustered', 'identical')):
            boxes, alive, thr = _scan_case(case, n, rng)
            for cap in (n, max(1, n // 7)):
                args = (torch.from_numpy(boxes)[None].to(dev), torch.from_numpy(alive)[None].to(dev),
                        thr, cap)
                want = tnms.greedy_keep_sorted_plain(*args)
                assert torch.equal(tnms.greedy_keep_sorted(*args), want), (case, n, cap)
                for plan in tnms.NMS_PLANS if n in (129, 5000) else ():
                    assert torch.equal(tnms._greedy_nms(*args, plan=plan), want), (case, n, plan)
    for b, c, n in [(1, 65, 1000), (1, 300, 300), (3, 20, 500)]:
        boxes = torch.from_numpy(np.stack([_boxes(rng, n, clustered=True) for _ in range(b)]))
        boxes = boxes.to(dev)
        sc = torch.from_numpy(rng.random((b * c, n)).astype(np.float32)).to(dev)
        order = torch.sort(-sc, dim=-1, stable=True).indices
        alive = torch.from_numpy(rng.random((b * c, n)) > 0.2).to(dev)
        for cap in (n, 100):
            want = tnms.greedy_keep_sorted_plain(boxes, alive, 0.5, cap, order=order)
            for plan in (None,) + tnms.NMS_PLANS:
                got = tnms._greedy_nms(boxes, alive, 0.5, cap, order=order, plan=plan)
                assert torch.equal(got, want), (b, c, n, cap, plan)
    for case in NMS_CASES:
        b, s, thr, max_out = _nms_case(case)
        want = tnms.nms(torch.from_numpy(b), torch.from_numpy(s), thr, max_out)
        got = tnms.nms(torch.from_numpy(b).to(dev), torch.from_numpy(s).to(dev), thr, max_out)
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want)), case
    for case in ('plain', 'dead', 'nan'):
        b, s = _batch(rng, case)
        ids = torch.from_numpy(rng.integers(0, 5, s.shape).astype(np.int32))
        cpu = (torch.from_numpy(b), torch.from_numpy(s), ids)
        tnms.reset_launches()
        got = tnms.batched_nms(*(t.to(dev) for t in cpu), 0.7, 150)
        assert tnms.LAUNCHES['greedy_nms'] == 1, case  # one launch a batch
        want = tnms.batched_nms(*cpu, 0.7, 150)
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want)), case
    seen = set()
    for case in ['shared', 'per_class_boxes', 'lvis_1203', 'ties', 'nan_boxes'] * 2:
        b, s, c, m = _mc_case(case)
        if case in seen:  # the second time, a batch of three
            b = np.stack([b, b[::-1].copy(), b])
            s = np.stack([s, s[::-1].copy(), np.zeros_like(s)])
        seen.add(case)
        want = tnms.multiclass_nms(torch.from_numpy(b), torch.from_numpy(s), 0.0, 0.5, m, c)
        tnms.reset_launches()
        got = tnms.multiclass_nms(torch.from_numpy(b).to(dev), torch.from_numpy(s).to(dev),
                                  0.0, 0.5, m, c)
        assert tnms.LAUNCHES['greedy_nms'] == 1, case
        for g, w in zip(got, want):  # NaN boxes come out where they went in
            g = g.cpu()
            assert g.shape == w.shape and g.dtype == w.dtype, case
            assert torch.equal(g, w) or bool(((g == w) | (g.isnan() & w.isnan())).all()), case
    torch.cuda.synchronize()


def _rpn_card_call(gen, dev):
    """The arguments of ``rpn_proposals``' one ``batched_nms`` call over a
    train step's two images at the OV-COCO train canvas (832 x 1344),
    from random logits and deltas: the top 2000 of each level, 8,819
    candidates an image, IoU 0.7, 1000 kept."""
    canvas = (832, 1344)
    sizes = [(-(-canvas[0] // s), -(-canvas[1] // s)) for s in (4, 8, 16, 32, 64)]
    anchors = [torch.from_numpy(a).float().to(dev)
               for a in tanchors.AnchorGenerator().grid_anchors(sizes)]
    scores = [torch.randn(2, len(a), device=dev, generator=gen) for a in anchors]
    deltas = [0.2 * torch.randn(2, len(a), 4, device=dev, generator=gen) for a in anchors]
    calls, entry = [], trpn.batched_nms
    trpn.batched_nms = lambda *a: calls.append(a) or entry(*a)
    try:
        trpn.rpn_proposals(scores, deltas, anchors, torch.tensor([(800, 1199), (800, 1333)],
                                                                 device=dev),
                           nms_pre=2000, max_per_img=1000, iou_threshold=0.7)
    finally:
        trpn.batched_nms = entry
    (call,) = calls
    return call


def _det_card_inputs(gen, dev, classes: int, per_class: bool, n: int = 1000):
    """A detector's ``n`` decoded boxes on an 800 x 1199 image, clustered
    round 40 objects, and softmax scores over ``classes`` + background,
    zero on 5% of the rows (proposals that were not valid)."""
    centre = torch.rand(40, 2, device=dev, generator=gen) * torch.tensor([1199., 800.], device=dev)
    size = 30 + 270 * torch.rand(40, 2, device=dev, generator=gen)
    k = torch.randint(0, 40, (n,), device=dev, generator=gen)
    jitter = 1 + 0.15 * torch.randn(n, 2, device=dev, generator=gen)
    c, sz = centre[k], size[k] * jitter
    boxes = torch.cat([c - sz / 2, c + sz / 2], 1).clamp(min=0)
    if per_class:
        boxes = (boxes[:, None] + 4 * torch.randn(n, classes, 4, device=dev, generator=gen)
                 ).clamp(min=0).reshape(n, classes * 4)
    scores = torch.softmax(2 * torch.randn(n, classes + 1, device=dev, generator=gen), -1)
    scores = scores * (torch.rand(n, 1, device=dev, generator=gen) > 0.05)
    return boxes, scores


def _nms_adversarial_call(name, gen, dev):
    """``nms`` arguments (boxes, scores, iou, max_out) that stress the scan."""
    def clustered(n):
        return _det_card_inputs(gen, dev, 1, False, n)[0]

    def rand(n):
        return torch.rand(n, device=dev, generator=gen)

    nan = float('nan')
    if name == 'nan_box':  # its IoU with every box is NaN: it suppresses nothing
        return (torch.tensor([[nan] * 4, [0, 0, 10, 10], [20, 20, 30, 30]], device=dev),
                torch.tensor([0.9, 0.8, 0.7], device=dev), 0.5, 3)
    if name == 'nan_boxes':  # one coordinate of every 7th box, and one box whole
        boxes = clustered(1000)
        rows = torch.arange(3, 1000, 7, device=dev)
        boxes[rows, rows % 4] = nan
        boxes[500] = nan
        return boxes, rand(1000), 0.5, 1000
    if name == 'chain_2000':  # each box suppresses the next
        x = 4 * torch.arange(2000, device=dev, dtype=torch.float32)[:, None]
        return (torch.cat([x, 0 * x, x + 10, 0 * x + 10], 1),
                torch.linspace(1, 0, 2000, device=dev), 0.3, 2000)
    if name == 'identical_zero_area':
        boxes = clustered(1000)
        boxes[::2, 2] = boxes[::2, 0]  # zero width
        boxes[1::4] = boxes[1]  # one box, many times
        boxes[3::8] = boxes[3, :1]  # points
        return boxes, rand(1000), 0.5, 1000
    if name.startswith('n_'):
        n = int(name[2:])
        return clustered(n), rand(n), 0.5, n
    return {'ties': lambda: (clustered(1000), torch.round(4 * rand(1000)) / 4, 0.5, 1000),
            'all_dead': lambda: (clustered(1000), torch.full((1000,), tnms.NEG_INF, device=dev),
                                 0.5, 300),
            'all_alive_capped': lambda: (clustered(1000), rand(1000), 0.5, 50)}[name]()


#: (classes, boxes a class, images) of the ``multiclass_nms`` cases
_MULTICLASS = {'ov_coco': (65, False, 1), 'ov_coco_batch_32': (65, False, 32),
               'ov_lvis': (1203, False, 1), 'ov_lvis_batch_2': (1203, False, 2),
               'ov_lvis_per_class': (1203, True, 1), 'ov_lvis_per_class_batch_2': (1203, True, 2)}
_NMS_CARD = (['rpn_train', 'rpn_train_image_0', 'rpn_train_image_1', *_MULTICLASS,
              'ov_coco_nan_boxes', 'nan_box', 'nan_boxes', 'ties', 'chain_2000',
              'identical_zero_area', 'all_dead', 'all_alive_capped', 'n_1', 'n_63', 'n_64',
              'n_65'])


@pytest.mark.cuda
@pytest.mark.parametrize('name', _NMS_CARD)
def test_greedy_nms_at_main_path_shapes_on_card(name, monkeypatch):
    """Each entry point of ``ops/nms.py`` at the main path's shapes, as
    its callers batch it, on the card: ``rpn_proposals``' one
    ``batched_nms`` call over a train step's two images and each image
    alone (the few long problems on clusters of blocks), ``multiclass_nms``
    at OV-COCO (one image, a 32-image ``rescore`` batch; one image of a
    batch of three with NaN boxes) and OV-LVIS (one and two images, boxes
    shared and per class), and ``nms`` on adversarial cases. The entry's
    outputs equal the same entry's with the plain version on the card
    and on the CPU (but for the batches and OV-LVIS, whose plain passes
    take the CPU minutes), and its kernel call keeps the plain version's
    keep sets."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(_NMS_CARD.index(name))
    cpu = name not in _MULTICLASS or name == 'ov_coco'
    if name.startswith('rpn_train'):
        entry, args = tnms.batched_nms, _rpn_card_call(gen, dev)
        if name != 'rpn_train':
            i = int(name[-1])
            args = tuple(t[i] for t in args[:3]) + args[3:]
    elif name in _MULTICLASS or name == 'ov_coco_nan_boxes':
        classes, per_class, images = _MULTICLASS.get(name, (65, False, 3))
        boxes, scores = (torch.stack(t) for t in zip(*(
            _det_card_inputs(gen, dev, classes, per_class) for _ in range(images))))
        if name == 'ov_coco_nan_boxes':  # NaN boxes with finite scores in the middle image
            rows = torch.arange(0, 1000, 11, device=dev)
            boxes[1, rows, rows % 4] = float('nan')
        if images == 1:
            boxes, scores = boxes[0], scores[0]
        entry, args = tnms.multiclass_nms, (boxes, scores, 0.0, 0.5, 300, classes)
    else:
        entry, args = tnms.nms, _nms_adversarial_call(name, gen, dev)

    def same(a, b):  # a NaN box equal to itself
        for x, y in zip(a, b):
            x, y = x.cpu(), y.cpu()
            assert x.shape == y.shape and x.dtype == y.dtype
            assert torch.equal(x, y) or bool(((x == y) | (x.isnan() & y.isnan())).all())

    calls, kernel = [], tnms.greedy_keep_sorted
    monkeypatch.setattr(tnms, 'greedy_keep_sorted',
                        lambda *a, **k: calls.append((a, k)) or kernel(*a, **k))
    out = entry(*args)
    monkeypatch.setattr(tnms, 'greedy_keep_sorted', tnms.greedy_keep_sorted_plain)
    same(out, entry(*args))
    if cpu:
        same(out, entry(*(t.cpu() if torch.is_tensor(t) else t for t in args)))
    (a, k), = calls
    keep = kernel(*a, **k)
    assert torch.equal(keep, tnms.greedy_keep_sorted_plain(*a, **k))
    if name.startswith('rpn_train'):
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        assert tnms.nms_plan(*a[1].shape, sms).cluster >= 2
    if name == 'nan_box':
        assert int(keep.sum()) == 3


# ---------------------------------------------------------------------------
# RoIAlign
# ---------------------------------------------------------------------------


def _pyramid(rng, c=16, canvas=(96, 128)):
    return [rng.standard_normal((2, canvas[0] // s, canvas[1] // s, c)).astype(np.float32)
            for s in (4, 8, 16, 32, 64)]


def _rois(rng, r=40, canvas=(96, 128)):
    xy = rng.uniform(-20, 110, (2, r, 2))
    wh = rng.uniform(1, 150, (2, r, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize('out_size', [7, 14])
def test_roi_align_matches(out_size):
    rng = np.random.default_rng(9)
    feats, rois = _pyramid(rng), _rois(rng)
    got = troi.roi_align_fpn([nchw(f) for f in feats], torch.from_numpy(rois),
                             out_size=out_size)
    assert got.shape == (2, rois.shape[1], 16, out_size, out_size)
    for i in range(2):
        want = jroi.roi_align_fpn([jnp.asarray(f[i]) for f in feats], jnp.asarray(rois[i]),
                                  out_size=out_size)
        close(got[i].permute(0, 2, 3, 1), want, atol=1e-5)
    np.testing.assert_array_equal(
        troi.assign_fpn_levels(torch.from_numpy(rois[0]), 4).numpy(),
        np.asarray(jroi.assign_fpn_levels(jnp.asarray(rois[0]), 4)))


def test_roi_align_keeps_bf16():
    rng = np.random.default_rng(10)
    feats, rois = _pyramid(rng), _rois(rng)
    got = troi.roi_align_fpn([nchw(f).bfloat16() for f in feats], torch.from_numpy(rois))
    assert got.dtype == torch.bfloat16
    fp32 = troi.roi_align_fpn([nchw(f) for f in feats], torch.from_numpy(rois))
    np.testing.assert_allclose(got.float().numpy(), fp32.numpy(), atol=0.05, rtol=0.02)


# ---------------------------------------------------------------------------
# RPN
# ---------------------------------------------------------------------------


def _rpn_inputs(saturate: bool):
    gen = torch.Generator().manual_seed(11)
    p = trpn.init_rpn_params(gen, 16, 16)
    if saturate:  # sigmoids of +-30 are exactly 1 and 0: ties everywhere
        p['cls']['w'] = p['cls']['w'] * 0
        p['cls']['b'] = torch.tensor([30.0, -30.0, 30.0])
    rng = np.random.default_rng(11)
    feats = _pyramid(rng, canvas=(192, 256))
    return p, feats


@pytest.mark.parametrize('saturate', [False, True], ids=['random', 'saturated_ties'])
def test_rpn_forward_and_proposals_match(saturate):
    p, feats = _rpn_inputs(saturate)
    jp = jax_tree(p)
    j_scores, j_deltas = jrpn.rpn_forward(jp, [jnp.asarray(f) for f in feats])
    t_scores, t_deltas = trpn.rpn_forward(p, [nchw(f) for f in feats])
    for g, w in zip(t_scores + t_deltas, j_scores + j_deltas):
        close(g, w)
    sizes = [(f.shape[1], f.shape[2]) for f in feats]
    anchors = janchors.AnchorGenerator().grid_anchors(sizes)
    hw = np.asarray([[192, 250], [180, 256]], np.float32)
    # the same logits into both: the keep sets must be identical
    want = jrpn.rpn_proposals(j_scores, j_deltas, [jnp.asarray(a) for a in anchors],
                              jnp.asarray(hw), nms_pre=64, max_per_img=32)
    got = trpn.rpn_proposals([torch.from_numpy(np.array(s)) for s in j_scores],
                             [torch.from_numpy(np.array(d)) for d in j_deltas],
                             [torch.from_numpy(a) for a in anchors], torch.from_numpy(hw),
                             nms_pre=64, max_per_img=32)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    close(got[0], want[0], atol=1e-5)
    close(got[1], want[1], atol=1e-6)
    if saturate:
        assert set(np.unique(got[1].numpy()[got[2].numpy()])) <= {1.0, 0.0}


def test_rpn_proposals_one_nms_call_a_batch(monkeypatch):
    """``rpn_proposals`` over three images makes one ``greedy_keep_sorted``
    call of three problems (one ``greedy_nms`` launch on the card), and
    equals its calls image by image."""
    p, feats = _rpn_inputs(False)
    feats = [np.concatenate([f, f[:1] * 0.5]) for f in feats]  # three images
    scores, deltas = trpn.rpn_forward(p, [nchw(f) for f in feats])
    anchors = [torch.from_numpy(a) for a in janchors.AnchorGenerator().grid_anchors(
        [(f.shape[1], f.shape[2]) for f in feats])]
    hw = torch.tensor([[192, 250], [180, 256], [150, 200]], dtype=torch.float32)
    calls = []
    keep_fn = tnms.greedy_keep_sorted
    monkeypatch.setattr(tnms, 'greedy_keep_sorted',
                        lambda *a, **k: calls.append(tuple(a[1].shape)) or keep_fn(*a, **k))
    got = trpn.rpn_proposals(scores, deltas, anchors, hw, nms_pre=64, max_per_img=32)
    assert len(calls) == 1 and calls[0][0] == 3
    for i in range(3):
        one = trpn.rpn_proposals([s[i:i + 1] for s in scores], [d[i:i + 1] for d in deltas],
                                 anchors, hw[i:i + 1], nms_pre=64, max_per_img=32)
        for g, w in zip(got, one):
            assert torch.equal(g[i:i + 1], w)
    assert got[2].any(1).all()


# ---------------------------------------------------------------------------
# heads
# ---------------------------------------------------------------------------


def _head(mode, convs, fcs, reg, suppress, with_bg=True):
    cls = jheads.ClassifierConfig(in_features=32, embedding_dim=32, num_bases=6,
                                  num_all=10, with_bg=with_bg, mode=mode,
                                  scaler=20.0, bias=3.0)
    kw = dict(num_convs=convs, num_fcs=fcs, in_channels=16, conv_channels=16,
              fc_channels=32, with_reg=reg, suppress_bg_logit=suppress)
    tcls = theads.ClassifierConfig(**dataclasses.asdict(cls))
    return jheads.HeadConfig(classifier=cls, **kw), theads.HeadConfig(classifier=tcls, **kw)


@pytest.mark.parametrize('mode,convs,fcs,reg,suppress', [
    ('vild', 4, 1, True, False),  # bbox head
    ('affine', 4, 1, False, True),  # object head, bg logit suppressed
    ('affine', 0, 2, False, False),  # block head
])
def test_convfc_head_matches(mode, convs, fcs, reg, suppress):
    jcfg, tcfg = _head(mode, convs, fcs, reg, suppress)
    gen = torch.Generator().manual_seed(12)
    emb = torch.nn.functional.normalize(torch.randn(10, 32, generator=gen), dim=-1)
    p, s = theads.init_convfc_head(gen, emb, tcfg)
    randomize_bn(p, gen)
    randomize_bn(s, gen)
    jp = jax_tree(p)
    x = np.random.default_rng(12).standard_normal((9, 7, 7, 16)).astype(np.float32)
    jl, jr, jproj, _ = jheads.convfc_forward(jp, jax_tree(s), jnp.asarray(x), jcfg, False)
    tl, tr, tproj = theads.convfc_forward(p, s, nchw(x), tcfg)
    close(tl, jl)
    close(tproj, jproj)
    assert (tr is None) == (jr is None)
    if reg:
        close(tr, jr)
    if suppress:
        assert (tl[:, -1] == tnms.NEG_INF).all()


def test_global_head_matches():
    jcfg, tcfg = _head('affine', 0, 0, False, False, with_bg=False)
    jc = dataclasses.replace(jcfg.classifier, in_features=16)
    tc = dataclasses.replace(tcfg.classifier, in_features=16)
    gen = torch.Generator().manual_seed(13)
    p = theads.init_global_head(gen, torch.randn(10, 32, generator=gen), tc)
    feats = _pyramid(np.random.default_rng(13))
    jl, jproj = jheads.global_head_forward(jax_tree(p), [jnp.asarray(f) for f in feats],
                                           jc, False)
    tl, tproj = theads.global_head_forward(p, [nchw(f) for f in feats], tc)
    close(tl, jl)
    close(tproj, jproj)


def test_mask_head_matches():
    gen = torch.Generator().manual_seed(14)
    cfg = dict(in_channels=16, conv_channels=16)
    p = tmask.init_mask_head(gen, tmask.MaskHeadConfig(**cfg))
    x = np.random.default_rng(14).standard_normal((5, 14, 14, 16)).astype(np.float32)
    want = jmask.mask_head_forward(jax_tree(p, path=('mask_head',)), jnp.asarray(x))
    got = tmask.mask_head_forward(p, nchw(x))
    assert got.shape == (5, 28, 28)
    close(got, want)
