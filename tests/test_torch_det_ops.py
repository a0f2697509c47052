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
    raise KeyError(name)


NMS_CASES = ['random', 'clustered', 'more_than_max_out', 'ties', 'invalid', 'chain',
             'oscillating']


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
            'ties': (20, 100), 'no_survivors': (65, 50), 'few_candidates': (3, 40)}[name]
    boxes = _boxes(rng, n, clustered=True)
    if name == 'per_class_boxes':
        boxes = np.concatenate([_boxes(rng, n, clustered=True) for _ in range(c)], 1)
    scores = (rng.random((n, c + 1)) ** 4).astype(np.float32)
    scores[rng.random((n, c + 1)) < 0.3] = 0.0
    if name == 'ties':
        scores = np.round(scores * 3) / 3
    if name == 'no_survivors':
        scores[:, :c] = 0.0  # strict > score_thr drops exact zeros
    return boxes, scores.astype(np.float32), c, (500 if name == 'few_candidates' else 100)


@pytest.mark.parametrize('case', ['shared', 'per_class_boxes', 'lvis_1203', 'ties',
                                  'no_survivors', 'few_candidates'])
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
