"""Overfit to AP on the port alone, as ``tests/test_overfit_ap.py`` does for
``oadp_tpu``: the tiny detector (``tests/test_detector.py``'s geometry)
trains with ``forward_train``, autograd and ``sgd_update`` on 4 fixed
synthetic images with painted rectangles, then ``simple_test`` and the
port's ``CocoEvaluator`` run on the same images. The whole loop (RPN
assign and sample, RoI losses, SGD, calibrated inference, NMS, COCO
matching) must take bbox mAP50 from ~0 (the untrained control) to >= 0.5;
with masks, the mask head must learn that each object is the triangular
half of its box. All classes are base classes, for the reason
``tests/test_overfit_ap.py`` gives."""

import dataclasses

import numpy as np
import torch

from oadp_torch.dp.coco_eval import CocoEvaluator
from oadp_torch.dp.trainer import _lr_mult_tree, _leaves, sgd_init, sgd_update
from oadp_torch.models import detector as DET
from oadp_torch.models.clip import map_params
from oadp_torch.models.mask_head import MaskHeadConfig

torch.set_num_threads(1)

NUM_BASES = NUM_ALL = 3
EMB_DIM = 16
CANVAS = 128
N_IMAGES = 4
G = 2  # gt boxes an image


def _mini_config(**kw):
    config = DET.DetectorConfig.build(
        NUM_BASES, NUM_ALL, backbone_style='caffe', rcnn_samples=32, rpn_samples=16,
        rpn_train_nms_pre=64, rpn_train_max=32, rpn_test_nms_pre=64, rpn_test_max=32,
        rcnn_max_per_img=8, **kw)

    def head(h, convs=True):
        extra = dict(in_channels=32, conv_channels=32) if convs else dict(in_channels=32)
        return dataclasses.replace(h, fc_channels=64, classifier=dataclasses.replace(
            h.classifier, in_features=64, embedding_dim=EMB_DIM), **extra)

    return dataclasses.replace(
        config, backbone=dataclasses.replace(config.backbone, base_channels=8,
                                             blocks=(1, 1, 1, 1)),
        fpn_channels=32, bbox_head=head(config.bbox_head), object_head=head(config.object_head),
        block_head=head(config.block_head, False),
        global_cls=dataclasses.replace(config.global_cls, in_features=32, embedding_dim=EMB_DIM),
        mask_head=MaskHeadConfig(num_convs=2, in_channels=32, conv_channels=32))


def _make_scene(rng):
    """4 images with 2 painted rectangles each, in separate halves, in
    class colours on a noisy background (normalised)."""
    colors = np.asarray([[230, 30, 30], [30, 230, 30], [30, 30, 230]], np.float32)
    images = rng.uniform(0, 60, (N_IMAGES, CANVAS, CANVAS, 3)).astype(np.float32)
    gt_boxes = np.zeros((N_IMAGES, G, 4), np.float32)
    gt_labels = np.zeros((N_IMAGES, G), np.int64)
    half = CANVAS // 2
    for i in range(N_IMAGES):
        for j in range(G):
            w, h = rng.uniform(28, 56, 2)
            x0 = rng.uniform(2, half - w - 2) + (0 if j == 0 else half)
            y0 = rng.uniform(2, CANVAS - 2 - h)
            cls = int(rng.integers(0, NUM_BASES))
            gt_boxes[i, j] = (x0, y0, x0 + w, y0 + h)
            gt_labels[i, j] = cls
            sl = (i, slice(int(y0), int(y0 + h)), slice(int(x0), int(x0 + w)))
            images[sl] = colors[cls] + rng.uniform(-10, 10, images[sl].shape)
    return images / 127.5 - 1.0, gt_boxes, gt_labels


def _train_batch(images, gt_boxes, gt_labels, rng, emb):
    """The object distillation targets are the gt classes' text embeddings
    on the gt boxes (what OAKE object features are to the text classifier),
    so that the object head, which the ensemble multiplies in, trains; the
    block and global fields are random and out of the objective."""
    b, o, k = N_IMAGES, 4, 4
    t = torch.from_numpy
    return {
        'images': DET.ingest_images(t(images)),
        'img_hw': torch.full((b, 2), float(CANVAS)),
        'gt_boxes': t(gt_boxes),
        'gt_labels': t(gt_labels),
        'gt_valid': torch.ones(b, G, dtype=torch.bool),
        'clip_global': t(rng.standard_normal((b, EMB_DIM)).astype(np.float32)),
        'block_boxes': torch.tensor([10.0, 10.0, 70.0, 70.0]).repeat(b, k, 1),
        'block_labels': torch.zeros(b, k, NUM_ALL),
        'clip_blocks': t(rng.standard_normal((b, k, EMB_DIM)).astype(np.float32)),
        'block_valid': torch.ones(b, k, dtype=torch.bool),
        'object_boxes': t(np.tile(gt_boxes, (1, o // G, 1))),
        'clip_objects': t(emb[np.tile(gt_labels, (1, o // G))]),
        'object_valid': torch.ones(b, o, dtype=torch.bool),
    }


def _coco_gt(gt_boxes, gt_labels) -> dict:
    annotations = []
    for i in range(N_IMAGES):
        for j in range(G):
            x0, y0, x1, y1 = (float(v) for v in gt_boxes[i, j])
            annotations.append(dict(id=len(annotations) + 1, image_id=i + 1,
                                    category_id=int(gt_labels[i, j]) + 1,
                                    bbox=[x0, y0, x1 - x0, y1 - y0],
                                    area=(x1 - x0) * (y1 - y0), iscrowd=0))
    return dict(images=[dict(id=i + 1, width=CANVAS, height=CANVAS) for i in range(N_IMAGES)],
                annotations=annotations,
                categories=[dict(id=c + 1, name=f'c{c}') for c in range(NUM_ALL)])


@torch.inference_mode()
def _simple_test(params, stats, batch, config, anchors):
    return DET.simple_test(params, stats, {'images': batch['images'],
                                           'img_hw': batch['img_hw']}, config, anchors)


def _ap50(params, stats, batch, config, anchors, dataset) -> float:
    out = _simple_test(params, stats, batch, config, anchors)
    detections = []
    for i in range(N_IMAGES):
        for j in torch.nonzero(out['valid'][i]).flatten().tolist():
            x0, y0, x1, y1, score = out['dets'][i, j].tolist()
            detections.append(dict(image_id=i + 1, category_id=int(out['labels'][i, j]) + 1,
                                   bbox=[x0, y0, x1 - x0, y1 - y0], score=score))
    ev = CocoEvaluator(dataset, cat_ids=list(range(1, NUM_ALL + 1)), max_dets=(100, 300, 1000))
    ev.evaluate(detections)
    return ev.summarize()['50']


def _train(params, stats, batch, config, anchors, steps, evaluate, keys):
    """SGD (lr 0.005, momentum 0.9, no decay) on the supervised losses plus
    0.02 x the object distillation, one fixed draw for every step; calls
    ``evaluate`` every 50 steps and stops when it returns True."""
    gen = torch.Generator().manual_seed(0)
    draws = DET.make_draws(gen, config, N_IMAGES, sum(len(a) for a in anchors), G)
    mults = _lr_mult_tree(params, {})
    bufs = sgd_init(params)
    leaves = _leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    for i in range(steps):
        # step 10000: past every distillation warm-up
        losses, stats = DET.forward_train(params, stats, batch, config, anchors, 10000, draws)
        sup = sum(losses[k] for k in keys) + 0.02 * losses['loss_clip_objects']
        grads = torch.autograd.grad(sup, leaves, allow_unused=True)
        it = iter(grads)
        sgd_update(params, map_params(params, lambda _: next(it)), bufs, 0.005, mults,
                   momentum=0.9, weight_decay=0.0)
        assert torch.isfinite(sup)
        if (i + 1) % 50 == 0 and evaluate(params, stats, i + 1):
            break
    return params, stats


def _setup(seed, **kw):
    rng = np.random.default_rng(seed)
    images, gt_boxes, gt_labels = _make_scene(rng)
    config = _mini_config(**kw)
    emb = rng.standard_normal((NUM_ALL, EMB_DIM)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    params, stats = DET.init_detector(torch.Generator().manual_seed(seed), config,
                                      torch.from_numpy(emb))
    gen = config.anchor_generator
    anchors = [torch.from_numpy(a) for a in gen.grid_anchors(
        [(CANVAS // s, CANVAS // s) for s in gen.strides])]
    batch = _train_batch(images, gt_boxes, gt_labels, rng, emb)
    return config, params, stats, anchors, batch, gt_boxes, gt_labels


def test_overfit_reaches_ap50():
    config, params, stats, anchors, batch, gt_boxes, gt_labels = _setup(7)
    dataset = _coco_gt(gt_boxes, gt_labels)
    ap_untrained = _ap50(params, stats, batch, config, anchors, dataset)
    assert ap_untrained < 0.1, ap_untrained
    best = [0.0]

    def evaluate(p, s, step):
        best[0] = max(best[0], _ap50(p, s, batch, config, anchors, dataset))
        return best[0] >= 0.65

    _train(params, stats, batch, config, anchors, 300, evaluate,
           ('loss_rpn_cls', 'loss_rpn_bbox', 'loss_cls', 'loss_bbox'))
    assert best[0] >= 0.5, best[0]


def _triangle_polys(gt_boxes) -> torch.Tensor:
    """(B, G, 1, 4, 2) polygons: the right triangle on each box's left, top
    and bottom corners, half its area (a full-box mask would be learnt by
    predicting ones)."""
    x0, y0, x1, y1 = (torch.from_numpy(gt_boxes[..., i]) for i in range(4))
    pts = [(x0, y0), (x1, y0), (x0, y1), (x0, y0)]
    return torch.stack([torch.stack(p, -1) for p in pts], -2)[:, :, None]


def _mask_separation(out, gt_boxes, gt_labels) -> float:
    """Mean mask probability inside minus outside the gt triangle, in each
    detection's own box frame, over the detections that match a gt box
    (IoU >= 0.5, same label); nan when none does."""
    masks, dets = out['masks'].numpy(), out['dets'].numpy()
    labels, valid = out['labels'].numpy(), out['valid'].numpy()
    ms = masks.shape[-1]
    seps = []
    for i in range(gt_boxes.shape[0]):
        for j in np.nonzero(valid[i])[0]:
            db = dets[i, j, :4]
            lt = np.maximum(db[:2], gt_boxes[i, :, :2])
            rb = np.minimum(db[2:], gt_boxes[i, :, 2:])
            inter = np.clip(rb - lt, 0, None).prod(-1)
            union = ((db[2:] - db[:2]).prod() + (gt_boxes[i, :, 2:] - gt_boxes[i, :, :2]).prod(-1)
                     - inter)
            iou = inter / np.maximum(union, 1e-6)
            k = int(iou.argmax())
            if iou[k] < 0.5 or labels[i, j] != gt_labels[i, k]:
                continue
            gb = gt_boxes[i, k]
            xs = db[0] + (np.arange(ms) + 0.5) / ms * (db[2] - db[0])
            ys = db[1] + (np.arange(ms) + 0.5) / ms * (db[3] - db[1])
            px, py = np.meshgrid(xs, ys)
            u = (px - gb[0]) / max(gb[2] - gb[0], 1e-6)
            v = (py - gb[1]) / max(gb[3] - gb[1], 1e-6)
            inside = (u >= 0) & (v >= 0) & (u + v <= 1.0)
            if inside.all() or not inside.any():
                continue
            seps.append(float(masks[i, j][inside].mean() - masks[i, j][~inside].mean()))
    return float(np.mean(seps)) if seps else float('nan')


def test_overfit_mask_head_learns_shape():
    config, params, stats, anchors, batch, gt_boxes, gt_labels = _setup(11, with_mask=True)
    batch['gt_polygons'] = _triangle_polys(gt_boxes)
    init = map_params(params, torch.clone), map_params(stats, torch.clone)
    best = [-1.0]

    def evaluate(p, s, step):
        if step < 100:
            return False
        sep = _mask_separation(_simple_test(p, s, batch, config, anchors), gt_boxes, gt_labels)
        if np.isfinite(sep):
            best[0] = max(best[0], sep)
        return best[0] >= 0.5

    _train(params, stats, batch, config, anchors, 300, evaluate,
           ('loss_rpn_cls', 'loss_rpn_bbox', 'loss_cls', 'loss_bbox', 'loss_mask'))
    sep0 = _mask_separation(_simple_test(*init, batch, config, anchors), gt_boxes, gt_labels)
    assert best[0] >= 0.35, (best[0], sep0)
    if np.isfinite(sep0):  # the untrained control: near 0, where any detection matches
        assert sep0 < 0.15, sep0
