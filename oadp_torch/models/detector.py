"""The OADP / ViLD detector in PyTorch: its training losses and its
calibrated inference (port of ``oadp_tpu/models/detector.py``).

:func:`forward_train` gives every loss of a train step: the RPN's, the
RCNN's over ``[gts, proposals]`` sampled at 512 (0.25 positive), the mask
loss, and the OADP distillation losses of the object, block and global
heads with their warm-up weights, and the new batch-norm statistics.
The sampler's uniform draws are an argument (:func:`make_draws`), so
that a test can pass ``oadp_tpu``'s. The proposals come from detached
scores; the frozen parameters are detached where they are read.

:func:`simple_test` runs ResNet-50 + FPN, the RPN and its proposals,
RoIAlign, the bbox and object heads, the ViLD ensemble
(``softmax(bbox)^λ * softmax(object)^(1-λ)``, λ = 2/3 for bases and 1/3
for novels and background, the background renormalised to ``1 - Σ``,
then every row renormalised) and the per-class NMS; with masks, the mask
head on the detections. Activations are NCHW on the parameters' device;
the batch's images come from :func:`ingest_images`.

Parameter trees are dicts of tensors with ``oadp_tpu``'s keys; conv
weights are OIHW and the heads' first fc reads (C, H, W)-flattened RoI
features. :func:`from_jax_params` converts ``oadp_tpu``'s trees.
"""

__all__ = [
    'DetectorConfig',
    'IMG_MEAN',
    'IMG_STD',
    'init_detector',
    'ingest_images',
    'make_draws',
    'forward_train',
    'ensemble',
    'simple_test',
    'from_jax_params',
]

import dataclasses
from typing import Any

import numpy as np
import torch

from ..base import losses as L
from ..ops import nms as NMS
from ..ops import roi_align as RA
from ..ops.anchors import AnchorGenerator
from ..ops.assign import max_iou_assign, random_sample
from ..ops.coder import clip_boxes, decode_deltas, encode_deltas
from ..ops.masks import rasterize_in_boxes
from ..utils.dist import Collective
from . import fpn as FP
from . import heads as H
from . import mask_head as MH
from . import resnet as RN
from . import rpn as RPN

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    num_bases: int = 48
    num_all: int = 65
    backbone: RN.ResNetConfig = RN.ResNetConfig(style='caffe')
    fpn_channels: int = 256
    anchor_generator: AnchorGenerator = AnchorGenerator()
    with_global: bool = True
    with_block: bool = True
    with_mask: bool = False
    mask_head: MH.MaskHeadConfig = MH.MaskHeadConfig()
    bbox_head: H.HeadConfig = None  # type: ignore[assignment]
    object_head: H.HeadConfig = None  # type: ignore[assignment]
    block_head: H.HeadConfig = None  # type: ignore[assignment]
    global_cls: H.ClassifierConfig = None  # type: ignore[assignment]
    # train cfg (reference configs/dp/models/faster_rcnn_r50_fpn.py:74-119)
    rpn_samples: int = 256
    rpn_pos_fraction: float = 0.5
    rpn_train_nms_pre: int = 2000
    rpn_train_max: int = 1000
    rcnn_samples: int = 512
    rcnn_pos_fraction: float = 0.25
    rcnn_pos_iou: float = 0.5
    # test cfg (vild_ensemble overlay :41-44)
    rpn_test_nms_pre: int = 1000
    rpn_test_max: int = 1000
    rcnn_score_thr: float = 0.0
    rcnn_nms_iou: float = 0.5
    rcnn_max_per_img: int = 300
    # distillation gains (configs/dp/models/{vild_ensemble,global_,block}.py)
    objects_gain: float = 256.0
    objects_warmup: int = 200
    blocks_gain: float = 128.0
    blocks_rkd_gain: float = 8.0
    blocks_warmup: int = 200
    block_loss_gain: float = 16.0
    block_loss_warmup: int = 1000
    block_topk: int = 5
    global_loss_gain: float = 4.0
    global_loss_warmup: int = 2000
    global_topk: int = 20
    global_distill_gain: float = 0.5
    global_distill_warmup: int = 200
    bbox_reg_stds: tuple = (0.1, 0.1, 0.2, 0.2)

    @staticmethod
    def build(
        num_bases: int,
        num_all: int,
        with_global: bool = True,
        with_block: bool = True,
        with_mask: bool = False,
        backbone_style: str = 'caffe',
        vild_scaler_train: float = 0.007,
        vild_scaler_val: float = 0.01,
        cls_scaler: float = 1.0,
        cls_bias: float = 0.0,
        head_cls_mode: str = 'affine',
        global_vild_scaler: tuple | None = None,
        **overrides,
    ) -> 'DetectorConfig':
        """Assemble the OADP/ViLD head configuration. ``head_cls_mode``
        selects the object/block/global classifier: 'affine' (OV-COCO,
        scaler and bias from ``ml_coco.pth``) or 'vild' (OV-LVIS, the bbox
        head's temperature)."""
        vild = H.ClassifierConfig(
            in_features=1024, num_bases=num_bases, num_all=num_all,
            with_bg=True, mode='vild',
            scaler_train=vild_scaler_train, scaler_val=vild_scaler_val,
        )
        if head_cls_mode == 'vild':
            affine = vild
        else:
            affine = H.ClassifierConfig(
                in_features=1024, num_bases=num_bases, num_all=num_all,
                with_bg=True, mode='affine', scaler=cls_scaler, bias=cls_bias,
            )
        return DetectorConfig(
            num_bases=num_bases,
            num_all=num_all,
            backbone=RN.ResNetConfig(style=backbone_style),
            with_global=with_global,
            with_block=with_block,
            with_mask=with_mask,
            bbox_head=H.HeadConfig(num_convs=4, num_fcs=1, with_reg=True,
                                   reg_class_agnostic=True, classifier=vild),
            object_head=H.HeadConfig(
                num_convs=4, num_fcs=1, with_reg=False, suppress_bg_logit=True,
                classifier=dataclasses.replace(affine, freeze_bg=True)),
            block_head=H.HeadConfig(num_convs=0, num_fcs=2, with_reg=False,
                                    classifier=affine),
            global_cls=dataclasses.replace(
                affine, in_features=256, with_bg=False,
                # OV-LVIS: the global head keeps the default ViLD temperature
                # (reference configs/dp/oadp_ov_lvis.py:20-26 vs :13-17)
                **(dict(scaler_train=global_vild_scaler[0],
                        scaler_val=global_vild_scaler[1])
                   if global_vild_scaler else {}),
            ),
            **overrides,
        )


def init_detector(
    gen: torch.Generator,
    config: DetectorConfig,
    text_embeddings: torch.Tensor,  # (num_all, D) bbox-head prompts (vild)
    ml_embeddings: torch.Tensor | None = None,  # object/block/global prompts
) -> tuple[Params, Params]:
    """Random init on the generator's device. Returns ``(params,
    bn_stats)``; pretrained weights are grafted on top
    (``dp/builder.py``)."""
    if ml_embeddings is None:
        ml_embeddings = text_embeddings
    backbone, bb_stats = RN.init_resnet_params(gen, config.backbone)
    fpn, fpn_stats = FP.init_fpn_params(gen, config.backbone.out_channels,
                                        config.fpn_channels)
    rpn = RPN.init_rpn_params(gen, config.fpn_channels, config.fpn_channels,
                              config.anchor_generator.num_base_anchors)
    bbox_head, bbox_stats = H.init_convfc_head(gen, text_embeddings, config.bbox_head)
    object_head, object_stats = H.init_convfc_head(gen, ml_embeddings, config.object_head)
    params: Params = {'backbone': backbone, 'fpn': fpn, 'rpn': rpn,
                      'bbox_head': bbox_head, 'object_head': object_head}
    stats: Params = {'backbone': bb_stats, 'fpn': fpn_stats,
                     'bbox_head': bbox_stats, 'object_head': object_stats}
    if config.with_block:
        params['block_head'], stats['block_head'] = H.init_convfc_head(
            gen, ml_embeddings, config.block_head)
    if config.with_global:
        params['global_head'] = H.init_global_head(gen, ml_embeddings, config.global_cls)
    if config.with_mask:
        params['mask_head'] = MH.init_mask_head(gen, config.mask_head)
    return params, stats


def _extract(params: Params, stats: Params, images: torch.Tensor,
             config: DetectorConfig) -> list[torch.Tensor]:
    feats, _ = RN.resnet_forward(params['backbone'], stats['backbone'], images,
                                 config.backbone)
    return FP.fpn_forward(params['fpn'], stats['fpn'], feats, num_outs=5)


# mmdet img_norm_cfg shared by all DP configs (reference
# configs/dp/datasets/ov_coco.py:9-13)
IMG_MEAN = np.asarray([123.675, 116.28, 103.53], np.float32)
IMG_STD = np.asarray([58.395, 57.12, 57.375], np.float32)


def ingest_images(images: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Loader canvases ``(B, H, W, 3)`` to activations ``(B, 3, H, W)`` on
    the images' device: uint8 canvases are mean/std-normalised there in
    fp32 (one pass on the device, a quarter of the bytes to copy); float
    canvases, already normalised, are only cast."""
    if images.dtype == torch.uint8:
        mean = torch.from_numpy(IMG_MEAN).to(images.device)
        std = torch.from_numpy(IMG_STD).to(images.device)
        images = (images.float() - mean) / std
    return images.permute(0, 3, 1, 2).to(dtype).contiguous()


def _lambda(config: DetectorConfig) -> np.ndarray:
    lam = np.full(config.num_all + 1, 1 / 3, np.float32)
    lam[:config.num_bases] = 2 / 3
    return lam


def _roi_feats(pyramid: list[torch.Tensor], rois: torch.Tensor,
               out_size: int = 7) -> torch.Tensor:
    """``(B, R, 4)`` RoIs -> ``(B * R, C, out, out)`` features."""
    feats = RA.roi_align_fpn(pyramid, rois, out_size=out_size)
    return feats.reshape(-1, *feats.shape[2:])


def ensemble(bbox_logits: torch.Tensor, object_logits: torch.Tensor,
             config: DetectorConfig) -> torch.Tensor:
    """The ViLD ensemble of the two heads' logits ``(N, C+1)`` into
    per-row class probabilities ``(N, C+1)`` (fp32)."""
    lam = torch.from_numpy(_lambda(config)).to(bbox_logits.device)
    bbox_scores = torch.softmax(bbox_logits.float(), -1) ** lam
    object_scores = torch.softmax(object_logits.float(), -1) ** (1 - lam)
    cls_score = bbox_scores * object_scores
    cls_score = torch.cat([cls_score[:, :-1], 1 - cls_score[:, :-1].sum(-1, keepdim=True)], 1)
    # mmdet applies softmax(log p) downstream = p renormalized
    return cls_score / cls_score.sum(-1, keepdim=True).clamp(min=1e-12)


def make_draws(gen: torch.Generator, config: DetectorConfig, batch_size: int,
               num_anchors: int, max_gts: int) -> dict[str, torch.Tensor]:
    """The uniform draws of one train step's samplers on the generator's
    device: ``rpn (B, num_anchors)`` over the anchors and ``rcnn (B, max_gts +
    rpn_train_max)`` over ``[gts, proposals]``."""
    dev = gen.device
    return {'rpn': torch.rand(batch_size, num_anchors, generator=gen, device=dev),
            'rcnn': torch.rand(batch_size, max_gts + config.rpn_train_max, generator=gen,
                               device=dev)}


def _sample_rcnn(config: DetectorConfig, draws, cand, cand_valid, gts, gt_valid, gt_labels):
    """Per image: the RCNN's sampled RoIs, labels (background ``num_all``),
    regression targets, validity, positivity and matched gt."""
    out = []
    for i in range(cand.shape[0]):
        assigned = max_iou_assign(cand[i], cand_valid[i], gts[i], gt_valid[i],
                                  pos_iou_thr=config.rcnn_pos_iou,
                                  neg_iou_thr=config.rcnn_pos_iou,
                                  min_pos_iou=config.rcnn_pos_iou, match_low_quality=False)
        inds, valid, is_pos = random_sample(draws[i], assigned, config.rcnn_samples,
                                            config.rcnn_pos_fraction)
        inds = inds.long()
        rois = cand[i][inds]
        gt_idx = (assigned[inds] - 1).clamp(min=0).long()
        labels = torch.where(is_pos, gt_labels[i][gt_idx].long(), config.num_all)
        targets = encode_deltas(rois, gts[i][gt_idx], stds=config.bbox_reg_stds)
        out.append((rois, labels, targets, valid, is_pos, gt_idx))
    return [torch.stack(t) for t in zip(*out)]


def forward_train(
    params: Params,
    stats: Params,
    batch: dict[str, torch.Tensor],
    config: DetectorConfig,
    level_anchors: list[torch.Tensor],
    step: int,
    draws: dict[str, torch.Tensor],
    coll: Collective = Collective(),
) -> tuple[dict[str, torch.Tensor], Params]:
    """All training losses (RPN, RCNN, mask, OV heads and distillation) and
    the new batch-norm statistics, for ``batch['images'] (B, 3, H, W)``
    activations and the padded fields of ``oadp_tpu``'s batch layout.

    With ``coll`` over several processes each loss is this process's share:
    its sum over the local rows divided by the count over every process, so
    that the shares add up to the loss of the global batch; the batch norms
    take the global batch's statistics, and the block relation loss and the
    recalls are computed on the gathered rows and divided by the world
    size. ``loss_clip_global`` is the local sum, as in ``oadp_tpu``."""
    all_sum = coll.all_sum
    b = batch['images'].shape[0]
    feats, bb_stats = RN.resnet_forward(params['backbone'], stats['backbone'],
                                        batch['images'], config.backbone, True, all_sum)
    pyramid, fpn_stats = FP.fpn_forward_train(params['fpn'], stats['fpn'], feats, 5, all_sum)
    new_stats: Params = {'backbone': bb_stats, 'fpn': fpn_stats}
    gt_boxes, gt_valid = batch['gt_boxes'], batch['gt_valid']

    # --- RPN --------------------------------------------------------------
    scores, deltas = RPN.rpn_forward(params['rpn'], pyramid)
    losses = RPN.rpn_loss(draws['rpn'], scores, deltas, torch.cat(level_anchors), gt_boxes,
                          gt_valid, batch['img_hw'], config.rpn_samples,
                          config.rpn_pos_fraction, all_sum)
    proposals, _, prop_valid = RPN.rpn_proposals(
        [s.detach() for s in scores], [d.detach() for d in deltas], level_anchors,
        batch['img_hw'], nms_pre=config.rpn_train_nms_pre, max_per_img=config.rpn_train_max)

    # --- RCNN sampling (add_gt_as_proposals) -------------------------------
    rois, labels, reg_targets, sel_valid, is_pos, roi_gt_idx = _sample_rcnn(
        config, draws['rcnn'], torch.cat([gt_boxes, proposals.to(gt_boxes.dtype)], 1),
        torch.cat([gt_valid, prop_valid], 1), gt_boxes, gt_valid, batch['gt_labels'])

    # ONE RoIAlign over the RCNN, object and block RoIs (one gather, and one
    # scatter-add in its backward)
    r, o = config.rcnn_samples, batch['object_boxes'].shape[1]
    all_rois = [rois, batch['object_boxes']]
    if config.with_block:
        all_rois.append(batch['block_boxes'])
    packed = RA.roi_align_fpn(pyramid, torch.cat(all_rois, 1))  # (B, R, C, 7, 7)

    sel_f, pos_f, labels_f = sel_valid.reshape(-1), is_pos.reshape(-1), labels.reshape(-1)
    cls_logits, reg, _, new_stats['bbox_head'] = H.convfc_forward_train(
        params['bbox_head'], stats['bbox_head'], packed[:, :r].flatten(0, 1), config.bbox_head,
        sel_f, all_sum)
    n_samples = sel_f.sum().float()
    n_samples = (n_samples if all_sum is None else all_sum(n_samples)).clamp(min=1.0)
    losses['loss_cls'] = L.softmax_cross_entropy(cls_logits, labels_f, sel_f.float(), n_samples)
    losses['acc'] = ((cls_logits.argmax(-1) == labels_f) & sel_f).sum() / n_samples * 100.0
    losses['loss_bbox'] = ((reg.float() - reg_targets.reshape(-1, 4)).abs().sum(-1)
                           * pos_f.float()).sum() / n_samples

    # --- mask head (LVIS instance segmentation) -----------------------------
    if config.with_mask:
        mc = config.mask_head
        mask_feats = RA.roi_align_fpn(pyramid, rois, out_size=mc.roi_size)
        targets = torch.stack([
            rasterize_in_boxes(batch['gt_polygons'][i], roi_gt_idx[i], rois[i], mc.mask_size)
            for i in range(b)])
        logits = MH.mask_head_forward(params['mask_head'], mask_feats.flatten(0, 1))
        losses['loss_mask'] = MH.mask_loss(logits, targets.flatten(0, 1), pos_f, all_sum)

    # --- object head distillation -------------------------------------------
    obj_mask = batch['object_valid'].reshape(-1)
    _, _, obj_proj, new_stats['object_head'] = H.convfc_forward_train(
        params['object_head'], stats['object_head'], packed[:, r:r + o].flatten(0, 1),
        config.object_head, obj_mask, all_sum)
    losses['loss_clip_objects'] = L.l1_loss(
        obj_proj, batch['clip_objects'].flatten(0, 1), obj_mask, all_sum,
    ) * L.warmup_weight(step, config.objects_gain, config.objects_warmup)

    # --- block head -----------------------------------------------------------
    if config.with_block:
        blk_mask = batch['block_valid'].reshape(-1)
        blk_logits, _, blk_proj, new_stats['block_head'] = H.convfc_forward_train(
            params['block_head'], stats['block_head'], packed[:, r + o:].flatten(0, 1),
            config.block_head, blk_mask, all_sum)
        blk_targets = batch['block_labels'].flatten(0, 1)
        clip_blocks = batch['clip_blocks'].flatten(0, 1)
        losses['loss_block'] = L.asymmetric_loss(
            torch.sigmoid(blk_logits[:, :-1]), blk_targets, blk_mask, gamma_neg=4, gamma_pos=0,
            all_sum=all_sum,
        ) * L.warmup_weight(step, config.block_loss_gain, config.block_loss_warmup)
        losses['recall_block'] = L.multilabel_topk_recall(
            coll.gather(blk_logits[:, :-1].detach()), coll.gather(blk_targets),
            config.block_topk, coll.gather(blk_mask)) / coll.world
        losses['loss_clip_blocks'] = L.l1_loss(
            blk_proj, clip_blocks, blk_mask, all_sum,
        ) * L.warmup_weight(step, config.blocks_gain, config.blocks_warmup)
        losses['loss_clip_block_relations'] = L.rkd_loss(
            coll.gather(blk_proj), coll.gather(clip_blocks), coll.gather(blk_mask),
        ) / coll.world * L.warmup_weight(step, config.blocks_rkd_gain, config.blocks_warmup)

    # --- global head ------------------------------------------------------------
    if config.with_global:
        g_logits, g_proj = H.global_head_forward(params['global_head'], pyramid,
                                                 config.global_cls, train=True)
        hot = torch.nn.functional.one_hot(
            batch['gt_labels'].long().clamp(0, config.num_all - 1), config.num_all)
        g_targets = (hot.bool() & gt_valid[..., None]).any(1)
        losses['loss_global'] = L.asymmetric_loss(
            torch.sigmoid(g_logits), g_targets, None, gamma_neg=4, gamma_pos=0,
            all_sum=all_sum,
        ) * L.warmup_weight(step, config.global_loss_gain, config.global_loss_warmup)
        losses['recall_global'] = L.multilabel_topk_recall(
            coll.gather(g_logits.detach()), coll.gather(g_targets), config.global_topk,
        ) / coll.world
        losses['loss_clip_global'] = L.mse_loss(
            g_proj, batch['clip_global'], reduction='sum',
        ) * L.warmup_weight(step, config.global_distill_gain, config.global_distill_warmup)
    return losses, new_stats


def simple_test(
    params: Params,
    stats: Params,
    batch: dict[str, torch.Tensor],
    config: DetectorConfig,
    level_anchors: list[torch.Tensor],
) -> dict[str, torch.Tensor | None]:
    """Calibrated inference on ``batch['images'] (B, 3, H, W)`` and
    ``batch['img_hw'] (B, 2)``. Returns per image ``dets (B, M, 5)`` in
    resized-image coordinates (the caller rescales), ``labels (B, M)``,
    ``valid (B, M)``, ``masks`` (or None), and the DUMP fields: the decoded
    ``boxes``, both heads' logits, the proposals' ``objectness`` and
    ``proposal_valid``, and ``det_rows``."""
    pyramid = _extract(params, stats, batch['images'], config)
    scores, deltas = RPN.rpn_forward(params['rpn'], pyramid)
    proposals, prop_scores, prop_valid = RPN.rpn_proposals(
        scores, deltas, level_anchors, batch['img_hw'],
        nms_pre=config.rpn_test_nms_pre, max_per_img=config.rpn_test_max)
    b, n = proposals.shape[:2]
    flat = _roi_feats(pyramid, proposals)
    bbox_logits, reg, _ = H.convfc_forward(params['bbox_head'], stats['bbox_head'], flat,
                                           config.bbox_head)
    object_logits, _, _ = H.convfc_forward(params['object_head'], stats['object_head'],
                                           flat, config.object_head)
    probs = ensemble(bbox_logits, object_logits, config).reshape(b, n, -1)
    boxes = decode_deltas(proposals.reshape(-1, 4), reg,
                          stds=config.bbox_reg_stds).reshape(b, n, 4)
    boxes = clip_boxes(boxes, batch['img_hw'])
    dets, det_labels, det_rows, det_valid = NMS.multiclass_nms(
        boxes, torch.where(prop_valid[..., None], probs, 0.0),
        score_thr=config.rcnn_score_thr, iou_threshold=config.rcnn_nms_iou,
        max_per_img=config.rcnn_max_per_img, num_classes=config.num_all,
    )
    masks = None
    if config.with_mask:
        mc = config.mask_head
        m = dets.shape[1]
        logits = MH.mask_head_forward(
            params['mask_head'], _roi_feats(pyramid, dets[..., :4], mc.roi_size))
        masks = torch.sigmoid(logits.float()).reshape(b, m, mc.mask_size, mc.mask_size)
    return {
        'dets': dets,
        'labels': det_labels,
        'valid': det_valid,
        'masks': masks,
        'boxes': boxes,
        'bbox_logits': bbox_logits.reshape(b, n, -1),
        'object_logits': object_logits.reshape(b, n, -1),
        'objectness': prop_scores,
        'proposal_valid': prop_valid,
        'det_rows': det_rows,
    }


# ---------------------------------------------------------------------------
# oadp_tpu's trees
# ---------------------------------------------------------------------------


def from_jax_params(params: Any, stats: Any) -> tuple[Params, Params]:
    """``oadp_tpu``'s detector ``(params, stats)`` trees (numpy leaves) to
    the port's: conv weights HWIO -> OIHW, the mask head's transposed conv
    ``(kH, kW, in, out)`` -> ``(in, out, kH, kW)``, and the rows of each
    ConvFC head's first fc from ``oadp_tpu``'s (H, W, C) flatten to the
    port's (C, H, W)."""

    def convert(x, path=()):
        if isinstance(x, dict):
            return {k: convert(v, path + (k,)) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [convert(v, path + (i,)) for i, v in enumerate(x)]
        t = torch.from_numpy(np.array(x, np.float32))
        if t.ndim == 4:
            up = path[:2] == ('mask_head', 'upsample')
            t = t.permute(2, 3, 0, 1) if up else t.permute(3, 2, 0, 1)
        return t.contiguous()

    out = convert(params)
    for name, head in out.items():
        if not (isinstance(head, dict) and 'fcs' in head and head['fcs']):
            continue
        c = (head['convs'][-1]['conv']['w'].shape[0] if head['convs']
             else out['fpn']['outputs'][0]['conv']['w'].shape[0])
        w = head['fcs'][0]['w']
        roi = int(round((w.shape[0] // c) ** 0.5))
        head['fcs'][0]['w'] = (w.reshape(roi, roi, c, -1).permute(2, 0, 1, 3)
                               .reshape(w.shape[0], -1).contiguous())
    return out, convert(stats)
