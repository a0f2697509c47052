"""RPN head: the conv tower, its losses and proposal generation (port of
``oadp_tpu/models/rpn.py``).

mmdet's ``RPNHead``: 3x3 conv + ReLU, 1x1 sigmoid objectness, 1x1 deltas;
anchor targets (pos 0.7, neg 0.3, min pos 0.3 with low-quality matches) and
256 random samples at a positive fraction of 0.5, averaged per image and
then over images; proposals by per-level top-k, decode, clip, level-aware
NMS (0.7) and the top ``max_per_img``. Per-level outputs are flattened in
(y, x, a) order, ``AnchorGenerator.grid_anchors``'s order, so the NCHW
outputs are permuted to (B, H, W, A) first.
"""

__all__ = ['init_rpn_params', 'rpn_forward', 'rpn_loss', 'rpn_proposals',
           'convert_torch_rpn']

from typing import Any

import torch
import torch.nn.functional as F

from ..base.losses import binary_cross_entropy
from ..ops.assign import max_iou_assign, random_sample
from ..ops.coder import clip_boxes, decode_deltas, encode_deltas
from ..ops.nms import NEG_INF, batched_nms
from .layers import conv, normal, state_tensor

Params = dict[str, Any]


def init_rpn_params(
    gen: torch.Generator, in_channels: int = 256, feat_channels: int = 256,
    num_anchors: int = 3,
) -> Params:
    """Normal(std=0.01) init per mmdet ``RPNHead``."""
    dev = gen.device

    def cv(c_out, c_in, k):
        return {'w': normal(gen, (c_out, c_in, k, k), 0.01),
                'b': torch.zeros(c_out, device=dev)}

    return {'conv': cv(feat_channels, in_channels, 3),
            'cls': cv(num_anchors, feat_channels, 1),
            'reg': cv(num_anchors * 4, feat_channels, 1)}


def rpn_forward(
    params: Params, feats: list[torch.Tensor]
) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Per level: ``(B, H*W*A)`` logits and ``(B, H*W*A, 4)`` deltas,
    flattened in (y, x, a) order."""
    scores, deltas = [], []
    for f in feats:
        x = F.relu(conv(f, params['conv'], padding=1))
        s = conv(x, params['cls']).permute(0, 2, 3, 1)  # (B, H, W, A)
        d = conv(x, params['reg']).permute(0, 2, 3, 1)  # (B, H, W, 4A)
        b = s.shape[0]
        scores.append(s.reshape(b, -1))
        deltas.append(d.reshape(b, -1, 4))
    return scores, deltas


def _anchor_valid(anchors: torch.Tensor, img_hw: torch.Tensor) -> torch.Tensor:
    """Anchors whose centres lie inside the resized image (not in the
    canvas padding): mmdet generates anchors for the unpadded shape."""
    cx = (anchors[:, 0] + anchors[:, 2]) * 0.5
    cy = (anchors[:, 1] + anchors[:, 3]) * 0.5
    return (cx < img_hw[1]) & (cy < img_hw[0])


def rpn_loss(
    draws: torch.Tensor,  # (B, N) uniform draws of the sampler
    scores: list[torch.Tensor],  # per level (B, N_l)
    deltas: list[torch.Tensor],  # per level (B, N_l, 4)
    anchors: torch.Tensor,  # (N, 4) all levels concatenated
    gt_boxes: torch.Tensor,  # (B, G, 4)
    gt_valid: torch.Tensor,  # (B, G)
    img_hw: torch.Tensor,  # (B, 2)
    num_samples: int = 256,
    pos_fraction: float = 0.5,
    all_sum=None,
) -> dict[str, torch.Tensor]:
    """``loss_rpn_cls`` and ``loss_rpn_bbox``: each image's loss over its
    sampled anchors, then the mean over images (``all_sum`` counts the
    images of every process)."""
    score = torch.cat(scores, 1)
    delta = torch.cat(deltas, 1)
    cls, reg = [], []
    for i in range(score.shape[0]):
        assigned = max_iou_assign(anchors, _anchor_valid(anchors, img_hw[i]), gt_boxes[i],
                                  gt_valid[i], pos_iou_thr=0.7, neg_iou_thr=0.3,
                                  min_pos_iou=0.3, match_low_quality=True)
        inds, sel_valid, is_pos = random_sample(draws[i], assigned, num_samples, pos_fraction)
        inds = inds.long()
        sel_gt = gt_boxes[i][(assigned[inds] - 1).clamp(min=0).long()]
        targets = encode_deltas(anchors[inds], sel_gt)
        n_total = sel_valid.sum().float()
        cls.append(binary_cross_entropy(score[i][inds], is_pos.float(), sel_valid.float(),
                                        n_total))
        reg.append(((delta[i][inds] - targets).abs().sum(-1) * is_pos.float()).sum()
                   / n_total.clamp(min=1.0))
    n = score.new_tensor(float(score.shape[0]), dtype=torch.float32)
    n = n if all_sum is None else all_sum(n)
    return {'loss_rpn_cls': torch.stack(cls).sum() / n,
            'loss_rpn_bbox': torch.stack(reg).sum() / n}


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest of ``x (N,)``, ties to the lower index first (as
    ``jax.lax.top_k``; ``torch.topk`` promises no order among ties)."""
    values, indices = torch.sort(x, descending=True, stable=True)
    return values[:k], indices[:k]


def rpn_proposals(
    scores: list[torch.Tensor],  # per level (B, N_l)
    deltas: list[torch.Tensor],  # per level (B, N_l, 4)
    level_anchors: list[torch.Tensor],
    img_hw: torch.Tensor,  # (B, 2)
    nms_pre: int = 1000,
    max_per_img: int = 1000,
    iou_threshold: float = 0.7,
    min_bbox_size: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns ``(boxes (B, max_per_img, 4), scores, valid)``."""
    out_boxes, out_scores, out_valid = [], [], []
    for i in range(img_hw.shape[0]):
        cand_boxes, cand_scores, cand_ids = [], [], []
        for lvl, (sc, dl, anc) in enumerate(zip(scores, deltas, level_anchors)):
            k = min(nms_pre, sc.shape[1])
            top_sc, top_i = _top_k(torch.sigmoid(sc[i]), k)
            boxes = decode_deltas(anc[top_i], dl[i][top_i])
            cand_boxes.append(clip_boxes(boxes, img_hw[i]))
            cand_scores.append(top_sc)
            cand_ids.append(torch.full((k,), lvl, dtype=torch.int32, device=sc.device))
        boxes = torch.cat(cand_boxes)
        sc = torch.cat(cand_scores)
        ids = torch.cat(cand_ids)
        w = boxes[:, 2] - boxes[:, 0]
        h = boxes[:, 3] - boxes[:, 1]
        sc = torch.where((w > min_bbox_size) & (h > min_bbox_size), sc, NEG_INF)
        idx, valid = batched_nms(boxes, sc, ids, iou_threshold, max_per_img)
        idx = idx.long()
        out_boxes.append(boxes[idx])
        out_scores.append(torch.where(valid, sc[idx], 0.0))
        out_valid.append(valid)
    return torch.stack(out_boxes), torch.stack(out_scores), torch.stack(out_valid)


def convert_torch_rpn(state: dict, prefix: str = 'rpn_head.') -> Params:
    """An mmdet ``RPNHead`` state dict (``rpn_conv``, ``rpn_cls``,
    ``rpn_reg``) to params."""

    def cv(name):
        return {'w': state_tensor(state[f'{prefix}{name}.weight']),
                'b': state_tensor(state[f'{prefix}{name}.bias'])}

    return {'conv': cv('rpn_conv'), 'cls': cv('rpn_cls'), 'reg': cv('rpn_reg')}
