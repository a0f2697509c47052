"""Box algebra on the device: the delta coder, IoU and clipping (port of
``oadp_tpu/ops/coder.py``).

mmdet's ``DeltaXYWHBBoxCoder`` and the IoU of its ``MaxIoUAssigner``, as
torch ops on whatever device the boxes are on.
"""

__all__ = ['encode_deltas', 'decode_deltas', 'pairwise_iou', 'clip_boxes']

import math

import torch


def encode_deltas(
    boxes: torch.Tensor,  # (..., 4) source (anchors / proposals)
    gts: torch.Tensor,  # (..., 4) targets
    means: tuple = (0.0, 0.0, 0.0, 0.0),
    stds: tuple = (1.0, 1.0, 1.0, 1.0),
) -> torch.Tensor:
    """mmdet ``bbox2delta``: (dx, dy, dw, dh) normalized by means/stds."""
    pw = boxes[..., 2] - boxes[..., 0]
    ph = boxes[..., 3] - boxes[..., 1]
    px = (boxes[..., 0] + boxes[..., 2]) * 0.5
    py = (boxes[..., 1] + boxes[..., 3]) * 0.5
    gw = gts[..., 2] - gts[..., 0]
    gh = gts[..., 3] - gts[..., 1]
    gx = (gts[..., 0] + gts[..., 2]) * 0.5
    gy = (gts[..., 1] + gts[..., 3]) * 0.5
    eps = 1e-6
    deltas = torch.stack([
        (gx - px) / pw.clamp(min=eps),
        (gy - py) / ph.clamp(min=eps),
        torch.log(gw.clamp(min=eps) / pw.clamp(min=eps)),
        torch.log(gh.clamp(min=eps) / ph.clamp(min=eps)),
    ], -1)
    means = deltas.new_tensor(means)
    stds = deltas.new_tensor(stds)
    return (deltas - means) / stds


def decode_deltas(
    boxes: torch.Tensor,  # (..., 4) anchors / proposals
    deltas: torch.Tensor,  # (..., 4)
    means: tuple = (0.0, 0.0, 0.0, 0.0),
    stds: tuple = (1.0, 1.0, 1.0, 1.0),
    wh_ratio_clip: float = 16 / 1000,
) -> torch.Tensor:
    """mmdet ``delta2bbox`` without the max_shape clamp (see
    :func:`clip_boxes`)."""
    d = deltas * deltas.new_tensor(stds) + deltas.new_tensor(means)
    max_ratio = abs(math.log(wh_ratio_clip))
    dw = d[..., 2].clamp(-max_ratio, max_ratio)
    dh = d[..., 3].clamp(-max_ratio, max_ratio)
    pw = boxes[..., 2] - boxes[..., 0]
    ph = boxes[..., 3] - boxes[..., 1]
    px = (boxes[..., 0] + boxes[..., 2]) * 0.5
    py = (boxes[..., 1] + boxes[..., 3]) * 0.5
    gx = px + pw * d[..., 0]
    gy = py + ph * d[..., 1]
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    return torch.stack([gx - gw * 0.5, gy - gh * 0.5, gx + gw * 0.5, gy + gh * 0.5], -1)


def clip_boxes(boxes: torch.Tensor, img_hw: torch.Tensor) -> torch.Tensor:
    """Clamp x to [0, W] and y to [0, H]. ``img_hw`` is ``(..., 2)`` =
    (h, w), one row per leading index of ``boxes (..., N, 4)``."""
    h, w = img_hw[..., 0], img_hw[..., 1]
    hi = torch.stack([w, h, w, h], -1).to(boxes.dtype)
    return torch.minimum(boxes.clamp(min=0), hi.unsqueeze(-2))


def pairwise_iou(
    a: torch.Tensor,  # (N, 4)
    b: torch.Tensor,  # (M, 4)
    eps: float = 1e-6,
) -> torch.Tensor:
    """(N, M) IoU (mmdet ``bbox_overlaps``: zero-area boxes give IoU 0)."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:4], b[None, :, 2:4])
    whs = (rb - lt).clamp(min=0)
    inter = whs[..., 0] * whs[..., 1]
    area_a = (a[:, 2] - a[:, 0]).clamp(min=0) * (a[:, 3] - a[:, 1]).clamp(min=0)
    area_b = (b[:, 2] - b[:, 0]).clamp(min=0) * (b[:, 3] - b[:, 1]).clamp(min=0)
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / union.clamp(min=eps)
