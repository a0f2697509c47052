"""Exact greedy NMS with fixed-size outputs, as torch ops on the device
(port of ``oadp_tpu/ops/nms.py``).

``oadp_tpu`` computes the greedy keep set of score-sorted candidates by a
blocked fixpoint (a TPU form); any form that reaches the greedy keep set
gives the same answer, so the port keeps the semantics and not the form:

* candidates sorted by descending score, stable (ties keep the lower
  index first), scores at ``NEG_INF`` not alive;
* candidate ``j`` is kept iff no kept ``i`` before it has IoU > threshold
  with it; IoU with no +1 and a ``1e-6`` floor on the union, computed
  with ``oadp_tpu``'s operations in fp32, so that the same boxes give the
  same bits (the IoU is symmetric to the bit, so a class-agnostic box set
  computes it once and each class reads it in its own order);
* outputs padded to ``max_out`` as ``(index, valid)`` pairs.

:func:`_greedy_keep` reaches the greedy keep set by passes over the
suppression matrix: a pass keeps every undecided candidate that no kept or
undecided candidate suppresses, and drops every one that a kept candidate
suppresses. Each decision is final, and the first undecided candidate is
decided in every pass, so the loop ends after as many passes as the
longest chain of suppressions (a handful on detector outputs). It reads
one flag from the device per pass.
"""

__all__ = ['NEG_INF', 'nms', 'batched_nms', 'multiclass_nms']

import torch

NEG_INF = -1e10

# largest (classes x candidates x candidates) suppression block in one go
_BLOCK_ELEMENTS = 1 << 27


def _pair_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of every box in ``a (..., T, 4)`` against every box in
    ``b (..., M, 4)`` -> ``(..., T, M)``."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:4], b[..., None, :, 2:4])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]).clamp(min=0) * (a[..., 3] - a[..., 1]).clamp(min=0)
    area_b = (b[..., 2] - b[..., 0]).clamp(min=0) * (b[..., 3] - b[..., 1]).clamp(min=0)
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter).clamp(min=1e-6)


def _suppression(sboxes: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """``(..., n, n)`` bool: IoU > threshold between candidates ``i`` and
    ``j`` of ``sboxes (..., n, 4)``."""
    return _pair_iou(sboxes, sboxes) > iou_threshold


def _greedy_keep(sup: torch.Tensor, alive: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Greedy keep set ``(..., n)`` of score-sorted candidates, given their
    suppression matrix ``sup (..., n, n)`` (bool, symmetric) and which are
    ``alive (..., n)``, and the number of passes it took."""
    n = alive.shape[-1]
    later = torch.ones(n, n, dtype=torch.bool, device=alive.device).triu(1)
    # 0/1 products in bf16 (exact; a positive sum of ones stays positive
    # however it rounds), half the bytes of fp32 a pass
    sup = (sup & later).to(torch.bfloat16)
    keep = torch.zeros_like(alive)
    undecided = alive.clone()
    passes = 0
    while True:
        passes += 1
        hits = torch.stack([keep, undecided], -2).to(torch.bfloat16) @ sup  # (..., 2, n)
        by_kept, by_undecided = hits[..., 0, :] > 0, hits[..., 1, :] > 0
        keep = keep | (undecided & ~by_kept & ~by_undecided)
        undecided = undecided & ~by_kept & by_undecided
        if not bool(undecided.any()):
            return keep, passes


def nms(
    boxes: torch.Tensor,  # (N, 4)
    scores: torch.Tensor,  # (N,); invalid entries carry NEG_INF
    iou_threshold: float,
    max_out: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS. Returns ``(indices, valid)`` of shape ``(max_out,)``,
    the kept candidates in descending score order, then padding."""
    n = boxes.shape[0]
    sc = scores.float()
    order = torch.sort(-sc, stable=True).indices
    keep, _ = _greedy_keep(_suppression(boxes.float()[order], iou_threshold),
                           sc[order] > NEG_INF / 2)
    pos = torch.arange(n, device=boxes.device)
    sel = torch.argsort(torch.where(keep, pos, n + pos))[:max_out]
    valid = keep[sel]
    idx = torch.where(valid, order[sel], 0).to(torch.int32)
    if n < max_out:
        idx = torch.cat([idx, idx.new_zeros(max_out - n)])
        valid = torch.cat([valid, valid.new_zeros(max_out - n)])
    return idx, valid


def batched_nms(
    boxes: torch.Tensor,  # (N, 4)
    scores: torch.Tensor,  # (N,)
    ids: torch.Tensor,  # (N,) class / level ids
    iou_threshold: float,
    max_out: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Category-aware NMS by mmcv's coordinate-offset trick: boxes of
    different ids are shifted apart by ``(max + 1) * id`` in fp32 (the shift
    rounds the IoU as ``oadp_tpu``'s does), so they never overlap."""
    offset = (boxes.max() + 1.0) * ids.to(boxes.dtype)
    return nms(boxes + offset[:, None], scores, iou_threshold, max_out)


def multiclass_nms(
    boxes: torch.Tensor,  # (N, 4) or (N, C*4)
    scores: torch.Tensor,  # (N, C+1), background last
    score_thr: float,
    iou_threshold: float,
    max_per_img: int,
    num_classes: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """mmdet ``multiclass_nms``: per-class greedy NMS over the N x C
    candidates (scores strictly above ``score_thr``), then the top
    ``max_per_img`` kept candidates over all classes, ties to the lower
    (class, sorted position).

    Returns ``(dets (M, 5), labels (M,), indices (M,), valid (M,))`` with
    ``indices`` into the N rows; invalid rows are zero, label -1."""
    n, c1 = scores.shape
    c = num_classes
    if c1 != c + 1:
        raise ValueError(f'scores have {c1} columns for {c} classes + background')
    cls_scores = scores[:, :c].float()
    sc_t = torch.where(cls_scores > score_thr, cls_scores, NEG_INF).T  # (c, n)
    order = torch.sort(-sc_t, dim=-1, stable=True).indices
    sc_sorted = torch.gather(sc_t, 1, order)
    boxes_f32 = boxes.float()
    shared = boxes.shape[-1] == 4
    if shared:
        # one IoU matrix for every class: each class reads it in its order
        sup_all = _suppression(boxes_f32, iou_threshold)  # (n, n)
    else:
        cboxes = boxes_f32.reshape(n, c, 4).transpose(0, 1)  # (c, n, 4)
    chunk = max(1, _BLOCK_ELEMENTS // max(n * n, 1))
    keeps = []
    for lo in range(0, c, chunk):
        hi = min(c, lo + chunk)
        o = order[lo:hi]
        if shared:
            sup = torch.gather(sup_all[o], 2, o[:, None, :].expand(-1, n, -1))
        else:
            sup = _suppression(torch.gather(cboxes[lo:hi], 1, o[..., None].expand(-1, -1, 4)),
                               iou_threshold)
        keeps.append(_greedy_keep(sup, sc_sorted[lo:hi] > NEG_INF / 2)[0])
    keep = torch.cat(keeps)
    kept = torch.where(keep, sc_sorted, NEG_INF).reshape(-1)
    k = min(max_per_img, c * n)
    top_sc, top_i = torch.sort(kept, descending=True, stable=True)
    top_sc, top_i = top_sc[:k], top_i[:k]
    if k < max_per_img:
        top_sc = torch.cat([top_sc, top_sc.new_full((max_per_img - k,), NEG_INF)])
        top_i = torch.cat([top_i, top_i.new_zeros(max_per_img - k)])
    kc = torch.div(top_i, n, rounding_mode='floor')
    rows = order[kc, top_i - kc * n]
    valid = top_sc > NEG_INF / 2
    sel_boxes = boxes_f32[rows] if shared else boxes_f32.reshape(n, c, 4)[rows, kc]
    dets = torch.cat([sel_boxes, top_sc[:, None]], -1)
    dets = torch.where(valid[:, None], dets, 0.0)
    labels = torch.where(valid, kc, -1).to(torch.int32)
    rows = torch.where(valid, rows, 0).to(torch.int32)
    return dets, labels, rows, valid
