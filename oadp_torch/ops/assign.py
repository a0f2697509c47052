"""MaxIoU assignment and random sampling on fixed shapes (port of
``oadp_tpu/ops/assign.py``).

mmdet's ``MaxIoUAssigner`` and ``RandomSampler`` (reference
``configs/dp/models/faster_rcnn_r50_fpn.py:74-119``) over padded boxes and
ground truths with validity masks: the sampled set is chosen by rank over
one uniform draw and compacted to a fixed length.

The draw is an argument (``oadp_tpu`` draws it from a JAX key inside the
function): the trainer takes it from its ``torch.Generator``, and tests pass
``oadp_tpu``'s own draw so that both sample the same indices. Every
``lax.top_k`` of ``oadp_tpu`` is a stable sort here, so ties go to the lower
index first as they do there.
"""

__all__ = ['max_iou_assign', 'random_sample']

import torch

from .coder import pairwise_iou


def max_iou_assign(
    boxes: torch.Tensor,  # (P, 4)
    box_valid: torch.Tensor,  # (P,) bool
    gts: torch.Tensor,  # (G, 4) padded
    gt_valid: torch.Tensor,  # (G,) bool
    pos_iou_thr: float,
    neg_iou_thr: float,
    min_pos_iou: float,
    match_low_quality: bool,
) -> torch.Tensor:
    """Returns ``assigned (P,) int32``: -1 ignore, 0 negative, ``g + 1``
    matched to gt ``g`` (mmdet's convention). Invalid boxes are -1; invalid
    gts never match."""
    overlaps = pairwise_iou(gts.float(), boxes.float())  # (G, P)
    overlaps = torch.where(gt_valid[:, None], overlaps, -1.0)
    max_overlaps = torch.where(gt_valid.any(), overlaps.amax(0), 0.0)
    argmax_overlaps = overlaps.argmax(0)  # the first gt among ties, as oadp_tpu's

    assigned = torch.full_like(argmax_overlaps, -1, dtype=torch.int32)
    assigned = torch.where((max_overlaps >= 0) & (max_overlaps < neg_iou_thr), 0, assigned)
    assigned = torch.where(max_overlaps >= pos_iou_thr, argmax_overlaps.int() + 1, assigned)
    if match_low_quality:
        # every box tied at a gt's max overlap (>= min_pos_iou) goes to that
        # gt; mmdet loops gts in order, so the largest such gt wins
        gt_max = overlaps.max(1, keepdim=True).values  # (G, 1)
        qualifies = (overlaps == gt_max) & (gt_max >= min_pos_iou) & gt_valid[:, None]
        gt_ids = torch.arange(gts.shape[0], dtype=torch.int32, device=gts.device)[:, None]
        best = torch.where(qualifies, gt_ids, -1).max(0).values
        assigned = torch.where(best >= 0, best + 1, assigned)
    return torch.where(box_valid, assigned, -1)


def _smallest(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` smallest keys, ties to the lower index first."""
    return torch.sort(keys, stable=True).indices[:k]


def random_sample(
    u: torch.Tensor,  # (P,) uniform draw in [0, 1)
    assigned: torch.Tensor,  # (P,) from max_iou_assign
    num: int,
    pos_fraction: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """mmdet ``RandomSampler`` (``neg_pos_ub=-1``): up to ``num *
    pos_fraction`` random positives, negatives fill the rest.

    Returns ``(inds (num,), valid (num,), is_pos (num,))``, positives first,
    padded with invalid slots when there are fewer than ``num`` candidates.
    The positive and negative sets are disjoint, so ranking both by the one
    draw keeps each subset uniform."""
    p = assigned.shape[0]
    dev = assigned.device
    is_pos = assigned > 0
    is_neg = assigned == 0
    k_pos = min(int(num * pos_fraction), p)
    k_neg = min(num, p)
    # the k smallest keys: a uniform random subset of the candidates (the
    # others carry key 2.0, sort last and are masked out after)
    pos_idx = _smallest(torch.where(is_pos, u, 2.0), k_pos)
    neg_idx = _smallest(torch.where(is_neg, u, 2.0), k_neg)
    pos_ok = is_pos[pos_idx]
    neg_ok = is_neg[neg_idx] & (torch.arange(k_neg, device=dev) < num - pos_ok.sum())

    # merge: positives first, then enough negatives to fill num (fp32
    # priorities, oadp_tpu's, so that the order among them is its order)
    cand = torch.cat([pos_idx, neg_idx])
    cand_pos = torch.cat([pos_ok, torch.zeros(k_neg, dtype=torch.bool, device=dev)])
    cand_ok = torch.cat([pos_ok, neg_ok])
    priority = (cand_pos.float() * 2.0 + cand_ok.float() * 1.0
                - torch.arange(cand.shape[0], dtype=torch.float32, device=dev) * 1e-6)
    k = min(num, p)
    slot = torch.sort(priority, descending=True, stable=True).indices[:k]
    inds = cand[slot]
    if k < num:  # fewer candidates than slots: pad with invalid
        inds = torch.cat([inds, inds.new_zeros(num - k)])
        slot = torch.cat([slot, slot.new_zeros(num - k)])
    valid = cand_ok[slot] & (torch.arange(num, device=dev) < k)
    return inds.int(), valid, cand_pos[slot] & valid
