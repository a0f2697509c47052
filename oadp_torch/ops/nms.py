"""Exact greedy NMS with fixed-size outputs (port of ``oadp_tpu/ops/nms.py``).

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

:func:`greedy_keep_sorted` computes the keep sets of many sorted problems
at once (one per class, or one per image). On a CUDA tensor it launches
``greedy_nms`` (``csrc/nms.cu``), once a call, with no suppression matrix
and no read back to the host: a block per problem walks 64-candidate
tiles, tests each tile against the boxes it kept before it and decides the
tile serially from bitmasks. On a CPU tensor it runs the plain version
(:func:`greedy_keep_sorted_plain`): the bool suppression matrix of
:func:`_pair_iou` and :func:`_greedy_keep`, which reaches the greedy keep
set by passes over it: a pass keeps every undecided candidate that no kept
or undecided candidate suppresses, and drops every one that a kept
candidate suppresses. Each decision is final, and the first undecided
candidate is decided in every pass, so the loop ends after as many passes
as the longest chain of suppressions (a handful on detector outputs); it
reads one flag from the device per pass. Both keep only the first
``max_keep`` of each problem's greedy set: the callers never use more.
``LAUNCHES`` counts the kernel's launches.
"""

__all__ = ['LAUNCHES', 'NEG_INF', 'batched_nms', 'greedy_keep_sorted',
           'greedy_keep_sorted_plain', 'multiclass_nms', 'nms', 'reset_launches']

import torch

from . import cuda_lib

NEG_INF = -1e10

# largest (problems x candidates x candidates) suppression block in one go
_BLOCK_ELEMENTS = 1 << 27
# most kept boxes of a problem that the kernel holds in shared memory; past
# it, the wrapper gives it a workspace (csrc/nms.cu: SMEM_KEPT)
_SMEM_KEPT = 8192

#: kernel launches, counted where the wrapper launches
LAUNCHES = {'greedy_nms': 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def greedy_keep_sorted_plain(
    boxes: torch.Tensor,
    alive: torch.Tensor,  # (P, n) bool
    iou_threshold: float,
    max_keep: int,
    order: torch.Tensor | None = None,  # (P, n)
) -> torch.Tensor:
    """:func:`greedy_keep_sorted` by :func:`_greedy_keep` on any device, in
    blocks of at most ``_BLOCK_ELEMENTS`` suppression entries. With
    ``order``, one IoU matrix of the shared boxes, read by each problem in
    its order."""
    p, n = alive.shape
    if p == 0 or n == 0:
        return torch.zeros_like(alive)
    if order is not None:
        sup_all = _suppression(boxes, iou_threshold)  # (n, n)
    chunk = max(1, _BLOCK_ELEMENTS // (n * n))
    keeps = []
    for lo in range(0, p, chunk):
        hi = min(p, lo + chunk)
        if order is None:
            sup = _suppression(boxes[lo:hi], iou_threshold)
        else:
            o = order[lo:hi]
            sup = torch.gather(sup_all[o], 2, o[:, None, :].expand(-1, n, -1))
        keeps.append(_greedy_keep(sup, alive[lo:hi])[0])
    keep = torch.cat(keeps)
    return keep & (keep.cumsum(-1) <= max_keep)


def greedy_keep_sorted(
    boxes: torch.Tensor,  # (P, n, 4) sorted, or (n, 4) read through ``order``
    alive: torch.Tensor,  # (P, n) bool
    iou_threshold: float,
    max_keep: int,
    order: torch.Tensor | None = None,  # (P, n) int64: problem p's i-th box
) -> torch.Tensor:
    """The greedy keep sets ``(P, n)`` of ``P`` problems whose candidates
    are sorted by descending score, each cut to its first ``max_keep``.

    Replaces ``oadp_tpu/ops/nms.py:nms``'s tile loop (``:38``) and
    ``_sorted_block_nms_lazy`` (``:187``). On the H100: ``greedy_nms``
    (``csrc/nms.cu``), one launch, a block per problem; it reads each box
    and flag once and writes a byte a candidate, and needs the IoU of each
    kept candidate with the alive ones after it, up to where the walk
    stops (microseconds at the main path's shapes by either bound): the
    serial walk over a problem's tiles is what takes its time. On a CPU
    tensor, the plain version."""
    if boxes.device.type == 'cpu':
        return greedy_keep_sorted_plain(boxes, alive, iou_threshold, max_keep, order)
    return _greedy_nms(boxes, alive, iou_threshold, max_keep, order)


def _greedy_nms(boxes, alive, iou_threshold, max_keep, order=None, cycles=None):
    """Launch ``greedy_nms``; with ``cycles`` (P, 3) int64, the kernel's
    per-problem clock cycles by part."""
    p, n = alive.shape
    want = (n, 4) if order is not None else (p, n, 4)
    if tuple(boxes.shape) != want or (order is not None and tuple(order.shape) != (p, n)):
        raise ValueError(f'greedy_nms: boxes {tuple(boxes.shape)} for alive {(p, n)}'
                         + ('' if order is None else f' and order {tuple(order.shape)}'))
    for t, dtype in ((boxes, torch.float32), (alive, torch.bool), (order, torch.int64),
                     (cycles, torch.int64)):
        if t is None:
            continue
        if t.device != boxes.device:
            raise ValueError('greedy_nms: all tensors must be on one CUDA device')
        if t.dtype != dtype:
            raise TypeError(f'greedy_nms: the CUDA kernel takes {dtype}, got {t.dtype}')
        if not t.is_contiguous():
            raise ValueError('greedy_nms: tensors must be contiguous')
    if boxes.data_ptr() % 16:
        raise ValueError('greedy_nms: boxes must be 16-byte aligned')
    keep = torch.empty_like(alive)
    if p == 0 or n == 0:
        return keep
    max_keep = max(0, min(int(max_keep), n))
    cap = -(-max_keep // 4) * 4
    # past _SMEM_KEPT the kept lists live here: cap boxes and areas a problem
    kept_ws = (torch.empty(p * cap * 5, dtype=torch.float32, device=boxes.device)
               if cap > _SMEM_KEPT else None)
    lib = cuda_lib.library()
    with torch.cuda.device(boxes.device):
        code = lib.oadp_greedy_nms(
            p, n, boxes.data_ptr(), None if order is None else order.data_ptr(),
            alive.data_ptr(), float(iou_threshold), max_keep, keep.data_ptr(),
            None if kept_ws is None else kept_ws.data_ptr(),
            None if cycles is None else cycles.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(code, 'greedy_nms')
    LAUNCHES['greedy_nms'] += 1
    return keep


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
    keep = greedy_keep_sorted(boxes.float()[order][None], (sc[order] > NEG_INF / 2)[None],
                              iou_threshold, max_out)[0]
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
    sc_t = torch.where(cls_scores > score_thr, cls_scores, NEG_INF).T.contiguous()  # (c, n)
    order = torch.sort(-sc_t, dim=-1, stable=True).indices
    sc_sorted = torch.gather(sc_t, 1, order)
    boxes_f32 = boxes.float()
    alive = sc_sorted > NEG_INF / 2
    shared = boxes.shape[-1] == 4
    # each class keeps at most max_per_img: a class's later kept candidates
    # rank behind max_per_img of its own and never reach the top
    if shared:
        # one box set for every class, each reading it in its own order
        keep = greedy_keep_sorted(boxes_f32.contiguous(), alive, iou_threshold, max_per_img,
                                  order=order)
    else:
        cboxes = boxes_f32.reshape(n, c, 4).transpose(0, 1)  # (c, n, 4)
        keep = greedy_keep_sorted(torch.gather(cboxes, 1, order[..., None].expand(-1, -1, 4)),
                                  alive, iou_threshold, max_per_img)
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
