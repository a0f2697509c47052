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

``nms``, ``batched_nms`` and ``multiclass_nms`` take one image, or a batch
of them along a leading dimension, and stack their outputs as ``jax.vmap``
of ``oadp_tpu``'s functions does: every problem of the batch (an image's,
or an image's classes) goes to one :func:`greedy_keep_sorted` call.

:func:`greedy_keep_sorted` computes the keep sets of many sorted problems
at once. On a CUDA tensor it launches ``greedy_nms`` (``csrc/nms.cu``),
once a call, with no suppression matrix and no read back to the host: a
block, or a cluster of blocks (:func:`nms_plan`), per problem walks its
tiles, tests each tile against the boxes it kept before it and decides the
tile from bitmasks. On a CPU tensor it runs the plain version
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

__all__ = ['LAUNCHES', 'NEG_INF', 'NmsPlan', 'batched_nms', 'greedy_keep_sorted',
           'greedy_keep_sorted_plain', 'multiclass_nms', 'nms', 'nms_plan', 'reset_launches']

import dataclasses
import functools

import torch

from . import cuda_lib

NEG_INF = -1e10

# largest (problems x candidates x candidates) suppression block in one go
_BLOCK_ELEMENTS = 1 << 27
# most kept boxes a block of the kernel holds in shared memory; past it,
# the wrapper gives it a workspace (csrc/nms.cu: SMEM_KEPT)
_SMEM_KEPT = 8192

#: kernel launches, counted where the wrapper launches
LAUNCHES = {'greedy_nms': 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclasses.dataclass(frozen=True)
class NmsPlan:
    """How ``greedy_nms`` carries one launch: the blocks of a problem (a
    cluster of them when more than one), the threads of a block and the
    candidates of a tile."""
    cluster: int
    threads: int
    tile: int


#: the plans the kernel is built for (``csrc/nms.cu:launch_plan``)
NMS_PLANS = (NmsPlan(1, 128, 64), NmsPlan(1, 256, 64)) + tuple(
    NmsPlan(c, 1024, 128) for c in (1, 2, 4, 8, 16))
#: From ``profile_kernels.py --only nms`` (device ms under every plan on
#: an NVIDIA H100 80GB HBM3 at 700 W; PERF.md section 6): the RPN's train
#: problem (8,819 candidates, 1000 kept, few suppressed) takes 0.129 ms on
#: one block of 1024 threads, 0.080 on a cluster of 2, 0.051 on 4, 0.039
#: on 8 and 0.035 on 16 (tiles of 128; of 64: 0.050 on 8), one problem or
#: two alike; OV-COCO's 65 classes of 1000 (~50 kept each, most of the
#: rest suppressed) 0.038 on a block of 1024 each (tiles of 128; 0.040 of
#: 64), 0.045 on clusters of 2 (a cluster's blocks cannot skip the column
#: words of what the kept list suppressed), 0.062 on 256 threads; 32
#: images of them 0.327 on 128 threads, 0.355 on 256, 0.567 on 1024; two
#: OV-LVIS images (2 x 1203 classes) 0.375, 0.408 and 0.660.
#: A problem's blocks at most: 16 takes the non-portable cluster size.
CLUSTER_MAX = 16
#: the fewest candidates of a problem spread over a cluster
CLUSTER_MIN_N = 2048


def nms_plan(p: int, n: int, sms: int) -> NmsPlan:
    """The plan of a ``greedy_nms`` launch over ``p`` problems of ``n``
    candidates on a card of ``sms`` multiprocessors. Few long problems (the
    RPN's, one an image) take a cluster each, as wide as the card holds
    them side by side (up to :data:`CLUSTER_MAX`); other launches a block
    a problem, as many threads as leave each multiprocessor its share of
    the blocks (one of 1024 threads, or several of 256 or 128). Blocks of
    1024 threads walk tiles of 128 candidates, smaller ones of 64."""
    if 2 * p <= sms and n >= CLUSTER_MIN_N:
        cluster = 2
        while cluster < CLUSTER_MAX and 2 * cluster * p <= sms:
            cluster *= 2
        return NmsPlan(cluster, 1024, 128)
    room = 2048 // -(-p // sms)  # threads a block, the SM's 2048 shared out
    threads = max([t for t in (128, 256, 1024) if t <= room], default=128)
    return NmsPlan(1, threads, 128 if threads == 1024 else 64)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def _box_sets(boxes: torch.Tensor, p: int, n: int) -> tuple[torch.Tensor, int]:
    """Shared boxes ``(n, 4)`` or ``(S, n, 4)`` for ``p`` problems as
    ``(S, n, 4)`` and the problems a set serves (``p // S``)."""
    sets = boxes if boxes.dim() == 3 else boxes[None]
    s = sets.shape[0]
    if sets.dim() != 3 or tuple(sets.shape[1:]) != (n, 4) or s == 0 or p % s:
        raise ValueError(f'greedy_nms: shared boxes {tuple(boxes.shape)} for {p} problems '
                         f'of {n} candidates')
    return sets, p // s


def greedy_keep_sorted_plain(
    boxes: torch.Tensor,
    alive: torch.Tensor,  # (P, n) bool
    iou_threshold: float,
    max_keep: int,
    order: torch.Tensor | None = None,  # (P, n)
) -> torch.Tensor:
    """:func:`greedy_keep_sorted` by :func:`_greedy_keep` on any device, in
    blocks of at most ``_BLOCK_ELEMENTS`` suppression entries. With
    ``order``, one IoU matrix a shared box set, read by each of its
    problems in that problem's order."""
    p, n = alive.shape
    if p == 0 or n == 0:
        return torch.zeros_like(alive)
    if order is not None:
        sets, group = _box_sets(boxes, p, n)
    chunk = max(1, _BLOCK_ELEMENTS // (n * n))
    keeps = []
    for lo in range(0, p, chunk):
        hi = min(p, lo + chunk)
        if order is None:
            sup = _suppression(boxes[lo:hi], iou_threshold)
        else:
            first = lo // group
            sup_sets = _suppression(sets[first:(hi - 1) // group + 1], iou_threshold)
            o = order[lo:hi]
            which = torch.arange(lo, hi, device=o.device) // group - first
            sup = torch.gather(sup_sets[which[:, None], o], 2, o[:, None, :].expand(-1, n, -1))
        keeps.append(_greedy_keep(sup, alive[lo:hi])[0])
    keep = torch.cat(keeps)
    return keep & (keep.cumsum(-1) <= max_keep)


def greedy_keep_sorted(
    boxes: torch.Tensor,  # (P, n, 4) sorted; or (n, 4) / (S, n, 4) read through ``order``
    alive: torch.Tensor,  # (P, n) bool
    iou_threshold: float,
    max_keep: int,
    order: torch.Tensor | None = None,  # (P, n) int64: problem p's i-th box
) -> torch.Tensor:
    """The greedy keep sets ``(P, n)`` of ``P`` problems whose candidates
    are sorted by descending score, each cut to its first ``max_keep``.
    With ``order``, the boxes are ``S`` shared sets (``(n, 4)`` for one):
    problem ``p`` reads set ``p // (P // S)`` (an image's classes, its
    boxes) through ``order[p]``.

    Replaces ``oadp_tpu/ops/nms.py:nms``'s tile loop (``:38``) and
    ``_sorted_block_nms_lazy`` (``:187``), vmapped over a batch. On the
    H100: ``greedy_nms`` (``csrc/nms.cu``), one launch, a block or a
    cluster a problem (:func:`nms_plan`); it reads each box and flag once
    and writes a byte a candidate, and needs the IoU of each kept candidate
    with the alive ones after it, up to where the walk stops (microseconds
    at the main path's shapes by either bound): the walk over a problem's
    tiles is what takes its time. On a CPU tensor, the plain version."""
    if boxes.device.type == 'cpu':
        return greedy_keep_sorted_plain(boxes, alive, iou_threshold, max_keep, order)
    return _greedy_nms(boxes, alive, iou_threshold, max_keep, order)


def _greedy_nms(boxes, alive, iou_threshold, max_keep, order=None, plan=None, cycles=None):
    """Launch ``greedy_nms`` under ``plan`` (default :func:`nms_plan`'s);
    with ``cycles`` (P, 4) int64, the kernel's per-problem clock cycles by
    part."""
    p, n = alive.shape
    if order is not None:
        if tuple(order.shape) != (p, n):
            raise ValueError(f'greedy_nms: order {tuple(order.shape)} for alive {(p, n)}')
        _, group = _box_sets(boxes, p, n)
    elif tuple(boxes.shape) != (p, n, 4):
        raise ValueError(f'greedy_nms: boxes {tuple(boxes.shape)} for alive {(p, n)}')
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
    if cycles is not None and tuple(cycles.shape) != (p, 4):
        raise ValueError(f'greedy_nms: cycles {tuple(cycles.shape)} for {p} problems')
    if boxes.data_ptr() % 16:
        raise ValueError('greedy_nms: boxes must be 16-byte aligned')
    keep = torch.empty_like(alive)
    if p == 0 or n == 0:
        return keep
    if plan is None:
        plan = nms_plan(p, n, _sm_count(boxes.device.index or 0))
    if plan not in NMS_PLANS:
        raise ValueError(f'greedy_nms: no kernel for {plan}')
    max_keep = max(0, min(int(max_keep), n))
    per_block = -(-max_keep // plan.cluster)
    cap = -(-per_block // 4) * 4  # a block's slots, as csrc/nms.cu counts them
    # past _SMEM_KEPT a block's slice of the kept list lives here: cap boxes
    # and areas a block
    kept_ws = (torch.empty(p * plan.cluster * cap * 5, dtype=torch.float32, device=boxes.device)
               if cap > _SMEM_KEPT else None)
    lib = cuda_lib.library()
    with torch.cuda.device(boxes.device):
        code = lib.oadp_greedy_nms(
            p, n, group if order is not None else 1, boxes.data_ptr(),
            None if order is None else order.data_ptr(), alive.data_ptr(),
            float(iou_threshold), max_keep, plan.cluster, plan.threads, plan.tile,
            keep.data_ptr(), None if kept_ws is None else kept_ws.data_ptr(),
            None if cycles is None else cycles.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(code, 'greedy_nms')
    LAUNCHES['greedy_nms'] += 1
    return keep


def nms(
    boxes: torch.Tensor,  # ([B,] N, 4)
    scores: torch.Tensor,  # ([B,] N); invalid entries carry NEG_INF
    iou_threshold: float,
    max_out: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS. Returns ``(indices, valid)`` of shape ``([B,] max_out)``,
    the kept candidates in descending score order, then padding; a batch's
    images in one kernel launch."""
    if boxes.dim() == 2:
        idx, valid = nms(boxes[None], scores[None], iou_threshold, max_out)
        return idx[0], valid[0]
    b, n = scores.shape
    sc = scores.float()
    order = torch.sort(-sc, dim=-1, stable=True).indices
    sboxes = torch.gather(boxes.float(), 1, order[..., None].expand(-1, -1, 4))
    keep = greedy_keep_sorted(sboxes, torch.gather(sc, 1, order) > NEG_INF / 2,
                              iou_threshold, max_out)
    pos = torch.arange(n, device=boxes.device)
    sel = torch.argsort(torch.where(keep, pos, n + pos), dim=-1)[:, :max_out]
    valid = torch.gather(keep, 1, sel)
    idx = torch.where(valid, torch.gather(order, 1, sel), 0).to(torch.int32)
    if n < max_out:
        idx = torch.cat([idx, idx.new_zeros(b, max_out - n)], 1)
        valid = torch.cat([valid, valid.new_zeros(b, max_out - n)], 1)
    return idx, valid


def batched_nms(
    boxes: torch.Tensor,  # ([B,] N, 4)
    scores: torch.Tensor,  # ([B,] N)
    ids: torch.Tensor,  # ([B,] N) class / level ids
    iou_threshold: float,
    max_out: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Category-aware NMS by mmcv's coordinate-offset trick: boxes of
    different ids are shifted apart by ``(max + 1) * id`` in fp32, the max
    an image's (the shift rounds the IoU as ``oadp_tpu``'s does), so they
    never overlap."""
    top = boxes.flatten(-2).amax(-1)[..., None]
    offset = (top + 1.0) * ids.to(boxes.dtype)
    return nms(boxes + offset[..., None], scores, iou_threshold, max_out)


def multiclass_nms(
    boxes: torch.Tensor,  # ([B,] N, 4) or ([B,] N, C*4)
    scores: torch.Tensor,  # ([B,] N, C+1), background last
    score_thr: float,
    iou_threshold: float,
    max_per_img: int,
    num_classes: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """mmdet ``multiclass_nms``: per-class greedy NMS over the N x C
    candidates (scores strictly above ``score_thr``), then the top
    ``max_per_img`` kept candidates over all classes, ties to the lower
    (class, sorted position). A batch's B x C problems go to one kernel
    launch.

    Returns ``(dets ([B,] M, 5), labels ([B,] M), indices ([B,] M), valid
    ([B,] M))`` with ``indices`` into the N rows; invalid rows are zero,
    label -1."""
    if scores.dim() == 2:
        return tuple(t[0] for t in multiclass_nms(boxes[None], scores[None], score_thr,
                                                  iou_threshold, max_per_img, num_classes))
    b, n, c1 = scores.shape
    c = num_classes
    if c1 != c + 1:
        raise ValueError(f'scores have {c1} columns for {c} classes + background')
    cls_scores = scores[..., :c].float()
    sc_t = torch.where(cls_scores > score_thr, cls_scores, NEG_INF).transpose(1, 2).contiguous()
    order = torch.sort(-sc_t, dim=-1, stable=True).indices
    sc_sorted = torch.gather(sc_t, 2, order)
    boxes_f32 = boxes.float()
    alive = (sc_sorted > NEG_INF / 2).reshape(b * c, n)
    shared = boxes.shape[-1] == 4
    # each class keeps at most max_per_img: a class's later kept candidates
    # rank behind max_per_img of its own and never reach the top
    if shared:
        # one box set an image, each of its classes reading it in its own order
        keep = greedy_keep_sorted(boxes_f32.contiguous(), alive, iou_threshold, max_per_img,
                                  order=order.reshape(b * c, n))
    else:
        cboxes = boxes_f32.reshape(b, n, c, 4).transpose(1, 2)  # (b, c, n, 4)
        sboxes = torch.gather(cboxes, 2, order[..., None].expand(-1, -1, -1, 4))
        keep = greedy_keep_sorted(sboxes.reshape(b * c, n, 4), alive, iou_threshold,
                                  max_per_img)
    kept = torch.where(keep.reshape(b, c, n), sc_sorted, NEG_INF).reshape(b, c * n)
    k = min(max_per_img, c * n)
    top_sc, top_i = torch.sort(kept, dim=-1, descending=True, stable=True)
    top_sc, top_i = top_sc[:, :k], top_i[:, :k]
    if k < max_per_img:
        top_sc = torch.cat([top_sc, top_sc.new_full((b, max_per_img - k), NEG_INF)], 1)
        top_i = torch.cat([top_i, top_i.new_zeros(b, max_per_img - k)], 1)
    kc = torch.div(top_i, n, rounding_mode='floor')
    rows = torch.gather(order.reshape(b, c * n), 1, top_i)
    valid = top_sc > NEG_INF / 2
    if shared:
        sel_boxes = torch.gather(boxes_f32, 1, rows[..., None].expand(-1, -1, 4))
    else:
        img = torch.arange(b, device=boxes.device)[:, None]
        sel_boxes = boxes_f32.reshape(b, n, c, 4)[img, rows, kc]
    dets = torch.cat([sel_boxes, top_sc[..., None]], -1)
    dets = torch.where(valid[..., None], dets, 0.0)
    labels = torch.where(valid, kc, -1).to(torch.int32)
    rows = torch.where(valid, rows, 0).to(torch.int32)
    return dets, labels, rows, valid
