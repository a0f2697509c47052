"""COCO detection evaluation in pure numpy (pycocotools-compatible), a
copy of ``oadp_tpu/dp/coco_eval.py``.

pycocotools is a C extension that the port does not depend on, so it
carries its own COCOeval implementation, faithful to
``cocoeval.py``: greedy per-(image, category) matching at IoU thresholds
0.50:0.05:0.95, crowd/area ignore semantics, 101-point interpolated
precision, and the reference's evaluation protocol — maxDets
``[100, 300, 1000]`` with the headline mAP at maxDets=100 (the
pycocotools ``_summarizeDets`` default) and AP50/75/s/m/l at
maxDets[-1] (reference ``oadp/dp/datasets.py:104``).

The OV-COCO triple summary (all / base / novel) slices the accumulated
precision/recall tensors by category columns exactly like the reference
(``oadp/dp/datasets.py:117-129``).
"""

__all__ = ['CocoEvaluator', 'ov_coco_summary']

import ctypes

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    'all': (0.0, 1e10),
    's': (0.0, 32.0 ** 2),
    'm': (32.0 ** 2, 96.0 ** 2),
    'l': (96.0 ** 2, 1e10),
}


def _iou_xywh(dts: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray):
    """pycocotools ``iou`` for xywh boxes; crowd gts use IoA (inter over
    det area)."""
    if len(dts) == 0 or len(gts) == 0:
        return np.zeros((len(dts), len(gts)))
    dx1, dy1 = dts[:, 0], dts[:, 1]
    dx2, dy2 = dts[:, 0] + dts[:, 2], dts[:, 1] + dts[:, 3]
    gx1, gy1 = gts[:, 0], gts[:, 1]
    gx2, gy2 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    iw = np.clip(
        np.minimum(dx2[:, None], gx2[None]) -
        np.maximum(dx1[:, None], gx1[None]), 0, None,
    )
    ih = np.clip(
        np.minimum(dy2[:, None], gy2[None]) -
        np.maximum(dy1[:, None], gy1[None]), 0, None,
    )
    inter = iw * ih
    d_area = dts[:, 2] * dts[:, 3]
    g_area = gts[:, 2] * gts[:, 3]
    union = np.where(
        iscrowd[None, :],
        d_area[:, None],
        d_area[:, None] + g_area[None, :] - inter,
    )
    return inter / np.maximum(union, 1e-12)


def _match_pairs_py(
    ious: np.ndarray, g_ignore: np.ndarray, iscrowd: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Pure-Python greedy matching (pycocotools evaluateImg inner loop);
    reference for — and fallback of — the native kernel."""
    nd, ng = ious.shape
    t = len(IOU_THRS)
    dtm = np.zeros((t, nd), np.int32)
    gtm = np.zeros((t, ng), np.int64)
    dt_ignore = np.zeros((t, nd), bool)
    for ti, thr in enumerate(IOU_THRS):
        for di in range(nd):
            best = min(thr, 1 - 1e-10)
            m = -1
            for gi in range(ng):
                if gtm[ti, gi] > 0 and not iscrowd[gi]:
                    continue
                # stop at ignored gts once matched to a real one
                if m > -1 and not g_ignore[m] and g_ignore[gi]:
                    break
                if ious[di, gi] < best:
                    continue
                best = ious[di, gi]
                m = gi
            if m == -1:
                continue
            dtm[ti, di] = 1 + m
            gtm[ti, m] = 1 + di
            dt_ignore[ti, di] = g_ignore[m]
    return dtm, dt_ignore


def _match_pairs(
    ious: np.ndarray, g_ignore: np.ndarray, iscrowd: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    nd, ng = ious.shape
    if nd == 0 or ng == 0:
        t = len(IOU_THRS)
        return np.zeros((t, nd), np.int32), np.zeros((t, nd), bool)
    from ..native import load_library
    lib = load_library('cocoeval_match')
    if lib is None:
        return _match_pairs_py(ious, g_ignore, iscrowd)
    t = len(IOU_THRS)
    dtm = np.zeros((t, nd), np.int32)
    dt_ig = np.zeros((t, nd), np.uint8)
    lib.match_pairs(
        np.ascontiguousarray(ious, np.float64).ctypes.data_as(
            ctypes.c_void_p
        ),
        np.ascontiguousarray(g_ignore, np.uint8).ctypes.data_as(
            ctypes.c_void_p
        ),
        np.ascontiguousarray(iscrowd, np.uint8).ctypes.data_as(
            ctypes.c_void_p
        ),
        np.ascontiguousarray(IOU_THRS, np.float64).ctypes.data_as(
            ctypes.c_void_p
        ),
        ctypes.c_int(nd),
        ctypes.c_int(ng),
        ctypes.c_int(t),
        dtm.ctypes.data_as(ctypes.c_void_p),
        dt_ig.ctypes.data_as(ctypes.c_void_p),
    )
    return dtm, dt_ig.astype(bool)


class CocoEvaluator:
    """Bbox (and mask-IoU precomputed) COCO evaluation.

    Args:
        dataset: COCO-format dict with ``images``, ``annotations``,
            ``categories``.
        cat_ids: ordered category ids to evaluate (column order of the
            precision tensor — base-first for OV).
        max_dets: evaluation maxDets; AP uses ``max_dets[-1]``.
    """

    def __init__(
        self,
        dataset: dict,
        cat_ids: list[int],
        max_dets: tuple = (100, 300, 1000),
    ) -> None:
        self.cat_ids = list(cat_ids)
        self.max_dets = list(max_dets)
        self.img_ids = [img['id'] for img in dataset['images']]
        self._gts: dict = {
            (i, c): [] for i in self.img_ids for c in self.cat_ids
        }
        for ann in dataset['annotations']:
            keyed = (ann['image_id'], ann['category_id'])
            if keyed in self._gts:
                self._gts[keyed].append(ann)
        self.eval: dict = {}

    def _pair_ious(self, dts, gts, iscrowd) -> np.ndarray:
        d_boxes = np.array([d['bbox'] for d in dts]).reshape(-1, 4)
        g_boxes = np.array([g['bbox'] for g in gts]).reshape(-1, 4)
        return _iou_xywh(d_boxes, g_boxes, iscrowd)

    # -- per (img, cat) matching ------------------------------------------

    def _evaluate_img(self, dts, gts, area_rng, max_det, ious=None):
        """``dts`` must already be score-sorted and capped at the
        largest maxDet; ``ious`` (optional) are the precomputed pair
        IoUs against ``gts`` in their given order — pycocotools computes
        IoUs ONCE per (img, cat) and re-slices per area range
        (``cocoeval.py computeIoU``/``evaluateImg``)."""
        if len(dts) == 0 and len(gts) == 0:
            return None
        g_ignore = np.array([
            bool(g.get('iscrowd', 0))
            or g['area'] < area_rng[0] or g['area'] > area_rng[1]
            or bool(g.get('ignore', 0))
            for g in gts
        ], dtype=bool)
        # sort gts: non-ignored first (stable)
        g_order = np.argsort(g_ignore, kind='mergesort')
        gts = [gts[i] for i in g_order]
        g_ignore = g_ignore[g_order]
        iscrowd = np.array(
            [bool(g.get('iscrowd', 0)) for g in gts], dtype=bool
        )
        dts = dts[:max_det]
        d_boxes = np.array([d['bbox'] for d in dts]).reshape(-1, 4)
        if ious is None:
            ious = self._pair_ious(dts, gts, iscrowd)
        else:
            ious = ious[:max_det][:, g_order]

        dtm, dt_ignore = _match_pairs(ious, g_ignore, iscrowd)
        d_area = d_boxes[:, 2] * d_boxes[:, 3]
        out_of_range = (d_area < area_rng[0]) | (d_area > area_rng[1])
        dt_ignore |= (dtm == 0) & out_of_range[None, :]
        return {
            'dt_scores': np.array(
                [d['score'] for d in dts], np.float64
            ),
            'dt_matched': dtm > 0,
            'dt_ignore': dt_ignore,
            'n_gt': int((~g_ignore).sum()),
        }

    # -- accumulate ----------------------------------------------------------

    def evaluate(self, detections: list[dict]) -> dict:
        """``detections``: COCO result dicts (image_id, category_id,
        bbox xywh, score). Populates ``self.eval`` with ``precision``
        ``(T, R, K, A, M)`` and ``recall (T, K, A, M)``."""
        dts: dict = {
            (i, c): [] for i in self.img_ids for c in self.cat_ids
        }
        for d in detections:
            keyed = (d['image_id'], d['category_id'])
            if keyed in dts:
                dts[keyed].append(d)

        t, r = len(IOU_THRS), len(REC_THRS)
        k, a, m = len(self.cat_ids), len(AREA_RNG), len(self.max_dets)
        precision = -np.ones((t, r, k, a, m))
        recall = -np.ones((t, k, a, m))

        area_items = list(AREA_RNG.values())
        max_det_cap = self.max_dets[-1]
        for ki, cat in enumerate(self.cat_ids):
            # evaluate at the largest maxDet; smaller caps re-slice
            per_area = [[] for _ in area_items]
            for img in self.img_ids:
                dt_list = dts[(img, cat)]
                gt_list = self._gts[(img, cat)]
                if not dt_list and not gt_list:
                    for ai in range(len(area_items)):
                        per_area[ai].append(None)
                    continue
                # score-sort + IoUs ONCE per (img, cat); the per-area
                # calls reorder gt columns only (pycocotools computeIoU)
                d_order = np.argsort(
                    [-d['score'] for d in dt_list], kind='mergesort'
                )[:max_det_cap]
                dt_list = [dt_list[i] for i in d_order]
                iscrowd0 = np.array(
                    [bool(g.get('iscrowd', 0)) for g in gt_list], bool
                )
                ious = self._pair_ious(dt_list, gt_list, iscrowd0)
                for ai, rng in enumerate(area_items):
                    e = self._evaluate_img(
                        dt_list, gt_list, rng, max_det_cap, ious,
                    )
                    per_area[ai].append(e)
            for ai in range(a):
                evals = [e for e in per_area[ai] if e is not None]
                if not evals:
                    continue
                scores = np.concatenate([e['dt_scores'] for e in evals])
                order = np.argsort(-scores, kind='mergesort')
                n_gt = sum(e['n_gt'] for e in evals)
                for mi, md in enumerate(self.max_dets):
                    matched = np.concatenate(
                        [e['dt_matched'][:, :md] for e in evals], axis=1
                    )
                    ignored = np.concatenate(
                        [e['dt_ignore'][:, :md] for e in evals], axis=1
                    )
                    sc = np.concatenate(
                        [e['dt_scores'][:md] for e in evals]
                    )
                    ord_m = np.argsort(-sc, kind='mergesort')
                    matched = matched[:, ord_m]
                    ignored = ignored[:, ord_m]
                    if n_gt == 0:
                        continue
                    tps = matched & ~ignored
                    fps = ~matched & ~ignored
                    tp_sum = np.cumsum(tps, axis=1, dtype=np.float64)
                    fp_sum = np.cumsum(fps, axis=1, dtype=np.float64)
                    for ti in range(t):
                        tp, fp = tp_sum[ti], fp_sum[ti]
                        rc = tp / n_gt
                        pr = tp / np.maximum(tp + fp, np.spacing(1))
                        recall[ti, ki, ai, mi] = rc[-1] if len(rc) else 0
                        # monotone interpolation from the right
                        pr = pr.tolist()
                        for i in range(len(pr) - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds = np.searchsorted(rc, REC_THRS, side='left')
                        q = np.zeros(r)
                        for ri, pi in enumerate(inds):
                            if pi < len(pr):
                                q[ri] = pr[pi]
                        precision[ti, :, ki, ai, mi] = q

        self.eval = {'precision': precision, 'recall': recall}
        return self.eval

    # -- summarize ------------------------------------------------------------

    def summarize(
        self,
        precision: np.ndarray | None = None,
        recall: np.ndarray | None = None,
    ) -> dict[str, float]:
        """The six stats the reference logs (``oadp/dp/datasets.py:
        86-97``): mAP, AP50, AP75, APs, APm, APl.

        pycocotools' ``_summarizeDets`` computes the headline mAP (the
        ``''`` stat) at the DEFAULT ``maxDets=100`` even when
        ``params.maxDets=[100, 300, 1000]``; only AP50/75/s/m/l use
        ``maxDets[-1]``. Mirror that so the numbers are
        protocol-compatible whenever an image has >100 detections
        (common with ``score_thr=0``)."""
        p = self.eval['precision'] if precision is None else precision
        mi_headline = (
            self.max_dets.index(100) if 100 in self.max_dets else -1
        )

        def ap(iou=None, area='all', mi=-1):
            ai = list(AREA_RNG).index(area)
            s = p[:, :, :, ai, mi]
            if iou is not None:
                ti = int(np.argwhere(np.isclose(IOU_THRS, iou))[0][0])
                s = s[ti:ti + 1]
            s = s[s > -1]
            return float(s.mean()) if s.size else -1.0

        return {
            '': ap(mi=mi_headline),
            '50': ap(iou=0.5),
            '75': ap(iou=0.75),
            's': ap(area='s'),
            'm': ap(area='m'),
            'l': ap(area='l'),
        }


def ov_coco_summary(
    evaluator: CocoEvaluator, num_bases: int, num_novels: int
) -> dict[str, float]:
    """Triple summary (48_17 / 48 / 17), reference
    ``oadp/dp/datasets.py:104-129``."""
    precision = evaluator.eval['precision']
    out: dict[str, float] = {}

    def emit(prefix, p):
        stats = evaluator.summarize(precision=p)
        for k, v in stats.items():
            out[f'{prefix}_bbox_mAP_{k}'] = round(v, 4)

    emit(f'COCO_{num_bases}_{num_novels}', precision)
    emit(f'COCO_{num_bases}', precision[:, :, :num_bases])
    emit(f'COCO_{num_novels}', precision[:, :, num_bases:])
    return out
