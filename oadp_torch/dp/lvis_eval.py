"""LVIS v1 evaluation in numpy (lvis-api-compatible), a copy of
``oadp_tpu/dp/lvis_eval.py``.

The lvis package (C-backed via pycocotools) is not used; this module
implements the LVIS protocol on top of the in-repo COCO matcher
(``coco_eval.CocoEvaluator``):

* detections for categories that are neither positively annotated nor
  in the image's ``neg_category_ids`` are dropped (neither TP nor FP) —
  the federated-annotation rule;
* at most 300 detections per image across categories;
* AP summarized per frequency band: APr (rare), APc (common),
  APf (frequent) from the category ``frequency`` field;
* ``segm`` IoU from predicted 28x28 masks vs gt polygons
  (``ops.masks.mask_iou_pairs``) — no RLE/C extensions.
"""

__all__ = ['LvisEvaluator', 'ov_lvis_summary']

import numpy as np

from ..ops.masks import mask_iou_pairs
from .coco_eval import AREA_RNG, CocoEvaluator


class LvisEvaluator(CocoEvaluator):

    def __init__(
        self,
        dataset: dict,
        cat_ids: list[int],
        max_dets: tuple = (300,),
        iou_type: str = 'bbox',
    ) -> None:
        super().__init__(dataset, cat_ids, max_dets)
        self.iou_type = iou_type
        # federated annotations: per-image positive + negative sets
        self._img_pos: dict[int, set] = {i: set() for i in self.img_ids}
        for ann in dataset['annotations']:
            self._img_pos.setdefault(ann['image_id'], set()).add(
                ann['category_id']
            )
        self._img_neg: dict[int, set] = {
            img['id']: set(img.get('neg_category_ids', []))
            for img in dataset['images']
        }
        self._freq = {
            c['id']: c.get('frequency', 'f')
            for c in dataset['categories']
        }

    def _pair_ious(self, dts, gts, iscrowd) -> np.ndarray:
        if self.iou_type == 'bbox':
            return super()._pair_ious(dts, gts, iscrowd)
        dt_masks = [
            (np.asarray(d['mask'], np.float32), _xywh_to_xyxy(d['bbox']))
            for d in dts
        ]
        gt_polys = [g['segmentation'] for g in gts]
        gt_boxes = np.array(
            [_xywh_to_xyxy(g['bbox']) for g in gts]
        ).reshape(-1, 4)
        return mask_iou_pairs(dt_masks, gt_polys, gt_boxes, iscrowd)

    def evaluate(self, detections: list[dict]) -> dict:
        # 300 dets per image across categories (LVIS protocol)
        by_img: dict[int, list] = {i: [] for i in self.img_ids}
        for d in detections:
            if d['image_id'] in by_img:
                by_img[d['image_id']].append(d)
        kept = []
        cap = self.max_dets[-1]
        for img_id, dts in by_img.items():
            dts.sort(key=lambda d: -d['score'])
            pos = self._img_pos.get(img_id, set())
            neg = self._img_neg.get(img_id, set())
            for d in dts[:cap]:
                # federated rule: unverified categories are ignored
                if d['category_id'] in pos or d['category_id'] in neg:
                    kept.append(d)
        return super().evaluate(kept)


def _xywh_to_xyxy(b):
    return np.asarray([b[0], b[1], b[0] + b[2], b[1] + b[3]], np.float64)


def ov_lvis_summary(
    evaluator: LvisEvaluator, prefix: str = 'lvis'
) -> dict[str, float]:
    """LVIS stats: AP / AP50 / AP75 / APs / APm / APl / APr / APc / APf."""
    precision = evaluator.eval['precision']
    out: dict[str, float] = {}
    stats = evaluator.summarize()
    for k, v in stats.items():
        out[f'{prefix}_{evaluator.iou_type}_AP{k}'] = round(v, 4)

    all_idx = list(AREA_RNG).index('all')
    for band in ('r', 'c', 'f'):
        cols = [
            i for i, c in enumerate(evaluator.cat_ids)
            if evaluator._freq.get(c) == band
        ]
        if cols:
            s = precision[:, :, cols, all_idx, -1]
            s = s[s > -1]
            value = float(s.mean()) if s.size else -1.0
        else:
            value = -1.0
        out[f'{prefix}_{evaluator.iou_type}_AP{band}'] = round(value, 4)
    return out
