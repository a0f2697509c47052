"""Post-hoc ensemble calibration trial:
``python -m oadp_torch.dp.test_calibrate <name> <config> <dump_root>
[--params '{...}'] [--override .k:v ...]`` (port of
``oadp_tpu/dp/test_calibrate.py``; reference ``oadp/dp/test_nni.py``).

Re-scores the per-image logit records that ``dp.test`` writes in DUMP mode
with 9 tunable scalars (base/novel scaler and exponent for the bbox and
object heads, the objectness exponent), runs the exact greedy
``multiclass_nms`` of ``ops/nms.py`` and evaluates
``COCO_{num_bases}_bbox_mAP_50``, the metric the reference reports to NNI.

The records are held as dense ``(images, 1000, C + 1)`` fp32 tensors on
``model.device`` (default ``cuda``; a run without a card raises unless the
config says ``'cpu'``), uploaded once: a sweep
(``python -m oadp_torch.dp.calibrate_sweep``) calls
:meth:`CalibrationRunner.run_trial` repeatedly without reloading them.
``oadp_tpu`` pads the last batch of images to a static shape; the images
are independent, so here the last batch is simply shorter.
"""

__all__ = ['DEFAULT_PARAMS', 'CalibrationRunner', 'rescore', 'run_trial', 'main']

import argparse
import json
import os
from typing import Sequence

import numpy as np
import torch

from ..base import Globals, coco, lvis
from ..oake.encoders import resolve_device
from ..ops.nms import multiclass_nms
from ..utils import Config, DictAction, PthAccessLayer, logger, maybe_initialize_distributed
from .coco_eval import CocoEvaluator, ov_coco_summary
from .datasets import CocoDetDataset

# reference defaults reproduce lambda = (2/3, 1/3) (test_nni.py:179-189)
DEFAULT_PARAMS = dict(
    bbox_base_scaler=1.0,
    bbox_novel_scaler=1.0,
    bbox_base_gamma=2 / 3,
    bbox_novel_gamma=1 / 3,
    object_base_scaler=1.0,
    object_novel_scaler=1.0,
    object_base_gamma=1 / 3,
    object_novel_gamma=2 / 3,
    objectness_gamma=0.0,
)


def _classify(scores: torch.Tensor, base_scaler, novel_scaler, base_gamma, novel_gamma,
              num_bases: int, num_all: int) -> torch.Tensor:
    """Scale the logits ``(..., K+1)`` per class, softmax over the last
    axis, raise to a per-class exponent; the background column takes 1
    for both. The scalars are fp32 0-d tensors."""
    k = torch.arange(scores.shape[-1], device=scores.device)
    is_base = k < num_bases
    is_novel = (k >= num_bases) & (k < num_all)
    one = scores.new_ones(())
    scaler = torch.where(is_base, base_scaler, torch.where(is_novel, novel_scaler, one))
    scores = torch.softmax(scores * scaler, dim=-1)
    gamma = torch.where(is_base, base_gamma, torch.where(is_novel, novel_gamma, one))
    return scores ** gamma


@torch.inference_mode()
def rescore(
    bboxes: torch.Tensor,  # (B, N, 4)
    bbox_logits: torch.Tensor,  # (B, N, K+1)
    object_logits: torch.Tensor,  # (B, N, K+1)
    objectness: torch.Tensor,  # (B, N)
    valid: torch.Tensor,  # (B, N)
    params: torch.Tensor | Sequence[float],  # (9,) in DEFAULT_PARAMS key order
    num_bases: int,
    num_all: int,
    max_per_img: int = 300,
    score_thr: float = 0.0,
    iou_threshold: float = 0.5,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The calibrated ensemble ``bbox_scores * object_scores *
    clip(objectness, 1e-12) ** objectness_gamma`` (zero on rows that are
    not valid), then one ``multiclass_nms`` over the batch. Returns ``(dets
    (B, M, 5), labels (B, M), rows (B, M), valid (B, M))``."""
    p = torch.as_tensor(params, dtype=torch.float32).to(bboxes.device)
    bb_s, bn_s, bb_g, bn_g, ob_s, on_s, ob_g, on_g, obj_g = p.unbind()
    bbox_scores = _classify(bbox_logits.float(), bb_s, bn_s, bb_g, bn_g, num_bases, num_all)
    object_scores = _classify(object_logits.float(), ob_s, on_s, ob_g, on_g, num_bases,
                              num_all)
    o = objectness.float().clamp(min=1e-12) ** obj_g
    ensemble = bbox_scores * object_scores * o[..., None]
    ensemble = torch.where(valid[..., None], ensemble, 0.0)
    return multiclass_nms(bboxes.float(), ensemble, score_thr=score_thr,
                          iou_threshold=iou_threshold, max_per_img=max_per_img,
                          num_classes=num_all)


class CalibrationRunner:
    """Loads all DUMP records once; evaluates many parameter settings.

    Memory model: records are held as dense tensors of ``m x max_proposals
    x (num_all + 1)`` fp32, ~2.6 GB for the OV-COCO val split (4952 images,
    C = 65), the only dataset the reference sweeps. OV-LVIS-scale dumps
    (~20k images, C = 1203) would need ~100 GB, so the constructor raises
    ``SystemExit`` before it loads a record when the dense buffers would
    exceed ``memory_budget_gb`` (default 16, or ``OADP_CALIBRATE_MEM_GB``).

    ``device`` (default ``model.device``, else ``cuda``) holds the tensors;
    a CUDA request without a card raises."""

    def __init__(
        self,
        config: Config,
        dump_root: str,
        batch_size: int = 32,
        max_proposals: int = 1000,
        memory_budget_gb: float | None = None,
        device: str | torch.device | None = None,
    ) -> None:
        self.device = resolve_device(
            device or config.get('model', Config()).get('device', 'cuda'))
        categories = {'coco': coco, 'lvis': lvis}[config.categories]
        Globals.categories = categories
        self.categories = categories
        val_cfg = config.validator.dataloader.dataset
        self.dataset = CocoDetDataset(val_cfg.ann_file, val_cfg.img_prefix, categories,
                                      test_mode=True)
        self.batch_size = batch_size
        layer = PthAccessLayer(dump_root)
        keys = [f'{img["id"]:012d}' for img in self.dataset.images
                if f'{img["id"]:012d}' in layer]
        if not keys:
            raise SystemExit(f'no DUMP records under {dump_root}')
        logger.info('loading %d DUMP records', len(keys))
        n = max_proposals
        k1 = categories.num_all + 1
        m = len(keys)
        if memory_budget_gb is None:
            memory_budget_gb = float(os.environ.get('OADP_CALIBRATE_MEM_GB', '16'))
        # bboxes(4) + 2 logit planes(k1 each) + objectness(1), fp32
        need_gb = m * n * (2 * k1 + 5) * 4 / 1e9
        if need_gb > memory_budget_gb:
            raise SystemExit(
                f'calibration would hold {need_gb:.1f} GB of dense record arrays ({m} '
                f'images x {n} proposals x C+1={k1}) — over the {memory_budget_gb:.0f} GB '
                'budget. The reference only ever sweeps OV-COCO val (~2.6 GB); for larger '
                'dumps raise OADP_CALIBRATE_MEM_GB, pass a smaller max_proposals, or sweep '
                'a record subset.')
        self.image_ids = [int(k) for k in keys]
        bboxes = np.zeros((m, n, 4), np.float32)
        bbox_logits = np.full((m, n, k1), -1e4, np.float32)
        object_logits = np.full((m, n, k1), -1e4, np.float32)
        objectness = np.zeros((m, n), np.float32)
        valid = np.zeros((m, n), bool)
        for i, key in enumerate(keys):
            rec = layer[key]
            c = min(len(np.asarray(rec['bboxes'])), n)
            bboxes[i, :c] = np.asarray(rec['bboxes'], np.float32)[:c]
            bbox_logits[i, :c] = np.nan_to_num(
                np.asarray(rec['bbox_logits'], np.float32)[:c], neginf=-1e4)
            object_logits[i, :c] = np.nan_to_num(
                np.asarray(rec['object_logits'], np.float32)[:c], neginf=-1e4)
            objectness[i, :c] = np.asarray(rec['objectness'], np.float32).reshape(-1)[:c]
            valid[i, :c] = True
        # uploaded once: trials re-score these without copying them again
        self.bboxes, self.bbox_logits, self.object_logits, self.objectness, self.valid = (
            torch.from_numpy(a).to(self.device)
            for a in (bboxes, bbox_logits, object_logits, objectness, valid))
        rcnn = config.get('model', Config()).get('test_cfg', Config())
        self.max_per_img = int(rcnn.get('max_per_img', 300))
        self.score_thr = float(rcnn.get('score_thr', 0.0))
        self.iou = float(rcnn.get('nms_iou', 0.5))

    def rescore_batch(self, params: dict[str, float], start: int, stop: int):
        """:func:`rescore` of images ``start:stop`` under ``params``."""
        sl = slice(start, stop)
        return rescore(
            self.bboxes[sl], self.bbox_logits[sl], self.object_logits[sl],
            self.objectness[sl], self.valid[sl], [params[k] for k in DEFAULT_PARAMS],
            num_bases=self.categories.num_bases, num_all=self.categories.num_all,
            max_per_img=self.max_per_img, score_thr=self.score_thr, iou_threshold=self.iou)

    def detections(self, params: dict[str, float]) -> list[dict]:
        """Every image's calibrated detections as COCO result dicts."""
        out = []
        m = len(self.image_ids)
        for start in range(0, m, self.batch_size):
            stop = min(start + self.batch_size, m)
            dets, labels, _rows, valid = (t.cpu().numpy()
                                          for t in self.rescore_batch(params, start, stop))
            for i in range(stop - start):
                img_id = self.image_ids[start + i]
                for j in np.nonzero(valid[i])[0]:
                    x0, y0, x1, y1 = dets[i, j, :4]
                    out.append(dict(
                        image_id=img_id,
                        category_id=self.dataset.cat_ids[int(labels[i, j])],
                        bbox=[float(x0), float(y0), float(x1 - x0), float(y1 - y0)],
                        score=float(dets[i, j, 4]),
                    ))
        return out

    def evaluate(self, detections: list[dict]) -> dict[str, float]:
        """The OV-COCO triple of ``detections``."""
        evaluator = CocoEvaluator(self.dataset.dataset, self.dataset.cat_ids,
                                  max_dets=(100, 300, 1000))
        evaluator.evaluate(detections)
        return ov_coco_summary(evaluator, self.categories.num_bases,
                               self.categories.num_novels)

    def run_trial(self, params: dict[str, float]) -> dict[str, float]:
        return self.evaluate(self.detections(params))


def run_trial(config: Config, dump_root: str, params: dict[str, float],
              device: str | torch.device | None = None) -> dict[str, float]:
    return CalibrationRunner(config, dump_root, device=device).run_trial(params)


def main(argv=None) -> dict:
    """Run one trial and print ``{"metric", "value", "params"}`` as the last
    line; returns that dict."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('name')
    parser.add_argument('config', type=Config.load)
    parser.add_argument('root')
    parser.add_argument('--params', type=str, default='')
    parser.add_argument('--override', action=DictAction, nargs='+')
    args = parser.parse_args(argv)
    config: Config = args.config
    if args.override:
        config.override(args.override)
    device = resolve_device(config.get('model', Config()).get('device', 'cuda'))
    # reference: oadp/dp/test_nni.py:198-200
    if maybe_initialize_distributed(device) and device.type == 'cuda':
        device = torch.device('cuda', torch.cuda.current_device())

    params = dict(DEFAULT_PARAMS)
    try:  # optional NNI integration (the reference's trials)
        import nni
        nni_params = nni.get_next_parameter()
        if nni_params:
            params.update(nni_params)
    except ImportError:
        nni = None
    if args.params:
        params.update(json.loads(args.params))

    metrics = run_trial(config, args.root, params, device=device)
    key = f'COCO_{Globals.categories.num_bases}_bbox_mAP_50'
    result = float(metrics.get(key, -1.0))
    logger.info('trial %s: %s = %s', params, key, result)
    out = {'metric': key, 'value': result, 'params': params}
    print(json.dumps(out))
    if nni is not None:
        nni.report_final_result(result)
    return out


if __name__ == '__main__':
    main()
