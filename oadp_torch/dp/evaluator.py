"""Detection evaluation loop: inference on one card -> COCO / LVIS metrics
(port of ``oadp_tpu/dp/evaluator.py``).

Batches come from the orientation-grouped loader on one of two canvases,
go through :func:`models.detector.simple_test` on the evaluator's device,
and their detections are rescaled to original image coordinates and scored
by the in-repo ``CocoEvaluator`` (OV-COCO triple) or ``LvisEvaluator``
(bbox and, with masks, segm). The loop queues batch k on the device before
it turns batch k-1's results into records on the host.

DUMP mode (``Store.DUMP`` a directory): per-image raw logit records are
written as fp16 ``.pth`` files (rescaled boxes, both heads' logits,
objectness) for the post-hoc calibration, and no metrics are returned.

With several processes (``utils.dist``: a ``torch.distributed`` process
group, or ``RANK``/``WORLD_SIZE``), each loads its share of the batches and
rank 0 merges the records over a shared directory (:meth:`_gather`).
"""

__all__ = ['DetEvaluator']

import os
import pathlib
import pickle
import tempfile
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..base import Categories
from ..models import detector as DET
from ..utils import PthAccessLayer, Store, logger, rank, world_size
from .builder import canvas_anchors
from .coco_eval import CocoEvaluator, ov_coco_summary
from .datasets import BatchBuilder, CocoDetDataset, Loader, TestTransform, batch_canvas
from .lvis_eval import LvisEvaluator, ov_lvis_summary


def _barrier() -> None:
    """Wait for every process of the run (the process group's barrier)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            'a multi-process eval needs a torch.distributed process group for '
            'its barrier; initialise one before DetEvaluator.run')
    dist.barrier()


class DetEvaluator:

    def __init__(
        self,
        dataset: CocoDetDataset,
        config,  # DetectorConfig
        categories: Categories,
        device: torch.device | str = 'cuda',
        batch_size: int = 1,
        canvas: tuple[int, int] = (832, 1344),
        scale: tuple[int, int] = (1333, 800),
        bf16: bool = False,
        eval_type: str = 'ov_coco',
        work_dir: pathlib.Path | str | None = None,
    ) -> None:
        self.dataset = dataset
        self.config = config
        self.categories = categories
        self.device = torch.device(device)
        self.batch_size = batch_size
        self.dtype = torch.bfloat16 if bf16 else torch.float32
        self.eval_type = eval_type
        # multi-process gather root: the work dir is the one path every
        # rank already shares; /tmp is per host
        self.work_dir = work_dir
        builder = BatchBuilder(canvas=canvas, with_clip=False, num_all=categories.num_all)
        self.loader = Loader(dataset, builder, batch_size, TestTransform(scale),
                             shuffle=False, process_index=rank(),
                             process_count=world_size())
        self._anchors: dict[tuple, list[torch.Tensor]] = {}
        self._dump = PthAccessLayer(Store.DUMP, readonly=False) if Store.DUMP else None

    def anchors(self, canvas: tuple[int, int]) -> list[torch.Tensor]:
        """The per-level anchors of ``canvas`` on the device, made once."""
        if canvas not in self._anchors:
            self._anchors[canvas] = canvas_anchors(self.config, canvas, self.device)
        return self._anchors[canvas]

    @torch.inference_mode()
    def forward(self, params, stats, batch: dict[str, Any]) -> dict[str, torch.Tensor]:
        """Queue one loader batch on the device: the uint8 canvases are
        copied and normalised there, then :func:`simple_test`. Returns
        device tensors with only what this mode consumes, in one buffer
        (plus fp16 masks)."""
        images = torch.from_numpy(batch['images']).to(self.device, non_blocking=True)
        img_hw = torch.from_numpy(batch['img_hw']).to(self.device, non_blocking=True)
        out = DET.simple_test(
            params, stats,
            {'images': DET.ingest_images(images, self.dtype), 'img_hw': img_hw},
            self.config, self.anchors(batch_canvas(batch)),
        )
        if self._dump is not None:
            return {'dump': torch.cat([
                out['boxes'].float(), out['bbox_logits'].float(),
                out['object_logits'].float(), out['objectness'].float()[..., None],
                out['proposal_valid'].float()[..., None],
            ], -1)}
        res = {'packed': torch.cat([out['dets'].float(), out['labels'].float()[..., None],
                                    out['valid'].float()[..., None]], -1)}
        if out['masks'] is not None:
            # fp16 halves the (B, M, 28, 28) mask stream; sigmoid probs lose
            # < 6e-4, inside the mask rasterization deviation bound
            res['masks'] = out['masks'].half()
        return res

    def run(self, params, stats) -> dict[str, float]:
        """Evaluate the whole dataset with ``params``/``stats`` (already on
        the evaluator's device)."""
        results: dict[int, list[dict]] = {}
        n_done = 0
        pending = None
        for batch in self.loader.epoch(0):
            out = self.forward(params, stats, batch)
            if pending is not None:
                n_done += self._consume(results, *pending)
                if n_done % (50 * self.batch_size) == 0:
                    logger.info('eval: %d/%d images', n_done, len(self.dataset))
            pending = (out, batch['image_ids'], batch['scale_factor'], len(batch['image_ids']))
        if pending is not None:
            n_done += self._consume(results, *pending)

        if self._dump is not None:
            logger.info('DUMP mode: wrote %d records, skipping metrics', len(results))
            if world_size() > 1:
                # a run chaining dp.test into calibration on rank 0 must
                # not read a store other ranks are still writing
                _barrier()
            return {}
        return self._metrics(results)

    def _consume(self, results, out, ids, scale, b) -> int:
        out = {k: v.cpu().numpy() for k, v in out.items()}  # waits for the device
        for i in range(b):
            img_id = int(ids[i])
            if img_id in results:
                continue
            if self._dump is not None:
                self._write_dump(img_id, out['dump'][i], scale[i])
                results[img_id] = []
                continue
            packed = out['packed'][i]  # (M, 7): dets | label | valid
            dets = packed[:, :5]
            labels = packed[:, 5].astype(np.int64)
            valid = packed[:, 6] > 0.5
            masks = out.get('masks')
            boxes = dets[:, :4] / scale[i]  # back to original coords
            res = []
            for j in np.nonzero(valid)[0]:
                x0, y0, x1, y1 = boxes[j]
                det = dict(
                    image_id=img_id,
                    category_id=self.dataset.cat_ids[int(labels[j])],
                    bbox=[float(x0), float(y0), float(x1 - x0), float(y1 - y0)],
                    score=float(dets[j, 4]),
                )
                if masks is not None:
                    det['mask'] = masks[i, j]
                res.append(det)
            results[img_id] = res
        return b

    def _metrics(self, results: dict[int, list[dict]]) -> dict[str, float]:
        # (image_id, detections) pairs, deduplicated by image id at the
        # rank-0 merge: a padded batch can repeat an image on another rank
        parts = self._gather(sorted(results.items()))
        if parts is None:  # not rank 0: rank 0 evaluates
            return {}
        merged: dict[int, list[dict]] = {}
        for img_id, res in parts:
            merged.setdefault(img_id, res)
        detections = [d for res in merged.values() for d in res]
        if self.eval_type == 'lvis':
            metrics = {}
            bbox_eval = LvisEvaluator(self.dataset.dataset, self.dataset.cat_ids,
                                      iou_type='bbox')
            bbox_eval.evaluate(detections)
            metrics.update(ov_lvis_summary(bbox_eval))
            if detections and 'mask' in detections[0]:
                segm_eval = LvisEvaluator(self.dataset.dataset, self.dataset.cat_ids,
                                          iou_type='segm')
                segm_eval.evaluate(detections)
                metrics.update(ov_lvis_summary(segm_eval))
            return metrics
        evaluator = CocoEvaluator(self.dataset.dataset, self.dataset.cat_ids,
                                  max_dets=(100, 300, 1000))
        evaluator.evaluate(detections)
        return ov_coco_summary(evaluator, self.categories.num_bases,
                               self.categories.num_novels)

    #: monotonic per-evaluator round id: namespaces gather files so a rerun
    #: never reads a previous round's parts
    _gather_round = 0

    def _gather(
        self,
        payload: list,
        process_index: int | None = None,
        process_count: int | None = None,
        root: pathlib.Path | str | None = None,
        barrier=None,
        timeout_s: float = 600.0,
    ) -> list | None:
        """Multi-process gather of a picklable list over a shared directory
        (the run's ``work_dir``, else ``Store.DUMP``, else the per-host temp
        directory). Single process: identity.

        Each rank publishes its part atomically (temp file, then
        ``os.replace``) before the barrier, and rank 0 merges only after
        it, so a merge never reads a partial part or a stale one from an
        earlier run; rank 0 then unlinks the parts. ``process_index``,
        ``process_count`` and ``barrier`` are injectable for tests; the
        production barrier is ``torch.distributed.barrier()``."""
        pc = world_size() if process_count is None else process_count
        if pc == 1:
            return payload
        pi = rank() if process_index is None else process_index
        rnd = DetEvaluator._gather_round
        DetEvaluator._gather_round += 1
        root = pathlib.Path(
            root if root is not None
            else (self.work_dir or Store.DUMP or tempfile.gettempdir())
        ) / 'eval_gather'
        root.mkdir(parents=True, exist_ok=True)
        final = root / f'round{rnd:04d}_part_{pi:04d}.pkl'
        tmp = final.with_suffix('.tmp')
        with open(tmp, 'wb') as f:
            pickle.dump(payload, f)
        os.replace(tmp, final)  # atomic publish
        (barrier or _barrier)()
        if pi != 0:
            return None
        merged: list = []
        deadline = time.monotonic() + timeout_s
        for p in range(pc):
            part = root / f'round{rnd:04d}_part_{p:04d}.pkl'
            while not part.exists():
                if time.monotonic() > deadline:
                    raise TimeoutError(f'eval gather: {part} missing after {timeout_s}s')
                time.sleep(0.1)
            with open(part, 'rb') as f:
                merged.extend(pickle.load(f))
        for p in range(pc):  # don't accumulate parts across rounds/runs
            (root / f'round{rnd:04d}_part_{p:04d}.pkl').unlink(missing_ok=True)
        return merged

    def _write_dump(self, img_id: int, packed: np.ndarray, scale) -> None:
        """One DUMP record from the buffer :meth:`forward` builds:
        boxes(4) | bbox_logits(C+1) | object_logits(C+1) | objectness(1) |
        valid(1), the valid rows only, boxes rescaled to the original
        image (as the reference dumps them)."""
        c1 = (packed.shape[-1] - 6) // 2
        boxes = packed[:, :4]
        bbox_logits = packed[:, 4:4 + c1]
        object_logits = packed[:, 4 + c1:4 + 2 * c1]
        objectness = packed[:, -2]
        valid = packed[:, -1] > 0.5

        def half(x):
            # masked logits carry -1e10 (a finite -inf); store the
            # reference's literal -inf rather than overflow the cast
            x = np.where(x < -1e9, -np.inf, x)
            return x.astype(np.float16)

        self._dump[f'{img_id:012d}'] = {
            'bboxes': half(boxes[valid] / np.asarray(scale)),
            'bbox_logits': half(bbox_logits[valid]),
            'object_logits': half(object_logits[valid]),
            'objectness': half(objectness[valid]),
        }
