"""OAKE objects: masked attention-pool CLIP embeddings on proposals —
the computational hot spot of the whole system (reference
``oadp/oake/objects.py``; port of ``oadp_tpu/oake/objects.py``). Output
per image: ``dict(embeddings=(N,512), bboxes=(N,4), objectness=(N,1))``
fp16.

* proposal crops (ADAPTIVE square expansion, PIL-exact crop+resize) are
  computed on the device from per-crop scalars;
* background masks on the 14×14 patch grid are closed-form on the host
  (``ops/boxes.grid_mask``) — no full-resolution mask images;
* the masked attention-pool dual stream is an explicit model
  (``models/clip.image_encoder_surgery``), not forward hooks;
* crop batches are padded to power-of-two buckets, and ``batch_size``
  images share one encoder batch (chunks grouped by bucket, at the
  group's largest tap count), each chunk's inputs packed into one uint8
  buffer so a group is one host-to-device copy.
"""

__all__ = ['ObjectsPipeline', 'main']

import pickle
from typing import Any

import numpy as np

from ..ops import boxes as B
from ..ops import preprocess as P
from ..utils import Store
from .base import BUCKETS, BaseOakePipeline, CocoImageSet, HostCopy, bucket


class ObjectsPipeline(BaseOakePipeline):

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        if self.model.config.image_size != 224:
            # crop geometry is fixed at the CLIP input resolution, like
            # the reference's transforms (oadp/oake/objects.py:116-127)
            raise ValueError(
                'the objects pipeline requires a 224px CLIP '
                f'(got image_size={self.model.config.image_size}); '
                'shrink width/layers/heads instead for smoke runs'
            )
        self.mini_batch_size = int(self.config.get('mini_batch_size', 512))
        self.expand_mode = str(self.config.get('expand_mode', 'ADAPTIVE'))
        # images per encoder batch: 2 images of mini_batch_size crops
        # each keep the batch (2 * mini_batch_size) well inside HBM.
        self.device_batch = int(self.config.get('batch_size', 2))
        self._buckets = tuple(
            b for b in BUCKETS if b <= self.mini_batch_size
        ) or (self.mini_batch_size,)
        # Tap-count buckets for the compact resample coefficients; the
        # worst case is a sqrt(8)-expanded whole-image proposal.
        k_max = P.coeff_ksize(np.sqrt(8.0) * self.pad)
        self._k_buckets = tuple(
            k for k in (5, 9, 13, 21, 33, 49) if k < k_max
        ) + (k_max,)

    def dataset_kwargs(self, ds_cfg) -> dict[str, Any]:
        with open(ds_cfg.proposal_file, 'rb') as f:
            proposals = pickle.load(f)
        dataset = self._dataset
        ids = (
            dataset.ids
            if ds_cfg.get('proposal_sorted', True) else dataset.unsorted_ids
        )
        return dict(
            proposals={
                id_: np.asarray(p, np.float32)
                for id_, p in zip(ids, proposals)
            }
        )

    def build_dataset(self, dataset_cfg) -> CocoImageSet:
        self._dataset = super().build_dataset(dataset_cfg)
        return self._dataset

    def prepare(self, item: dict[str, Any]) -> dict[str, Any] | None:
        w, h = item['width'], item['height']
        raw = item['proposals'].get(item['id'])
        if raw is None or len(raw) == 0:
            return None
        proposals, objectness = raw[:, :4], raw[:, 4:5]
        keep = np.nonzero(B.filter_min_wh(proposals, 4, 4))[0]
        if Store.DRY_RUN:
            keep = keep[:5]  # first 5 FILTERED (reference objects.py:166-167)
        proposals = proposals[keep]
        objectness = objectness[keep]
        if len(proposals) == 0:
            return None

        crops = B.expand_boxes(proposals, w, h, self.expand_mode)
        foregrounds = proposals - np.concatenate(
            [crops[:, :2], crops[:, :2]], axis=-1
        )
        masks = B.grid_mask(foregrounds, crops, self.model.grid)

        # Per-crop scalar metadata; tap weights are derived on device
        # (``ops/preprocess.device_coeffs``). The tap count is bucketed
        # so a run sees a handful of shapes.
        meta = P.clip_transform_meta(w, h, crops)
        scale = np.maximum(
            np.maximum(meta[:, 2] / meta[:, 4], meta[:, 3] / meta[:, 5]),
            1.0,
        )
        ksizes = 2 * np.ceil(2.0 * scale).astype(int) + 1
        k = bucket(int(ksizes.max()), self._k_buckets)

        # Pad to buckets and PACK each chunk's inputs into one flat
        # uint8 buffer ``[image | masks | meta-float32-bytes]`` (host
        # numpy). The step stacks the group's buffers, so a group is one
        # pinned host-to-device copy; the device unpacks with views.
        grid = self.model.grid
        pad_meta = np.asarray(
            [0, 0, 224, 224, 224, 224, 0, 0, 1], np.float32
        )  # dummy-but-valid identity-crop meta for padded rows
        image_bytes = self._pad_image(item['image']).reshape(-1)
        n = len(proposals)
        chunks = []
        for start in range(0, n, self.mini_batch_size):
            stop = min(start + self.mini_batch_size, n)
            m = stop - start
            b = bucket(m, self._buckets)
            meta_pad = np.tile(pad_meta, (b, 1))
            masks_pad = np.zeros((b, grid, grid), np.uint8)
            meta_pad[:m] = meta[start:stop]
            masks_pad[:m] = masks[start:stop].astype(np.uint8)
            buf = np.concatenate([
                image_bytes,
                masks_pad.reshape(-1),
                meta_pad.view(np.uint8).reshape(-1),
            ])
            chunks.append((buf, b, m))
        return dict(
            output=item['output'],
            chunks=chunks,
            k=k,
            bboxes=proposals,
            objectness=objectness,
        )

    def execute_batch(self, prepared: list[dict[str, Any]]) -> list[Any]:
        # Group the batch's crop chunks by bucket rows: chunks sharing a
        # group run as ONE encoder batch (``objects_packed_step``), queued
        # without waiting, with one copy of its whole output back to the
        # host right behind it (``HostCopy``); finalize() waits for that
        # copy one batch later, so device compute overlaps host IO and the
        # next batch stays queued. A group takes the largest
        # tap bucket of its images: the extra taps weigh exactly 0, and each
        # chunk's tap sums split where its own bucket's do (``k_own``), so
        # every row is the one its own bucket gives (oadp_tpu splits by tap
        # bucket, because each is a separately compiled program).
        groups: dict[int, dict[str, list]] = {}
        for i, item in enumerate(prepared):
            for j, (buf, b, m) in enumerate(item['chunks']):
                g = groups.setdefault(b, dict(bufs=[], span=[], ks=[]))
                g['span'].append((i, j, len(g['bufs']) * b, m))
                g['bufs'].append(buf)
                g['ks'].append(item['k'])
        per_item: list[dict[int, tuple]] = [{} for _ in prepared]
        for b, g in groups.items():
            out = HostCopy(self.steps.objects_packed_step(
                g['bufs'], b, max(g['ks']), k_own=g['ks']))
            for i, j, off, m in g['span']:
                per_item[i][j] = (out, off, m)
        return [
            dict(
                _chunks=[chunks[j] for j in sorted(chunks)],
                bboxes=item['bboxes'].astype(np.float16),
                objectness=item['objectness'].astype(np.float16),
            )
            for item, chunks in zip(prepared, per_item)
        ]

    def finalize(self, record: dict[str, Any]) -> dict[str, Any]:
        chunks = record.pop('_chunks')
        record['embeddings'] = np.concatenate([
            out.wait()[off:off + m].numpy() for out, off, m in chunks
        ]).astype(np.float16)
        return record


def main(argv=None):
    return ObjectsPipeline.main(argv)


if __name__ == '__main__':
    main()
