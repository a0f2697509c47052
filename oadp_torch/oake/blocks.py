"""OAKE blocks: multi-scale crop-grid CLIP embeddings (reference
``oadp/oake/blocks.py``; port of ``oadp_tpu/oake/blocks.py``). Output per
image: ``dict(embeddings=(1+n, 512) fp16, bboxes=(1+n, 4) fp16)``, the
whole image first, then its n blocks.

A batch of images is one device step (``OakeSteps.blocks_step``): the
pyramid levels are resize-matrix pairs, the blocks are 224 x 224 windows
of the levels, and the wholes and blocks of the batch are encoded as one
ViT batch. The reference builds the pyramid with PIL on the host
(blocks.py:54-77).
"""

__all__ = ['BlocksPipeline', 'main']

import functools
from typing import Any

import numpy as np
import torch

from ..ops import preprocess as P
from .base import BaseOakePipeline, HostCopy, bucket
from .partitions import first_block_bbox, plan_blocks


class BlocksPipeline(BaseOakePipeline):

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.block_size = int(self.config.get('block_size', 224))
        self.max_stride = int(self.config.get('max_stride', 112))
        self.rescale = float(self.config.get('rescale', 1.5))
        self.max_levels = int(self.config.get('max_levels', 6))
        self.max_blocks = int(self.config.get('max_blocks', 48))
        # images per device step: one image is ~25 crops of 50 tokens,
        # too little work for a step of its own
        self.device_batch = int(self.config.get('batch_size', 24))
        # flat-block buckets: the ViT batch carries about the real block
        # count of the batch, not batch x max_blocks padded rows
        self.block_buckets = tuple(self.config.get(
            'block_buckets',
            (16, 32, 64, 96, 128, 160, 192, 224, 256, 320, 384,
             448, 512, 576, 640, 704, 768, 896, 1024, 1152),
        ))

    @functools.lru_cache(maxsize=64)
    def _size_constants(self, w: int, h: int):
        """Per-image-size constants: the pyramid and whole-image resize
        matrices (on the model's device), the block coordinates and the
        boxes. COCO sizes repeat heavily (640x480 is about half the
        dataset), so each distinct size is built and copied once."""
        plan = plan_blocks(
            w, h, self.block_size, self.max_stride, self.rescale
        )
        n_blocks = len(plan.blocks)
        if n_blocks > self.max_blocks:
            raise ValueError(
                f'image {w}x{h} yields {n_blocks} blocks > '
                f'max_blocks={self.max_blocks}; raise .max_blocks'
            )
        n_levels = len(plan.levels) - 1
        if n_levels > self.max_levels:
            raise ValueError(
                f'{n_levels} pyramid levels > max_levels={self.max_levels}'
            )

        pad = self.pad
        level_wx = np.zeros((self.max_levels, pad, pad), np.float32)
        level_wy = np.zeros((self.max_levels, pad, pad), np.float32)
        for k in range(n_levels):
            w0, h0 = plan.levels[k]
            w1, h1 = plan.levels[k + 1]
            mx, my = P.plain_resize_matrices(w0, h0, w1, h1, pad, pad)
            level_wx[k, :w1] = mx
            level_wy[k, :h1] = my

        # (level, y, x) per real block; the image index is added when the
        # batch's blocks are flattened
        coords = np.asarray(
            [(lv, y, x) for lv, x, y in plan.blocks], np.int32
        ).reshape(n_blocks, 3)

        whole_wx, whole_wy = P.clip_transform_matrices(w, h, None, pad, pad)
        bboxes = [first_block_bbox(w, h)] + plan.bboxes
        device = self.model.device
        arrays = tuple(
            torch.from_numpy(a).to(device)
            for a in (level_wx, level_wy, whole_wx, whole_wy)
        )
        return arrays, coords, np.asarray(bboxes, np.float32)

    def prepare(self, item: dict[str, Any]) -> dict[str, Any]:
        w, h = item['width'], item['height']
        arrays, coords, bboxes = self._size_constants(w, h)
        level_wx, level_wy, whole_wx, whole_wy = arrays
        return dict(
            output=item['output'],
            image=self._pad_image(item['image']),  # host: one copy a batch
            level_wx=level_wx,
            level_wy=level_wy,
            whole_wx=whole_wx,
            whole_wy=whole_wy,
            coords=coords,  # host (n_blocks, 3) int32 (level, y, x)
            bboxes=bboxes,
        )

    def execute_batch(self, prepared: list[dict[str, Any]]) -> list[Any]:
        n = len(prepared)
        # the image count is padded to a bucket, not to device_batch: a
        # tail batch of 3 images does not pay for a full batch's pyramid
        b_pad = min(self.device_batch, bucket(n, (1, 2, 4, 8, 16)))
        items = list(prepared)
        items += [items[-1]] * (b_pad - n)  # padding rows: ignored

        def gather(key):
            return [it[key] for it in items]

        # the batch's blocks as one flat list, padded to a bucket with
        # zero rows (image 0, level 0, top-left window)
        offsets, flat = [], []
        for item in prepared:
            offsets.append(sum(len(f) for f in flat))
            c = item['coords']
            img_col = np.full((len(c), 1), len(flat), np.int32)
            flat.append(np.concatenate([img_col, c], axis=1))
        total = offsets[-1] + len(flat[-1])
        t_pad = bucket(total, self.block_buckets)
        coords = np.concatenate(
            flat + [np.zeros((t_pad - total, 4), np.int32)], axis=0
        )
        emb = HostCopy(self.steps.blocks_step(
            np.stack(gather('image')), gather('level_wx'), gather('level_wy'),
            gather('whole_wx'), gather('whole_wy'), coords,
        ))  # queued with its copy back, waited for one batch later in finalize()
        return [
            dict(
                _emb=emb,
                _i=i,
                _off=b_pad + offsets[i],
                _n=len(item['coords']),
                bboxes=item['bboxes'].astype(np.float16),
            )
            for i, item in enumerate(prepared)
        ]

    def finalize(self, record: dict[str, Any]) -> dict[str, Any]:
        emb = record.pop('_emb').wait()
        i = record.pop('_i')
        off = record.pop('_off')
        n = record.pop('_n')
        rows = torch.cat([emb[i:i + 1], emb[off:off + n]])
        record['embeddings'] = rows.numpy().astype(np.float16)
        return record


def main(argv=None):
    return BlocksPipeline.main(argv)


if __name__ == '__main__':
    main()
