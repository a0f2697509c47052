"""OAKE globals: whole-image CLIP embeddings (reference
``oadp/oake/globals.py``; port of ``oadp_tpu/oake/globals.py``). Output
per image: a ``(512,)`` fp16 tensor in ``{output_dir}/{id:012d}.pth``.

Images are batched across the dataset (``batch_size`` per encoder call)
— unlike the reference's one-image-per-iter loop (globals.py:49-60).
"""

__all__ = ['GlobalsPipeline', 'main']

from typing import Any

import numpy as np

from ..ops import preprocess as P
from .base import BaseOakePipeline, bucket


class GlobalsPipeline(BaseOakePipeline):

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.device_batch = int(self.config.get('batch_size', 16))

    def prepare(self, item: dict[str, Any]) -> dict[str, Any]:
        w, h = item['width'], item['height']
        meta = P.clip_transform_meta(w, h, np.asarray(
            [[0.0, 0.0, w, h]]
        ))[0]
        scale = max(meta[2] / meta[4], meta[3] / meta[5], 1.0)
        return dict(
            output=item['output'],
            image=self._pad_image(item['image']),
            meta=meta,
            ksize=2 * int(np.ceil(2.0 * scale)) + 1,
        )

    def execute_batch(self, prepared: list[dict[str, Any]]) -> list[Any]:
        n = len(prepared)
        b = bucket(n, (self.device_batch,))
        # identity-crop meta for padding rows
        meta = np.tile(
            np.asarray([0, 0, 224, 224, 224, 224, 0, 0, 1], np.float32),
            (b, 1),
        )
        imgs = [item['image'] for item in prepared]
        imgs += [imgs[-1]] * (b - n)  # pad rows: duplicate, ignored
        for i, item in enumerate(prepared):
            meta[i] = item['meta']
        k = bucket(
            max(item['ksize'] for item in prepared), (5, 9, 13, 21)
        )
        emb = self.steps.globals_step(imgs, meta, k)
        return [(emb, i) for i in range(n)]

    def finalize(self, record) -> np.ndarray:
        emb, i = record
        return emb[i].cpu().numpy().astype(np.float16)


def main(argv=None):
    return GlobalsPipeline.main(argv)


if __name__ == '__main__':
    main()
