"""Anchor generation (mmdet ``AnchorGenerator`` semantics): a copy of
``oadp_tpu/ops/anchors.py``.

Configured at reference ``configs/dp/models/faster_rcnn_r50_fpn.py:
27-32``: scales=[8], ratios=[0.5, 1, 2], strides=[4, 8, 16, 32, 64].
Anchors are static for a fixed canvas, so they are precomputed once on
the host (numpy) and moved to the device once per canvas
(``dp/builder.py:canvas_anchors``).
"""

__all__ = ['AnchorGenerator']

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class AnchorGenerator:
    strides: tuple = (4, 8, 16, 32, 64)
    ratios: tuple = (0.5, 1.0, 2.0)
    scales: tuple = (8,)
    center_offset: float = 0.0

    @property
    def num_base_anchors(self) -> int:
        return len(self.ratios) * len(self.scales)

    def base_anchors(self, stride: int) -> np.ndarray:
        """(A, 4) anchors around (0, 0) for one level (mmdet
        ``gen_single_level_base_anchors``)."""
        w = h = float(stride)
        ratios = np.asarray(self.ratios, np.float32)
        scales = np.asarray(self.scales, np.float32)
        h_ratios = np.sqrt(ratios)
        w_ratios = 1.0 / h_ratios
        ws = (w * w_ratios[:, None] * scales[None, :]).reshape(-1)
        hs = (h * h_ratios[:, None] * scales[None, :]).reshape(-1)
        xc = self.center_offset * w
        yc = self.center_offset * h
        return np.stack(
            [xc - 0.5 * ws, yc - 0.5 * hs, xc + 0.5 * ws, yc + 0.5 * hs],
            axis=-1,
        ).astype(np.float32)

    def grid_anchors(
        self, featmap_sizes: list[tuple[int, int]]
    ) -> list[np.ndarray]:
        """Per-level ``(H*W*A, 4)`` anchors, row-major over (y, x, a) —
        matching mmdet's flattening order for the head outputs."""
        out = []
        for (fh, fw), stride in zip(featmap_sizes, self.strides):
            base = self.base_anchors(stride)  # (A, 4)
            xs = np.arange(fw, dtype=np.float32) * stride
            ys = np.arange(fh, dtype=np.float32) * stride
            shifts = np.stack(
                [
                    np.tile(xs, fh),
                    np.repeat(ys, fw),
                    np.tile(xs, fh),
                    np.repeat(ys, fw),
                ],
                axis=-1,
            )  # (H*W, 4)
            anchors = (shifts[:, None, :] + base[None, :, :]).reshape(-1, 4)
            out.append(anchors)
        return out
