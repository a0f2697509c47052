"""Block-grid pyramid planning for the OAKE blocks pipeline (a copy of
``oadp_tpu/oake/partitions.py``, which uses no framework).

Host-side, deterministic in the image size: reproduces the reference's
partition math (``oadp/oake/blocks.py:40-77``) but emits a *plan* that one
device step executes (pyramid resizes as weight-matrix pairs + block
window coordinates), instead of a host crop loop.
"""

__all__ = ['BlockPlan', 'plan_blocks', 'first_block_bbox']

import dataclasses


def _partition(length: int, block: int, max_stride: int) -> list[int]:
    """Start offsets covering ``length`` with ``block``-sized windows and
    stride ≤ ``max_stride``, evenly balanced (reference blocks.py:40-52)."""
    if length < block:
        return []
    result = [0]
    if length == block:
        return result
    n = (length - block - 1) // max_stride + 1
    q, r = divmod(length - block, n)
    for i in range(n):
        result.append(result[-1] + q + (i < r))
    return result


@dataclasses.dataclass
class BlockPlan:
    """``levels[k]`` is the size of pyramid level ``k`` (level 0 = the
    original image); ``blocks`` are ``(level, x, y)`` slice positions;
    ``bboxes`` are the matching boxes in original-image coordinates."""
    levels: list[tuple[int, int]]
    blocks: list[tuple[int, int, int]]
    bboxes: list[tuple[float, float, float, float]]


def first_block_bbox(w: int, h: int) -> tuple[float, float, float, float]:
    """Bbox recorded for the whole-image block (reference blocks.py:96-101).

    Note: reproduced verbatim from the reference, including its quirk of
    writing ``(left, top, h, h)`` rather than ``(left, top, left + h, h)``
    — DP consumers were trained against this layout.
    """
    if w > h:
        return ((w - h) / 2, 0, h, h)
    return (0, (h - w) / 2, w, w)


def plan_blocks(
    w: int,
    h: int,
    block_size: int = 224,
    max_stride: int = 112,
    rescale: float = 1.5,
) -> BlockPlan:
    levels = [(w, h)]
    blocks: list[tuple[int, int, int]] = []
    bboxes: list[tuple[float, float, float, float]] = []
    scale = 1.0
    level = 0
    while True:
        lw, lh = levels[-1]
        xs = _partition(lw, block_size, max_stride)
        ys = _partition(lh, block_size, max_stride)
        if not xs or not ys:
            if len(levels) > 1:
                levels.pop()  # the level that yielded nothing is unused
            break
        for x in xs:
            for y in ys:
                blocks.append((level, x, y))
                x1, y1 = x * scale, y * scale
                r = block_size * scale
                bboxes.append((x1, y1, x1 + r, y1 + r))
        levels.append((int(lw / rescale), int(lh / rescale)))
        scale *= rescale
        level += 1
    return BlockPlan(levels, blocks, bboxes)
