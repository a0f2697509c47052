"""Bounding-box algebra (host-side numpy; a copy of ``oadp_tpu/ops/boxes.py``).

Replaces the reference's ``todd.BBoxes*`` usage: XYXY/CXCYWH conversion,
area/center accessors, the OAKE square-expansion modes
(``oadp/oake/objects.py:32-36,76-114``), the ViT-grid background mask
(``oadp/oake/objects.py:129-155``), pairwise intersection (used for
block labels, ``oadp/dp/datasets.py:192-201``) and IoU (used by the DP
assigners).
"""

__all__ = [
    'area',
    'center',
    'wh',
    'filter_min_wh',
    'expand_boxes',
    'grid_mask',
    'pairwise_intersection',
    'pairwise_iou',
]

import numpy as np


def wh(boxes: np.ndarray) -> np.ndarray:
    return boxes[..., 2:4] - boxes[..., 0:2]


def area(boxes: np.ndarray) -> np.ndarray:
    s = wh(boxes)
    return s[..., 0] * s[..., 1]


def center(boxes: np.ndarray) -> np.ndarray:
    return (boxes[..., 0:2] + boxes[..., 2:4]) / 2


def filter_min_wh(boxes: np.ndarray, min_w: float, min_h: float) -> np.ndarray:
    """Indices mask of boxes with width > min_w and height > min_h
    (reference ``todd.BBoxes.indices(min_wh=...)`` at
    ``oadp/oake/objects.py:165``, strict inequality)."""
    s = wh(boxes)
    return (s[..., 0] > min_w) & (s[..., 1] > min_h)


def expand_boxes(
    boxes: np.ndarray,
    image_w: float,
    image_h: float,
    mode: str = 'ADAPTIVE',
    scale_ratio: float = 8.0,
    constant: float = 224.0,
) -> np.ndarray:
    """Square-expand proposals (reference ``oadp/oake/objects.py:76-114``).

    ADAPTIVE: side = sqrt(area * scale_ratio), centered on the proposal,
    then translated to lie inside the image where possible (kept centered
    when larger than the image).

    RECTANGLE: no expansion — the proposal's own width/height are kept
    per-axis (then the same in-image translation applies). The reference
    declares this mode (``objects.py:32-36``) but its ``_expand`` falls
    through to a no-op ``assert ValueError(...)`` and crashes with an
    unbound ``length``; the natural semantics are implemented here so the
    CLI surface (``--override`` of ``expand_mode``) is usable.
    """
    boxes = np.asarray(boxes, np.float32)
    c = center(boxes)
    if mode == 'ADAPTIVE':
        length = np.sqrt(area(boxes) * scale_ratio)[:, None]
    elif mode == 'CONSTANT':
        length = np.full((len(boxes), 1), constant, np.float32)
    elif mode == 'LONGEST_EDGE':
        length = wh(boxes).max(-1, keepdims=True)
    elif mode == 'RECTANGLE':
        length = wh(boxes)  # (N, 2): per-axis, no squaring
    else:
        raise ValueError(mode)

    lt = c - length / 2
    rb = c + length / 2
    image_wh = np.asarray([image_w, image_h], np.float32)

    offset = np.zeros_like(lt)
    offset = np.where(lt >= 0, offset, -lt)
    offset = np.where(rb <= image_wh, offset, image_wh - rb)
    sz = rb - lt
    offset = np.where(sz <= image_wh, offset, 0.0)
    return np.concatenate([lt + offset, rb + offset], axis=-1)


def grid_mask(
    foregrounds: np.ndarray,
    crops: np.ndarray,
    grid: int,
) -> np.ndarray:
    """Background masks on the ViT patch grid, replicating the reference's
    crop-resolution mask + nearest downsample (``objects.py:129-155``):

    the mask is built at the crop's pixel resolution
    (``ceil(x1-x0) × ceil(y1-y0)``, float arange semantics), foreground
    where ``fg0 <= p <= fg1`` inclusive, then nearest-resampled to
    ``grid × grid`` with source index ``floor(i * size / grid)``.

    Args:
        foregrounds: ``(N, 4)`` proposal boxes in crop coordinates.
        crops: ``(N, 4)`` expanded crop boxes in image coordinates.

    Returns:
        ``(N, grid, grid)`` float32; 1 = background, 0 = object.
    """
    foregrounds = np.asarray(foregrounds, np.float64)
    crops = np.asarray(crops, np.float64)
    idx = np.arange(grid)
    # vectorized over proposals (1024/image on the OAKE hot path)
    cw = _ceil_arange_len_vec(crops[:, 2] - crops[:, 0])  # (N,)
    ch = _ceil_arange_len_vec(crops[:, 3] - crops[:, 1])
    # torch nearest interpolate: src = floor(dst * in / out)
    xs = np.floor(idx[None, :] * cw[:, None] / grid)  # (N, grid)
    ys = np.floor(idx[None, :] * ch[:, None] / grid)
    fx = (foregrounds[:, 0:1] <= xs) & (xs <= foregrounds[:, 2:3])
    fy = (foregrounds[:, 1:2] <= ys) & (ys <= foregrounds[:, 3:4])
    return (~(fy[:, :, None] & fx[:, None, :])).astype(np.float32)


def _ceil_arange_len_vec(length: np.ndarray) -> np.ndarray:
    """Vectorized :func:`math_ceil_arange_len`."""
    return np.where(length > 0, np.ceil(length - 1e-9), 0.0)


def math_ceil_arange_len(length: float) -> int:
    """Length of ``torch.arange(length)`` for float ``length``
    (= ceil(length), with exact integers giving ``length``)."""
    return int(np.ceil(length - 1e-9)) if length > 0 else 0


def pairwise_intersection(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``(N, M)`` intersection areas (reference block-label overlap test,
    ``oadp/dp/datasets.py:192-195`` — ``BBoxes & BBoxes > 0``)."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:4], b[None, :, 2:4])
    s = np.clip(rb - lt, 0, None)
    return s[..., 0] * s[..., 1]


def pairwise_iou(a: np.ndarray, b: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    inter = pairwise_intersection(a, b)
    union = area(a)[:, None] + area(b)[None, :] - inter
    return inter / np.maximum(union, eps)
