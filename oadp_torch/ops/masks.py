"""Polygon masks: mask-target rasterization + host-side eval utilities
(port of ``oadp_tpu/ops/masks.py``).

The reference gets instance masks from pycocotools RLE + mmcv BitmapMasks
(LVIS pipeline ``configs/dp/datasets/ov_lvis.py`` with ``with_mask``,
mask targets via ``mmdet.core.mask_target``). Neither C extension is
used here, so:

* gt masks travel as *padded polygon tensors* ``(G, P, V, 2)`` —
  each instance resampled to ``P`` parts x ``V`` vertices on the host
  (:func:`resample_polygons`, shape-preserving arc-length resampling);
* mask TARGETS are rasterized on the device in torch
  (:func:`rasterize_in_boxes`, ``oadp_tpu``'s ``jnp`` version ported):
  even-odd crossing test of the 28x28 RoI grid centers against the
  polygon edges, vectorized;
* EVAL-side utilities (:func:`polygon_raster_np`, :func:`mask_iou_pairs`,
  copied from ``oadp_tpu``) compute mask IoU per detection/gt pair on
  the intersection rectangle only (areas from each mask's own box), so
  full-image bitmaps are never allocated.

Deviation vs the reference's pycocotools RLE semantics: the per-pixel
even-odd raster differs from an 8×-supersampled oracle by **≤ 0.05
absolute IoU** on adversarial shapes (rings with holes, multi-part,
sub-pixel slivers, stars, .49/.51 sub-pixel vertices) — measured by
``tests/test_masks.py::test_mask_iou_adversarial_bound`` on
``oadp_tpu``'s copy of these functions; polygon areas converge within
half a perimeter-pixel (``test_polygon_raster_area_converges``).
"""

__all__ = [
    'resample_polygons',
    'rasterize_in_boxes',
    'polygon_raster_np',
    'paste_mask_np',
    'mask_iou_pairs',
]

import numpy as np
import torch


def resample_polygons(
    polygons: list[list[float]],
    n_parts: int,
    n_verts: int,
) -> np.ndarray:
    """COCO polygon lists → ``(n_parts, n_verts, 2)`` float32, padded.

    Each part is resampled to exactly ``n_verts`` vertices by arc-length
    interpolation along the closed contour (shape-preserving for both
    tiny and huge polygons). Empty slots carry a degenerate far-away
    point so they rasterize to nothing.
    """
    out = np.full((n_parts, n_verts, 2), -1e6, np.float32)
    parts = [np.asarray(p, np.float64).reshape(-1, 2) for p in polygons]
    parts = [p for p in parts if len(p) >= 3][:n_parts]
    for i, pts in enumerate(parts):
        closed = np.concatenate([pts, pts[:1]])
        seg = np.linalg.norm(np.diff(closed, axis=0), axis=1)
        t = np.concatenate([[0.0], np.cumsum(seg)])
        total = t[-1]
        if total <= 0:
            out[i] = pts[0]
            continue
        s = np.linspace(0.0, total, n_verts, endpoint=False)
        out[i, :, 0] = np.interp(s, t, closed[:, 0])
        out[i, :, 1] = np.interp(s, t, closed[:, 1])
    return out


def _crossings(px, py, poly):
    """Even-odd inside test. ``px, py``: ``(..., H, W)`` points; ``poly``:
    ``(..., V, 2)`` closed implicitly. Returns bool ``(..., H, W)``."""
    x1, y1 = poly[..., 0], poly[..., 1]
    x2, y2 = x1.roll(-1, -1), y1.roll(-1, -1)

    def edge(t):  # (..., V) -> (..., 1, 1, V), against the points' grid
        return t[..., None, None, :]

    py_, px_ = py[..., None], px[..., None]
    straddles = (edge(y1) > py_) != (edge(y2) > py_)
    denominator = torch.where(y2 == y1, 1.0, y2 - y1)
    x_at = edge(x2 - x1) * (py_ - edge(y1)) / edge(denominator) + edge(x1)
    crossing = straddles & (px_ < x_at)
    return crossing.sum(-1) % 2 == 1


def rasterize_in_boxes(
    polygons: torch.Tensor,  # (G, P, V, 2) padded instance polygons
    gt_idx: torch.Tensor,  # (R,) int gt of each roi
    boxes: torch.Tensor,  # (R, 4) target boxes (rois)
    out_size: int = 28,
) -> torch.Tensor:
    """``(R, out, out)`` float32 mask targets: 1 where the RoI grid
    center lies inside any polygon part of the matched instance
    (union over parts). ``oadp_tpu``'s ``vmap`` over RoIs and parts is
    a broadcast over both here, with the same float32 arithmetic."""
    sel = polygons[gt_idx.long()]  # (R, P, V, 2)
    x0, y0, x1, y1 = boxes.unbind(-1)
    t = (torch.arange(out_size, dtype=torch.float32, device=boxes.device)
         + 0.5) / out_size
    xs = x0[:, None] + t * (x1 - x0)[:, None]  # (R, out)
    ys = y0[:, None] + t * (y1 - y0)[:, None]
    px = xs[:, None, None, :].expand(-1, 1, out_size, -1)  # (R, 1, out, out)
    py = ys[:, None, :, None].expand(-1, 1, -1, out_size)
    inside = _crossings(px, py, sel)  # (R, P, out, out)
    return inside.any(1).float()


# ---------------------------------------------------------------------------
# Host-side (numpy) eval utilities
# ---------------------------------------------------------------------------


def polygon_raster_np(
    polygons: list[list[float]],
    x0: float, y0: float, w: int, h: int,
) -> np.ndarray:
    """Rasterize COCO polygons on an ``(h, w)`` grid whose pixel centers
    start at ``(x0 + .5, y0 + .5)`` (even-odd union over parts)."""
    out = np.zeros((h, w), bool)
    if w <= 0 or h <= 0:
        return out
    px = x0 + 0.5 + np.arange(w)
    py = y0 + 0.5 + np.arange(h)
    for part in polygons:
        pts = np.asarray(part, np.float64).reshape(-1, 2)
        if len(pts) < 3:
            continue
        vx1, vy1 = pts[:, 0], pts[:, 1]
        vx2 = np.roll(vx1, -1)
        vy2 = np.roll(vy1, -1)
        straddle = (vy1[None, :] > py[:, None]) != (
            vy2[None, :] > py[:, None]
        )  # (h, V)
        denominator = np.where(vy2 == vy1, 1.0, vy2 - vy1)
        x_at = (
            (vx2 - vx1)[None, :]
            * (py[:, None] - vy1[None, :]) / denominator[None, :]
            + vx1[None, :]
        )  # (h, V)
        # count, per pixel, straddling edges whose crossing is right of px
        cross = straddle[:, None, :] & (
            px[None, :, None] < x_at[:, None, :]
        )
        out |= (cross.sum(-1) % 2).astype(bool)
    return out


def paste_mask_np(
    mask: np.ndarray,  # (m, m) float in [0, 1]
    box: np.ndarray,  # (4,) xyxy
    x0: int, y0: int, w: int, h: int,
    thr: float = 0.5,
) -> np.ndarray:
    """Bilinear-sample a fixed-size mask onto an ``(h, w)`` pixel grid
    at offset ``(x0, y0)`` (mmdet paste semantics), binarized at
    ``thr``."""
    out = np.zeros((h, w), bool)
    if w <= 0 or h <= 0:
        return out
    bx0, by0, bx1, by1 = [float(v) for v in box]
    bw = max(bx1 - bx0, 1e-6)
    bh = max(by1 - by0, 1e-6)
    m = mask.shape[0]
    # pixel centers in mask coordinates (align_corners=False)
    gx = (x0 + 0.5 + np.arange(w) - bx0) / bw * m - 0.5
    gy = (y0 + 0.5 + np.arange(h) - by0) / bh * m - 0.5
    fx = np.clip(gx, 0, m - 1)
    fy = np.clip(gy, 0, m - 1)
    x_lo = np.floor(fx).astype(int)
    y_lo = np.floor(fy).astype(int)
    x_hi = np.minimum(x_lo + 1, m - 1)
    y_hi = np.minimum(y_lo + 1, m - 1)
    wx = fx - x_lo
    wy = fy - y_lo
    v = (
        mask[np.ix_(y_lo, x_lo)] * (1 - wy)[:, None] * (1 - wx)[None, :]
        + mask[np.ix_(y_lo, x_hi)] * (1 - wy)[:, None] * wx[None, :]
        + mask[np.ix_(y_hi, x_lo)] * wy[:, None] * (1 - wx)[None, :]
        + mask[np.ix_(y_hi, x_hi)] * wy[:, None] * wx[None, :]
    )
    inside = (
        (gx >= -0.5)[None, :] & (gx <= m - 0.5)[None, :]
        & (gy >= -0.5)[:, None] & (gy <= m - 0.5)[:, None]
    )
    # outside the box the mask is zero
    bbox_in = (
        (x0 + 0.5 + np.arange(w) >= bx0)[None, :]
        & (x0 + 0.5 + np.arange(w) <= bx1)[None, :]
        & (y0 + 0.5 + np.arange(h) >= by0)[:, None]
        & (y0 + 0.5 + np.arange(h) <= by1)[:, None]
    )
    out = (v > thr) & bbox_in
    return out


def mask_iou_pairs(
    dt_masks: list[tuple[np.ndarray, np.ndarray]],  # [(mask28, box), ...]
    gt_polys: list[list[list[float]]],
    gt_boxes: np.ndarray,  # (G, 4) xyxy
    iscrowd: np.ndarray,
    thr: float = 0.5,
) -> np.ndarray:
    """``(D, G)`` mask IoU, computed per pair on the boxes' intersection
    rectangle (areas come from each mask within its own box)."""
    d, g = len(dt_masks), len(gt_polys)
    ious = np.zeros((d, g))
    if d == 0 or g == 0:
        return ious

    dt_areas, dt_rasters, dt_rects = [], [], []
    for mask, box in dt_masks:
        x0, y0 = int(np.floor(box[0])), int(np.floor(box[1]))
        w = int(np.ceil(box[2])) - x0 + 1
        h = int(np.ceil(box[3])) - y0 + 1
        r = paste_mask_np(mask, box, x0, y0, max(w, 0), max(h, 0), thr)
        dt_rasters.append(r)
        dt_rects.append((x0, y0))
        dt_areas.append(int(r.sum()))

    gt_areas, gt_rasters, gt_rects = [], [], []
    for polys, box in zip(gt_polys, gt_boxes):
        x0, y0 = int(np.floor(box[0])), int(np.floor(box[1]))
        w = int(np.ceil(box[2])) - x0 + 1
        h = int(np.ceil(box[3])) - y0 + 1
        r = polygon_raster_np(polys, x0, y0, max(w, 0), max(h, 0))
        gt_rasters.append(r)
        gt_rects.append((x0, y0))
        gt_areas.append(int(r.sum()))

    for di in range(d):
        dx, dy = dt_rects[di]
        dr = dt_rasters[di]
        for gi in range(g):
            gx, gy = gt_rects[gi]
            gr = gt_rasters[gi]
            ix0 = max(dx, gx)
            iy0 = max(dy, gy)
            ix1 = min(dx + dr.shape[1], gx + gr.shape[1])
            iy1 = min(dy + dr.shape[0], gy + gr.shape[0])
            if ix1 <= ix0 or iy1 <= iy0:
                continue
            a = dr[iy0 - dy:iy1 - dy, ix0 - dx:ix1 - dx]
            b = gr[iy0 - gy:iy1 - gy, ix0 - gx:ix1 - gx]
            inter = int((a & b).sum())
            if iscrowd[gi]:
                union = dt_areas[di]
            else:
                union = dt_areas[di] + gt_areas[gi] - inter
            if union > 0:
                ious[di, gi] = inter / union
    return ious
