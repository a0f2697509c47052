"""RoIAlign over an FPN pyramid as one gather (port of
``oadp_tpu/ops/roi_align.py``).

mmcv's ``RoIAlign`` (``aligned=True``) under mmdet's
``SingleRoIExtractor``: each RoI reads the level that its scale maps to,
at ``sampling_ratio`` x ``sampling_ratio`` bilinear samples per output
bin, averaged. As in ``oadp_tpu``, the sampling ratio is fixed (2, not
mmcv's adaptive 0), P6 takes no RoI, and mmcv's border rule holds
(samples beyond one pixel outside the map read 0; others clamp).

The levels of all images are flattened into one ``(sum B*H*W, C)`` table,
so every RoI is one gather of its ``out x out x s x s`` samples' four
corners, then one weighted sum per bin as a batched matrix product in the
activation dtype. The gathered tensor is ``R * out^2 * s^2 * 4 * C``
values (0.8 GB in fp32 for 1000 RoIs at 7 x 7 and C = 256).
"""

__all__ = ['assign_fpn_levels', 'roi_align_fpn']

import torch


def assign_fpn_levels(
    rois: torch.Tensor,  # (..., 4)
    num_levels: int,
    finest_scale: float = 56.0,
) -> torch.Tensor:
    """mmdet ``SingleRoIExtractor.map_roi_levels``:
    ``lvl = floor(log2(sqrt(area) / finest_scale + 1e-6))`` clamped."""
    w = rois[..., 2] - rois[..., 0]
    h = rois[..., 3] - rois[..., 1]
    scale = torch.sqrt((w * h).clamp(min=0))
    lvl = torch.floor(torch.log2(scale / finest_scale + 1e-6))
    return lvl.clamp(0, num_levels - 1).to(torch.int64)


def roi_align_fpn(
    feats: list[torch.Tensor],  # per level (B, C, H_l, W_l)
    rois: torch.Tensor,  # (B, R, 4) in image coordinates
    out_size: int = 7,
    sampling_ratio: int = 2,
    strides: tuple = (4, 8, 16, 32),
    finest_scale: float = 56.0,
) -> torch.Tensor:
    """RoIAlign of each image's RoIs on its pyramid -> ``(B, R, C, out,
    out)`` in the features' dtype. Only the first ``len(strides)`` levels
    take part."""
    feats = feats[:len(strides)]
    b, r = rois.shape[:2]
    c = feats[0].shape[1]
    dev = rois.device
    sizes = [(f.shape[2], f.shape[3]) for f in feats]
    # (sum over levels of B*H*W, C): level-major, then image, then y, x
    flat = torch.cat([f.permute(0, 2, 3, 1).reshape(-1, c) for f in feats])
    counts = [b * h * w for h, w in sizes]
    offsets = torch.tensor([0] + counts[:-1], device=dev).cumsum(0)
    heights = torch.tensor([h for h, _ in sizes], dtype=torch.float32, device=dev)
    widths = torch.tensor([w for _, w in sizes], dtype=torch.float32, device=dev)
    strides_f = torch.tensor(strides, dtype=torch.float32, device=dev)

    rois = rois.reshape(b * r, 4).float()
    levels = assign_fpn_levels(rois, len(strides), finest_scale)
    image = torch.arange(b, device=dev).repeat_interleave(r)
    fh, fw = heights[levels], widths[levels]
    base = offsets[levels] + image * (fh * fw).long()
    scale = 1.0 / strides_f[levels]
    x0 = rois[:, 0] * scale - 0.5
    y0 = rois[:, 1] * scale - 0.5
    x1 = rois[:, 2] * scale - 0.5
    y1 = rois[:, 3] * scale - 0.5
    bin_w = (x1 - x0) / out_size
    bin_h = (y1 - y0) / out_size
    s = sampling_ratio
    grid = (torch.arange(out_size, dtype=torch.float32, device=dev)[:, None]
            + (torch.arange(s, dtype=torch.float32, device=dev)[None, :] + 0.5) / s)
    px = x0[:, None, None] + bin_w[:, None, None] * grid  # (n, out, s)
    py = y0[:, None, None] + bin_h[:, None, None] * grid

    def bilinear(p, size):
        """Corner indices and weights with mmcv's border handling."""
        inside = (p >= -1.0) & (p <= size)
        p = p.clamp(min=0)
        lo = torch.minimum(torch.floor(p), size - 1)
        hi = torch.minimum(lo + 1, size - 1)
        frac = (p - lo).clamp(0.0, 1.0)
        return lo.long(), hi.long(), frac, inside

    xl, xh, fx, okx = bilinear(px, fw[:, None, None])
    yl, yh, fy, oky = bilinear(py, fh[:, None, None])
    iw = fw.long()[:, None, None, None, None]
    base_b = base[:, None, None, None, None]

    # (n, out_y, out_x, s_y, s_x) flat indices, bins first so that each
    # bin's s*s*4 taps are contiguous for the product below
    def flat_index(yy, xx):
        return base_b + yy[:, :, None, :, None] * iw + xx[:, None, :, None, :]

    idx = torch.stack([flat_index(yl, xl), flat_index(yl, xh),
                       flat_index(yh, xl), flat_index(yh, xh)], -1)
    wy = torch.stack([1 - fy, 1 - fy, fy, fy], -1)  # (n, out, s, 4)
    wx = torch.stack([1 - fx, fx, 1 - fx, fx], -1)
    ok = oky[:, :, None, :, None] & okx[:, None, :, None, :]
    w = (wy[:, :, None, :, None, :] * wx[:, None, :, None, :, :] * ok[..., None]
         * (1.0 / (s * s))).to(flat.dtype)  # (n, out, out, s, s, 4)
    taps = s * s * 4
    z = flat[idx.reshape(-1)].reshape(b * r * out_size * out_size, taps, c)
    out = torch.bmm(w.reshape(-1, 1, taps), z)  # (n*out*out, 1, C)
    return out.reshape(b, r, out_size, out_size, c).permute(0, 1, 4, 2, 3)
