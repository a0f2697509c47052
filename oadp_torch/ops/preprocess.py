"""CLIP preprocessing as device matmuls, bit-faithful to PIL.

The reference preprocesses on the host with PIL + torchvision
(``clip`` fork's transform; crops at ``oadp/oake/objects.py:116-127``,
pyramid at ``oadp/oake/blocks.py:54-77``) — a per-proposal Python hot
loop (SURVEY.md §3.1). Here the host only computes tiny per-crop
*resample weight matrices*; the pixel work (crop → bicubic resize →
center-crop → normalize) runs on the device as two matmuls per crop.
The host numpy part is a copy of ``oadp_tpu/ops/preprocess.py``; the
device part is its torch port (XLA code there, plain torch ops here).

Faithfulness: PIL resizes 8-bit images in two passes (horizontal then
vertical), quantizes weights to 22-bit fixed point, and rounds each pass
back to uint8 (``clip8`` in Pillow's Resample.c). We replicate:

* bicubic kernel with a = -0.5, support 2, antialias scaling;
* window clipping to the *crop* bounds with renormalization, while taps
  outside the *image* contribute zeros (PIL crop zero-pads);
* weight quantization to ``round(w * 2**22) / 2**22``;
* per-pass ``clip(floor(x + 0.5), 0, 255)`` rounding;
* PIL ``crop`` box rounding (Python banker's rounding per coordinate);
* torchvision ``Resize(shorter=n)`` (``int()`` truncation for the long
  side) and ``CenterCrop`` offsets (banker's rounding).

All weight matrices are padded to a static image size, so every crop
of a batch shares one matmul shape.
"""

__all__ = [
    'CLIP_MEAN',
    'CLIP_STD',
    'PRECISION_BITS',
    'resample_coeffs',
    'resize_matrix',
    'clip_transform_matrices',
    'clip_transform_coeffs',
    'clip_transform_meta',
    'device_coeffs',
    'coeff_ksize',
    'apply_resize_pair',
    'matmul_f32',
    'expand_coeffs',
    'apply_resize_coeffs',
    'normalize_clip',
    'round_u8',
]

import math

import numpy as np
import torch

# CLIP preprocessing constants (OpenAI CLIP `_transform`); the port keeps
# its own copy of ``oadp_tpu/models/clip.py:CLIP_MEAN/CLIP_STD``.
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

PRECISION_BITS = 22  # Pillow: 32 - 8 - 2


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic filter (a = -0.5, support 2)."""
    a = -0.5
    ax = np.abs(x)
    out = np.where(
        ax < 1,
        ((a + 2) * ax - (a + 3)) * ax * ax + 1,
        np.where(
            ax < 2,
            (((ax - 5) * ax + 8) * ax - 4) * a,
            0.0,
        ),
    )
    return out


def resample_coeffs(
    in_size: float,
    in0: float,
    in1: float,
    out_size: int,
    quantize: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-output-pixel resample windows, exactly as Pillow computes them.

    Mirrors ``precompute_coeffs`` in Pillow's Resample.c for the bicubic
    filter. Returns ``(xmin, weights)`` where ``xmin`` is ``(out,)`` int
    window starts (in crop coordinates) and ``weights`` is
    ``(out, max_taps)`` with zero padding.
    """
    support0 = 2.0
    scale = (in1 - in0) / out_size
    filterscale = max(scale, 1.0)
    support = support0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1

    xx = np.arange(out_size)
    center = in0 + (xx + 0.5) * scale
    xmin = np.clip((center - support + 0.5).astype(np.int64), 0, None)
    xmax = np.minimum(
        (center + support + 0.5).astype(np.int64), int(in_size)
    ) - xmin

    taps = np.arange(ksize)
    # (out, ksize) tap positions relative to window start
    pos = (taps[None] + xmin[:, None] - center[:, None] + 0.5) / filterscale
    w = _bicubic(pos)
    w[taps[None] >= xmax[:, None]] = 0.0
    ww = w.sum(-1, keepdims=True)
    ww[ww == 0] = 1.0
    w = w / ww
    if quantize:
        half = 0.5 * np.sign(w)
        w = np.trunc(w * (1 << PRECISION_BITS) + half) / (1 << PRECISION_BITS)
    return xmin, w


def resize_matrix(
    image_size: int,
    crop0: float,
    crop1: float,
    out_size: int,
    pad_size: int,
    quantize: bool = True,
) -> np.ndarray:
    """Dense ``(out_size, pad_size)`` resample matrix in *image* pixel space.

    ``crop0:crop1`` is the (already-rounded, possibly out-of-bounds) crop
    window along this axis; taps outside the image are dropped, which is
    exactly PIL's zero-fill crop followed by resize.
    """
    in_size = crop1 - crop0
    xmin, w = resample_coeffs(in_size, 0.0, float(in_size), out_size, quantize)
    out = np.zeros((out_size, pad_size), np.float32)
    n_taps = w.shape[1]
    rows = np.repeat(np.arange(out_size), n_taps)
    cols = (xmin[:, None] + np.arange(n_taps)[None]).ravel() + int(crop0)
    vals = w.ravel()
    ok = (cols >= 0) & (cols < image_size) & (vals != 0)
    out[rows[ok], cols[ok]] = vals[ok].astype(np.float32)
    return out


def _round_half_even(x: float) -> int:
    return int(round(x))


def clip_transform_matrices(
    image_w: int,
    image_h: int,
    crop_box: tuple[float, float, float, float] | None,
    pad_w: int,
    pad_h: int,
    out: int = 224,
) -> tuple[np.ndarray, np.ndarray]:
    """Weights for CLIP preprocess: crop → Resize(shorter=out) → CenterCrop.

    Returns ``(Wx, Wy)`` of shapes ``(out, pad_w)`` / ``(out, pad_h)``.
    """
    if crop_box is None:
        x0, y0, x1, y1 = 0, 0, image_w, image_h
    else:
        x0, y0, x1, y1 = (_round_half_even(v) for v in crop_box)
    cw, ch = x1 - x0, y1 - y0
    if cw <= 0 or ch <= 0:
        raise ValueError(f'empty crop {crop_box}')

    # torchvision Resize(shorter_side=out)
    if cw <= ch:
        ow, oh = out, int(out * ch / cw)
    else:
        ow, oh = int(out * cw / ch), out
    # PIL skips resampling entirely when the size is unchanged
    identity = (ow, oh) == (cw, ch)

    # torchvision CenterCrop(out)
    left = _round_half_even((ow - out) / 2.0)
    top = _round_half_even((oh - out) / 2.0)

    if identity:
        wx = np.zeros((out, pad_w), np.float32)
        cols = np.arange(out) + x0 + left
        ok = (cols >= 0) & (cols < image_w)
        wx[np.arange(out)[ok], cols[ok]] = 1.0
        wy = np.zeros((out, pad_h), np.float32)
        rows_idx = np.arange(out) + y0 + top
        ok = (rows_idx >= 0) & (rows_idx < image_h)
        wy[np.arange(out)[ok], rows_idx[ok]] = 1.0
        return wx, wy

    wx = resize_matrix(image_w, x0, x1, ow, pad_w)[left:left + out]
    wy = resize_matrix(image_h, y0, y1, oh, pad_h)[top:top + out]
    return wx, wy


def coeff_ksize(max_crop_side: float, out: int = 224) -> int:
    """Max taps per output pixel for crops up to ``max_crop_side``
    (bicubic support 2, antialias): ``2 * ceil(2 * scale) + 1``."""
    scale = max(max_crop_side / out, 1.0)
    return 2 * int(math.ceil(2.0 * scale)) + 1


def clip_transform_coeffs(
    image_w: int,
    image_h: int,
    crop_box: tuple[float, float, float, float] | None,
    k_pad: int | None = None,
    out: int = 224,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Compact form of :func:`clip_transform_matrices`.

    Returns ``(wx_w, wx_start, wy_w, wy_start)`` where ``w*_w`` is
    ``(out, k_pad)`` float32 tap weights and ``w*_start`` is ``(out,)``
    int32 *absolute* image-column/row indices of the first tap (may be
    negative or exceed the image — the device expansion drops negative
    columns and out-of-image columns read zero-padded pixels, which is
    exactly PIL's zero-fill crop). The dense matrices are recovered by
    :func:`expand_coeffs`; the expansion is bit-exact, so device results
    match the dense path. Host→device traffic per 512-crop batch drops
    from ~590 MB of dense matrices to a few MB.
    """
    if crop_box is None:
        x0, y0, x1, y1 = 0, 0, image_w, image_h
    else:
        x0, y0, x1, y1 = (_round_half_even(v) for v in crop_box)
    cw, ch = x1 - x0, y1 - y0
    if cw <= 0 or ch <= 0:
        raise ValueError(f'empty crop {crop_box}')

    if cw <= ch:
        ow, oh = out, int(out * ch / cw)
    else:
        ow, oh = int(out * cw / ch), out
    identity = (ow, oh) == (cw, ch)
    left = _round_half_even((ow - out) / 2.0)
    top = _round_half_even((oh - out) / 2.0)

    def axis(crop0, crop1, n_out, offset):
        size = crop1 - crop0
        if identity:
            # PIL skips resampling: one tap of weight 1 per output.
            # Out-of-image-right taps read padded zeros and negative
            # starts never match a column on device — both are PIL's
            # zero-fill crop semantics.
            starts = np.arange(out, dtype=np.int64) + crop0 + offset
            w = np.ones((out, 1), np.float32)
        else:
            xmin, w = resample_coeffs(size, 0.0, float(size), n_out)
            xmin = xmin[offset:offset + out]
            w = w[offset:offset + out].astype(np.float32)
            starts = xmin + crop0
        if k_pad is not None:
            assert w.shape[1] <= k_pad, (w.shape, k_pad)
            w_pad = np.zeros((out, k_pad), np.float32)
            w_pad[:, :w.shape[1]] = w
            w = w_pad
        return w, starts.astype(np.int32)

    wx_w, wx_start = axis(x0, x1, ow, left)
    wy_w, wy_start = axis(y0, y1, oh, top)
    return wx_w, wx_start, wy_w, wy_start


def clip_transform_meta(
    image_w: int,
    image_h: int,
    boxes: np.ndarray,  # (B, 4) crop boxes (float)
    out: int = 224,
) -> np.ndarray:
    """Per-crop scalar metadata for on-device coefficient construction.

    The only non-device-friendly parts of the CLIP preprocess are a
    handful of Python-float roundings (banker's rounding of the crop
    box, torchvision's ``int()`` size truncation, center-crop offsets).
    They are computed here, vectorized, in float64 — everything heavy
    (tap weights, dense expansion, resampling) happens on device from
    these 9 numbers per crop.

    Returns ``(B, 9)`` float32: ``x0, y0, cw, ch, ow, oh, left, top,
    identity``.
    """
    boxes = np.asarray(boxes, np.float64)
    rounded = np.vectorize(_round_half_even)(boxes).astype(np.float64)
    x0, y0, x1, y1 = rounded.T
    cw, ch = x1 - x0, y1 - y0
    landscape = cw > ch
    ow = np.where(landscape, np.floor(out * cw / ch), float(out))
    oh = np.where(landscape, float(out), np.floor(out * ch / cw))
    identity = (ow == cw) & (oh == ch)
    left = np.vectorize(_round_half_even)((ow - out) / 2.0)
    top = np.vectorize(_round_half_even)((oh - out) / 2.0)
    return np.stack(
        [x0, y0, cw, ch, ow, oh, left, top, identity.astype(np.float64)],
        axis=-1,
    ).astype(np.float32)


def _bicubic_t(x: torch.Tensor) -> torch.Tensor:
    a = -0.5
    ax = x.abs()
    return torch.where(
        ax < 1,
        ((a + 2) * ax - (a + 3)) * ax * ax + 1,
        torch.where(
            ax < 2, (((ax - 5) * ax + 8) * ax - 4) * a, torch.zeros_like(ax)
        ),
    )


def device_coeffs(
    meta: torch.Tensor,  # (B, 9) float32 from clip_transform_meta
    k_pad: int,
    out: int = 224,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """On-device resample coefficients: ``(wx_w, wx_start, wy_w,
    wy_start)`` of shapes ``(B, out, K)`` / ``(B, out)``.

    Float32 re-derivation of Pillow's ``precompute_coeffs`` on the
    device, operation for operation as ``oadp_tpu``'s ``device_coeffs``
    (the host builders compute the same thing in float64).
    """
    x0, y0, cw, ch, ow, oh, left, top, identity = meta.float().unbind(-1)
    dev = meta.device

    def axis(crop0, size, n_out, offset):
        o = torch.arange(out, dtype=torch.float32, device=dev)[None, :]
        scale = (size / n_out)[:, None]  # (B, 1)
        filterscale = torch.clamp(scale, min=1.0)
        support = 2.0 * filterscale
        # multiply-then-divide keeps exact-tie centers exact (see oadp_tpu)
        center = ((o + offset[:, None] + 0.5) * size[:, None]) / (
            n_out[:, None]
        )
        xmin = torch.clamp(torch.trunc(center - support + 0.5), min=0.0)
        xend = torch.minimum(
            torch.trunc(center + support + 0.5), size[:, None]
        )
        taps = torch.arange(k_pad, dtype=torch.float32, device=dev)
        taps = taps[None, None, :]
        pos = (taps + xmin[..., None] - center[..., None] + 0.5) / (
            filterscale[..., None]
        )
        w = _bicubic_t(pos)
        w = torch.where(taps < (xend - xmin)[..., None], w, 0.0)
        # left-to-right tap sum, the order oadp_tpu's reduction takes:
        # another order moves a weight by one 2^-22 step now and then
        ww = w[..., 0]
        for k in range(1, k_pad):
            ww = ww + w[..., k]
        ww = ww[..., None]
        w = w / torch.where(ww == 0, 1.0, ww)
        q = float(1 << PRECISION_BITS)
        w = torch.trunc(w * q + 0.5 * torch.sign(w)) / q
        starts = (xmin + crop0[:, None]).to(torch.int32)
        # identity crops: single unit tap per output pixel
        ident = identity[:, None].bool()
        id_starts = (crop0[:, None] + offset[:, None] + o).to(torch.int32)
        id_w = torch.zeros_like(w)
        id_w[..., 0] = 1.0
        w = torch.where(ident[..., None], id_w, w)
        starts = torch.where(ident, id_starts, starts)
        return w, starts

    wx_w, wx_s = axis(x0, cw, ow, left)
    wy_w, wy_s = axis(y0, ch, oh, top)
    return wx_w, wx_s, wy_w, wy_s


def round_u8(x: torch.Tensor) -> torch.Tensor:
    """Pillow ``clip8``: round-half-up then clamp to [0, 255]."""
    return torch.clamp(torch.floor(x + 0.5), 0.0, 255.0)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D or batched) with an fp32 result. bf16 operands on
    CUDA stay bf16 and accumulate in fp32 on the tensor cores; elsewhere
    they are upcast first, which gives the same exact products."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        fn = torch.mm if a.dim() == 2 else torch.bmm
        return fn(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


def _resize(image, wx, wy, skip_round: bool, compute_dtype=None):
    """Two-pass resize: horizontal (contract image columns), round,
    vertical (contract image rows), round. ``image`` is ``(PH, PW, 3)``
    shared by all crops or ``(B, PH, PW, 3)`` paired with them; ``wx``
    and ``wy`` are ``(B, O, P)``. Returns ``(B, OH, OW, 3)``."""
    # bf16 path: pixel integers are exact in bf16 and only the resample
    # weights round (oadp_tpu's single-pass path for bf16 encoders);
    # the products accumulate in fp32 and are never rounded to bf16
    # before round_u8.
    dt = compute_dtype or torch.float32
    wx, wy, img = wx.to(dt), wy.to(dt), image.to(dt)
    b, o, pw = wx.shape
    if img.dim() == 3:  # one image: one product for every crop
        ph = img.shape[0]
        t = matmul_f32(wx.reshape(b * o, pw), img.transpose(0, 1).reshape(pw, -1))
    else:
        ph = img.shape[1]
        t = matmul_f32(wx, img.transpose(1, 2).reshape(b, pw, -1))
    t = t.view(b, o, ph, 3).transpose(1, 2)  # (B, PH, OW, 3)
    if not skip_round:
        t = round_u8(t)
    out = matmul_f32(wy, t.to(dt).reshape(b, ph, o * 3))
    out = out.view(b, wy.shape[1], o, 3)
    if not skip_round:
        out = round_u8(out)
    return out


def apply_resize_pair(
    image: torch.Tensor,
    wx: torch.Tensor,
    wy: torch.Tensor,
    skip_round: bool = False,
    compute_dtype=None,
) -> torch.Tensor:
    """Two-pass PIL resize on device (weights from the builders above).

    Supported layouts:

    * ``image (PH,PW,3)``, ``wx (OW,PW)``        → ``(OH,OW,3)``
    * ``image (PH,PW,3)``, ``wx (B,OW,PW)``      → ``(B,OH,OW,3)``
      (one image, many crops — the objects pipeline)
    * ``image (B,PH,PW,3)``, ``wx (B,OW,PW)``    → ``(B,OH,OW,3)``
      (paired batches — the globals pipeline)

    Values are rounded to uint8 range per pass like PIL's 8-bit path
    (unless ``skip_round``). The fp32 path is a plain fp32 product (the
    PIL-exact ``Precision.HIGHEST`` path of ``oadp_tpu``); TF32 must be
    off, which :func:`oadp_torch.oake.encoders.load_clip` ensures.
    ``compute_dtype=torch.bfloat16`` selects the single-pass path.
    """
    if (image.dim(), wx.dim()) not in ((3, 2), (3, 3), (4, 3)):
        raise ValueError(f'bad ranks: image {image.dim()}, wx {wx.dim()}')
    if wx.dim() == 2:
        return _resize(image, wx[None], wy[None], skip_round, compute_dtype)[0]
    return _resize(image, wx, wy, skip_round, compute_dtype)


def expand_coeffs(
    weights: torch.Tensor,  # (..., O, K) tap weights
    starts: torch.Tensor,  # (..., O) int32 absolute first-tap indices
    pad: int,
) -> torch.Tensor:
    """Expand compact resample coefficients to dense ``(..., O, pad)``
    matrices. Tap ``k`` of output ``o`` lands on column ``starts[o] + k``;
    columns outside ``[0, pad)`` are dropped (zero-fill crop). The taps
    of one output hit distinct columns, so placing them with one scatter
    gives exactly ``oadp_tpu``'s sum of masked taps.
    """
    k = weights.shape[-1]
    cols = starts.long()[..., None] + torch.arange(k, device=starts.device)
    cols = torch.where((cols >= 0) & (cols < pad), cols, pad)
    out = torch.zeros(
        weights.shape[:-1] + (pad + 1,),
        dtype=weights.dtype, device=weights.device,
    )
    out.scatter_(-1, cols, weights)
    return out[..., :pad]


def apply_resize_coeffs(
    image: torch.Tensor,
    wx_w: torch.Tensor,  # (B, O, K) or (O, K)
    wx_start: torch.Tensor,  # (B, O) or (O,)
    wy_w: torch.Tensor,
    wy_start: torch.Tensor,
    skip_round: bool = False,
    compute_dtype=None,
) -> torch.Tensor:
    """:func:`apply_resize_pair` from compact per-crop coefficients.

    ``image`` is ``(PH, PW, 3)`` (one image, many crops) or
    ``(B, PH, PW, 3)`` paired with batched coefficients.
    """
    pad_h, pad_w = image.shape[-3], image.shape[-2]
    if compute_dtype is not None:
        wx_w = wx_w.to(compute_dtype)
        wy_w = wy_w.to(compute_dtype)
    wx = expand_coeffs(wx_w, wx_start, pad_w)
    wy = expand_coeffs(wy_w, wy_start, pad_h)
    return apply_resize_pair(
        image, wx, wy, skip_round=skip_round, compute_dtype=compute_dtype
    )


_MEAN = np.asarray(CLIP_MEAN, np.float32) * 255.0
_STD = np.asarray(CLIP_STD, np.float32) * 255.0


def normalize_clip(pixels: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """``ToTensor`` + CLIP ``Normalize`` on [0,255] pixel values."""
    mean = torch.from_numpy(_MEAN).to(pixels.device)
    std = torch.from_numpy(_STD).to(pixels.device)
    return ((pixels - mean) / std).to(dtype)
