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

The bf16 route of the objects and globals steps on the card is one
hand-written CUDA kernel a dispatch, :func:`resize_crops`
(``oadp_torch/csrc/preprocess.cu``): the taps as :func:`device_coeffs`
derives them, both passes over only the taps each pixel has, the
rounding and the CLIP normalisation, from the source images to the bf16
crops. :func:`resize_crops_plain` is its plain version, a direct tap sum
with no dense matrix. ``LAUNCHES`` counts its launches.
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
    'plain_resize_matrices',
    'device_coeffs',
    'tap_sum_half',
    'coeff_ksize',
    'apply_resize_pair',
    'matmul_f32',
    'expand_coeffs',
    'apply_resize_coeffs',
    'normalize_clip',
    'round_u8',
    'LAUNCHES',
    'reset_launches',
    'resize_crops',
    'resize_crops_plain',
    'resize_crops_args',
    'resize_stage_plan',
    'resize_smem',
    'resize_bands',
    'resize_crops_supported',
]

import math

import numpy as np
import torch

from . import cuda_lib

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


def plain_resize_matrices(
    image_w: int,
    image_h: int,
    out_w: int,
    out_h: int,
    pad_w: int,
    pad_h: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Weights for plain ``PIL.Image.resize((out_w, out_h))`` (pyramid levels,
    reference ``oadp/oake/blocks.py:72-76``)."""
    wx = resize_matrix(image_w, 0, image_w, out_w, pad_w)
    wy = resize_matrix(image_h, 0, image_h, out_h, pad_h)
    return wx, wy


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


def tap_sum_half(k_pad):
    """Where :func:`device_coeffs` splits its sum of a pixel's ``k_pad``
    taps: the first part's length (an int, or elementwise over an integer
    tensor). ``oadp_tpu``'s ``w.sum(-1)`` on XLA's CPU adds up to 32 taps
    left to right, and 33 to 64 in two left-to-right halves, the first
    ``ceil(k_pad / 2)`` long, added at the end (found by matching its
    outputs bit for bit at each count; ``tests/test_torch_preprocess.py``
    holds both to it). Past 64 its order is not known and the sum stays
    left to right."""
    if isinstance(k_pad, torch.Tensor):
        return torch.where((k_pad > 32) & (k_pad <= 64), (k_pad + 1) // 2, k_pad)
    return (k_pad + 1) // 2 if 32 < k_pad <= 64 else k_pad


def _own_per_crop(k_own, crops: int, device) -> torch.Tensor | None:
    """``k_own``, one tap bucket an image of a group, as one a crop (the
    images' crops in order), or None."""
    if k_own is None:
        return None
    k_own = torch.as_tensor(np.asarray(k_own, np.int64))
    return k_own.repeat_interleave(crops // len(k_own)).to(device)


def device_coeffs(
    meta: torch.Tensor,  # (B, 9) float32 from clip_transform_meta
    k_pad: int,
    out: int = 224,
    k_own: torch.Tensor | None = None,  # (B,) int: each crop's own tap bucket
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """On-device resample coefficients: ``(wx_w, wx_start, wy_w,
    wy_start)`` of shapes ``(B, out, K)`` / ``(B, out)``.

    Float32 re-derivation of Pillow's ``precompute_coeffs`` on the
    device, operation for operation as ``oadp_tpu``'s ``device_coeffs``
    (the host builders compute the same thing in float64). ``k_own``
    (``<= k_pad``, default ``k_pad``) is the tap count ``oadp_tpu`` runs a
    crop at: its tap sum is split where :func:`tap_sum_half` splits
    ``k_own`` taps, so a crop padded to a group's larger ``k_pad`` keeps
    the weights of its own bucket bit for bit (the taps past ``k_own``
    weigh exactly 0).
    """
    x0, y0, cw, ch, ow, oh, left, top, identity = meta.float().unbind(-1)
    dev = meta.device
    own = (torch.full((meta.shape[0],), k_pad, dtype=torch.int64, device=dev)
           if k_own is None else k_own.to(device=dev, dtype=torch.int64))
    half = tap_sum_half(own)[:, None]  # (B, 1)

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
        # the tap sum in the order oadp_tpu's reduction takes on XLA's CPU
        # (another order moves a weight by one 2^-22 step now and then):
        # left to right over each part of tap_sum_half's split of the
        # crop's own tap count, then added (adding 0 is exact)
        first, rest = w[..., 0], torch.zeros_like(w[..., 0])
        for k in range(1, k_pad):
            in_first = k < half
            first = torch.where(in_first, first + w[..., k], first)
            rest = torch.where(in_first, rest, rest + w[..., k])
        ww = (first + rest)[..., None]
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


def _tap_sum(w: torch.Tensor, taps, interleaved: bool) -> torch.Tensor:
    """``sum_p w[b, o, p] * taps(p)[b, o]`` over the nonzero window of each
    row of ``w (B, O, P)``, in fp32 with a fused multiply-add per tap,
    taken in the order of XLA's CPU dot: left to right in one sum, or
    (``interleaved``) in two, over the even and the odd columns, added at
    the end. ``taps(cols)`` gives the operand's values at the columns
    ``cols (B, O)``: ``(B, O, ...)``. Zero taps inside a window add
    exactly 0, so only the window's span is visited."""
    p = w.shape[-1]
    nz = w != 0
    first = nz.to(torch.int8).argmax(-1)
    last = p - 1 - nz.flip(-1).to(torch.int8).argmax(-1)
    span = int(torch.where(nz.any(-1), last - first + 1, 0).max())
    even = odd = torch.zeros_like(taps(first), dtype=torch.float32)
    for k in range(span):
        cols = (first + k).clamp(max=p - 1)
        wk = torch.where(first + k < p, w.gather(-1, cols[..., None])[..., 0], 0.0)
        xk = taps(cols)
        shape = wk.shape + (1,) * (xk.dim() - wk.dim())
        # fp32 FMA: the exact product (in fp64) and one rounding of the sum
        prod = wk.reshape(shape).double() * xk.double()
        if interleaved:
            on_even = (cols % 2 == 0).reshape(shape)
            even = torch.where(on_even, (even.double() + prod).float(), even)
            odd = torch.where(on_even, odd, (odd.double() + prod).float())
        else:
            even = (even.double() + prod).float()
    return even + odd


def _resize_cpu_f32(image, wx, wy):
    """The fp32 resize on the CPU with XLA's CPU sums (:func:`_tap_sum`),
    so that a value within an ulp of a .5 tie rounds as in ``oadp_tpu``.
    XLA's CPU dot takes the two interleaved sums when the product it
    forms has ``N % 64 == 32`` columns and one sum otherwise (measured on
    XLA's CPU backend for these products, not derived): N is ``B * OW``
    for one image shared by the crops, ``OW`` for paired images, and
    ``3 * OW`` for the vertical pass."""
    b, ow = wx.shape[:2]
    rows = torch.arange(b)[:, None]
    if image.dim() == 3:  # (PH, PW, 3): columns of the shared image
        t = _tap_sum(wx, lambda c: image[:, c].permute(1, 2, 0, 3), b * ow % 64 == 32)
    else:  # (B, PH, PW, 3): columns of each crop's own image
        t = _tap_sum(wx, lambda c: image[rows, :, c], ow % 64 == 32)
    t = round_u8(t.transpose(1, 2))  # (B, PH, OW, 3)
    return round_u8(_tap_sum(wy, lambda r: t[rows, r], 3 * ow % 64 == 32))


def _resize(image, wx, wy, skip_round: bool, compute_dtype=None):
    """Two-pass resize: horizontal (contract image columns), round,
    vertical (contract image rows), round. ``image`` is ``(PH, PW, 3)``
    shared by all crops or ``(B, PH, PW, 3)`` paired with them; ``wx``
    and ``wy`` are ``(B, O, P)``. Returns ``(B, OH, OW, 3)``."""
    if compute_dtype is None and not skip_round and image.device.type == 'cpu':
        return _resize_cpu_f32(image.float(), wx.float(), wy.float())
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
    (unless ``skip_round``). The fp32 path is the PIL-exact
    ``Precision.HIGHEST`` path of ``oadp_tpu``: on the CPU it sums the
    taps in XLA's order and is bit-identical to ``oadp_tpu``'s; on the
    card it is a plain fp32 product, with TF32 off, which
    :func:`oadp_torch.oake.encoders.load_clip` ensures.
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


#: kernel launches per entry point, counted where the wrapper launches
LAUNCHES = {'resize_crops': 0}

#: the kernel's cap on taps an axis (``csrc/preprocess.cu``'s MAX_TAPS: the
#: order of :func:`device_coeffs`' tap sum is known up to there)
RESIZE_MAX_TAPS = 64

#: crops a chunk of the plain version (bounds its temporaries)
_PLAIN_CHUNK = 64

#: dynamic shared memory a block of the kernel may take for two to fit on
#: an SM of the H100 (228 KB an SM, 1 KB of it reserved a block, and the
#: kernel's 16 static bytes within a 256-byte margin)
RESIZE_SMEM_TWO = 233472 // 2 - 1024 - 256

#: ring rows beyond the tap count: a sub-band of output rows may reach
#: this many more source rows than one row's taps
RESIZE_RING_SLACK = 29


def resize_smem(ring: int, out: int, band: int, cap: int, k_pad: int) -> int:
    """The kernel's shared memory in bytes (``csrc/preprocess.cu``:
    ``smem_bytes``, which refuses a launch where the two differ): the ring
    of ``ring`` horizontal result rows (``out * 3`` bytes each), the staged
    source (``cap`` + 16 bytes), the taps' first source, first tap and
    count (``out`` columns, ``band`` rows), their bf16 weights and the 3 x
    256 bf16 normalisation table."""
    source = -(-ring * out * 3 // 16) * 16
    return (source + cap + 16 + 12 * (out + band) + 2 * (out + band) * k_pad + 3 * 256 * 2)


def resize_bands(crops: int, out: int, sms: int) -> tuple[int, int]:
    """``(bands a crop, output rows a band)`` of :func:`resize_crops`'
    launch on ``sms`` multiprocessors (``csrc/preprocess.cu``): the whole
    crop a block where the crops fill the card twice over, else as many
    bands as do, of at least 16 rows. The launch has ``crops x bands``
    blocks."""
    bands = min(-(-out // 16), max(1, -(-2 * sms // crops)))
    band = -(-out // bands)
    return -(-out // band), band


def resize_stage_plan(k_pad: int, pw: int, out: int = 224) -> tuple[int, int]:
    """``(ring rows, staging cap)`` of :func:`resize_crops`' kernel for
    taps of ``k_pad``, images ``pw`` wide and ``out`` x ``out`` crops: the
    ring holds ``k_pad`` + :data:`RESIZE_RING_SLACK` rows; the cap, a
    multiple of 16 bytes, takes what is left of :data:`RESIZE_SMEM_TWO` at
    a whole crop a block (two blocks an SM), but never less than one
    source row's staged pixels (4 bytes each, in 16-pixel units from a
    multiple of 16; then one block an SM)."""
    ring = k_pad + RESIZE_RING_SLACK
    row = 4 * -(-(pw + 15) // 16) * 16  # the most a row's reached columns may stage
    cap = (RESIZE_SMEM_TWO - resize_smem(ring, out, out, 0, k_pad)) // 16 * 16
    return ring, max(cap, row)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _grouped(images: torch.Tensor) -> torch.Tensor:
    """One source image ``(PH, PW, 3)`` as a group of one."""
    return images[None] if images.dim() == 3 else images


def resize_crops_plain(
    images: torch.Tensor,  # (G, PH, PW, 3) uint8, or one (PH, PW, 3)
    meta: torch.Tensor,  # (G * B, 9) float32 from clip_transform_meta
    k_pad: int,
    mean=_MEAN,  # (3,) float32, [0, 255] scale
    std=_STD,
    *,
    out: int = 224,
    return_taps: bool = False,
    k_own=None,  # G ints: each image's own tap bucket
):
    """The plain version of :func:`resize_crops`: crop ``c`` of image ``c //
    B`` resized and normalized, ``(G * B, out, out, 3)`` bf16; with
    ``return_taps`` also :func:`device_coeffs`' taps (each image's crops
    at its ``k_own``).

    A direct tap sum (no dense matrix): each weight of
    :func:`device_coeffs` rounded to bf16, then for every output value the
    fp32 sum of its taps' products taken left to right (each product is
    exact: an 8-bit integer times a bf16 weight), rounded with
    :func:`round_u8` after each pass; taps outside the image read 0. Then
    ``(p - mean) / std`` in fp32, rounded to bf16. The sums are those of
    ``apply_resize_coeffs(compute_dtype=bf16)`` in another order, so a value
    within an ulp of a .5 tie can land on the neighbouring uint8."""
    images = _grouped(images)
    g, ph, pw = images.shape[:3]
    crops = meta.shape[0]
    per = crops // g
    dev = images.device
    _check_own(k_own, g, k_pad)
    taps = device_coeffs(meta.float(), k_pad, out, _own_per_crop(k_own, crops, dev))
    wx_w, wx_s, wy_w, wy_s = taps
    wxb, wyb = (w.to(torch.bfloat16).float() for w in (wx_w, wy_w))
    mean_t = torch.as_tensor(np.asarray(mean, np.float32), device=dev)
    std_t = torch.as_tensor(np.asarray(std, np.float32), device=dev)
    res = torch.empty((crops, out, out, 3), dtype=torch.bfloat16, device=dev)
    for c0 in range(0, crops, _PLAIN_CHUNK):
        sl = slice(c0, min(c0 + _PLAIN_CHUNK, crops))
        src = images[torch.arange(sl.start, sl.stop, device=dev) // per]
        n = src.shape[0]
        ar = torch.arange(n, device=dev)[:, None]
        t = torch.zeros((n, ph, out, 3), device=dev)
        for k in range(k_pad):
            cols = wx_s[sl].long() + k  # (n, out)
            w = torch.where((cols >= 0) & (cols < pw), wxb[sl, :, k], 0.0)
            px = src[ar, :, cols.clamp(0, pw - 1)].float()  # (n, out, PH, 3)
            t = t + w[:, None, :, None] * px.transpose(1, 2)
        t = round_u8(t)
        acc = torch.zeros((n, out, out, 3), device=dev)
        for k in range(k_pad):
            rows = wy_s[sl].long() + k  # (n, out)
            w = torch.where((rows >= 0) & (rows < ph), wyb[sl, :, k], 0.0)
            acc = acc + w[:, :, None, None] * t[ar, rows.clamp(0, ph - 1)]
        res[sl] = ((round_u8(acc) - mean_t) / std_t).to(torch.bfloat16)
    return (res, taps) if return_taps else res


def _check_own(k_own, g: int, k_pad: int) -> None:
    if k_own is not None and (len(k_own) != g or not all(0 < k <= k_pad for k in k_own)):
        raise ValueError(f'resize_crops: k_own {list(k_own)} is not {g} tap counts in '
                         f'(0, {k_pad}]')


def resize_crops_supported(k_pad: int) -> bool:
    """Whether :func:`resize_crops`' kernel takes ``k_pad`` taps an axis: up
    to :data:`RESIZE_MAX_TAPS`, as far as :func:`device_coeffs`' tap sum has
    a known order (the objects CLI passes it once ``max_image_size`` is
    above ~1227)."""
    return 0 < k_pad <= RESIZE_MAX_TAPS


def resize_crops_args(images: torch.Tensor, meta: torch.Tensor, k_pad: int,
                      out: int = 224, k_own=None) -> tuple[int, int, int]:
    """What :func:`resize_crops` hands its kernel about the inputs, checked:
    ``(G, crops per image, elements between images)``. Raises on what the
    kernel does not take: not uint8 images whose each ``(PH, PW, 3)`` is
    contiguous (the group may be a view, as the packed chunks are), not
    fp32 contiguous ``(G * B, 9)`` scalars, a tap count past the kernel's
    cap, ``k_own`` not one count in ``(0, k_pad]`` an image."""
    images = _grouped(images)
    if images.dim() != 4 or images.shape[-1] != 3 or images.dtype != torch.uint8:
        raise TypeError(f'resize_crops: images must be uint8 (G, PH, PW, 3), got '
                        f'{images.dtype} {tuple(images.shape)}')
    g, ph, pw = images.shape[:3]
    if images.stride()[1:] != (pw * 3, 3, 1):
        raise ValueError(f'resize_crops: each image must be contiguous, strides '
                         f'{images.stride()}')
    if (meta.dtype != torch.float32 or meta.dim() != 2 or meta.shape[1] != 9
            or not meta.is_contiguous() or meta.shape[0] % g):
        raise ValueError(f'resize_crops: meta must be contiguous fp32 (G * B, 9), got '
                         f'{meta.dtype} {tuple(meta.shape)} for G = {g}')
    if not resize_crops_supported(k_pad) or out <= 0 or out % 8:
        raise ValueError(f'resize_crops: k_pad {k_pad} outside (0, {RESIZE_MAX_TAPS}] or out '
                         f'{out} not a multiple of 8 (16-byte stores)')
    _check_own(k_own, g, k_pad)
    return g, meta.shape[0] // g, images.stride(0)


def resize_crops(
    images: torch.Tensor,  # (G, PH, PW, 3) uint8, or one (PH, PW, 3)
    meta: torch.Tensor,  # (G * B, 9) float32 from clip_transform_meta
    k_pad: int,
    mean=_MEAN,  # (3,) float32, [0, 255] scale
    std=_STD,
    *,
    out: int = 224,
    return_taps: bool = False,
    k_own=None,  # G ints: each image's own tap bucket
    cycles=None,  # (blocks, 4) int64 on the card: clock cycles by part
):
    """The CLIP crops of a dispatch: crop ``c`` cut from image ``c // B``
    (``B`` crops an image), resized as PIL's two-pass bicubic, each pass
    rounded to uint8, and normalized: ``(G * B, out, out, 3)`` bf16. With
    ``return_taps`` also the taps the kernel derived, as
    :func:`device_coeffs` returns them (``(wx_w, wx_s, wy_w, wy_s)``).
    ``k_own`` gives each image the tap count ``oadp_tpu`` would run its
    crops at (``<= k_pad``, default ``k_pad``; see :func:`device_coeffs`).
    ``cycles`` (CUDA only), ``(crops x bands, 4)`` int64 (:func:`resize_bands`),
    receives each block's clock cycles by part, as its thread 0 sees them:
    the prologue, staging, the horizontal and the vertical pass.

    Replaces ``oadp_tpu``'s XLA ``prep_one`` and ``normalize_clip``
    (``oadp_tpu/oake/encoders.py:401-432``): :func:`device_coeffs`,
    ``apply_resize_coeffs(compute_dtype=bf16)`` and :func:`normalize_clip`.
    On a CPU tensor: :func:`resize_crops_plain`. On a CUDA tensor: one launch
    of the kernel in ``csrc/preprocess.cu`` for all ``G * B`` crops, which
    derives the taps itself (bit for bit :func:`device_coeffs`'), stages
    the source rows its band reaches in shared memory (the plan of
    :func:`resize_stage_plan`), sums only the taps each pixel has inside
    the image, and writes the crops once (616 MB at 2048 crops: bound by
    those bytes at ~0.18 ms); ``out`` a multiple of 8."""
    if images.device.type == 'cpu':
        if cycles is not None:
            raise ValueError('resize_crops: cycles are counted on the card only')
        return resize_crops_plain(images, meta, k_pad, mean, std, out=out,
                                  return_taps=return_taps, k_own=k_own)
    g, per, stride = resize_crops_args(images, meta, k_pad, out, k_own)
    if meta.device != images.device:
        raise ValueError('resize_crops: images and meta must be on one CUDA device')
    images = _grouped(images)
    crops = meta.shape[0]
    dst = torch.empty((crops, out, out, 3), dtype=torch.bfloat16, device=images.device)
    taps_w = taps_s = None
    if return_taps:
        taps_w = torch.empty((crops, 2, out, k_pad), dtype=torch.float32, device=dst.device)
        taps_s = torch.empty((crops, 2, out), dtype=torch.int32, device=dst.device)
    # where each image's tap sums split (tap_sum_half of its own count)
    halves = None if k_own is None else torch.tensor(
        [tap_sum_half(int(k)) for k in k_own], dtype=torch.int32).to(dst.device)
    mean = [float(v) for v in np.asarray(mean, np.float32)]
    std = [float(v) for v in np.asarray(std, np.float32)]
    # the launch's layout, which the kernel checks against its own sizes
    bands, band = resize_bands(
        crops, out, torch.cuda.get_device_properties(dst.device).multi_processor_count)
    ring, cap = resize_stage_plan(k_pad, images.shape[2], out)
    smem = resize_smem(ring, out, band, cap, k_pad)
    if cycles is not None:
        blocks = crops * bands
        if (cycles.dtype != torch.int64 or cycles.device != dst.device
                or tuple(cycles.shape) != (blocks, 4) or not cycles.is_contiguous()):
            raise ValueError(f'resize_crops: cycles must be contiguous int64 ({blocks}, 4) '
                             f'on {dst.device}')
    lib = cuda_lib.library()
    cuda_lib.check(lib.oadp_resize_crops(
        images.data_ptr(), stride, g, per, images.shape[1], images.shape[2], meta.data_ptr(),
        k_pad, None if halves is None else halves.data_ptr(), out, *mean, *std,
        bands, band, ring, cap, smem, dst.data_ptr(),
        None if taps_w is None else taps_w.data_ptr(),
        None if taps_s is None else taps_s.data_ptr(),
        None if cycles is None else cycles.data_ptr(),
        torch.cuda.current_stream(dst.device).cuda_stream,
    ), 'resize_crops')
    LAUNCHES['resize_crops'] += 1
    if return_taps:
        return dst, (taps_w[:, 0], taps_s[:, 0], taps_w[:, 1], taps_s[:, 1])
    return dst
