"""The CLIP image encoders' patch embedding and ``ln_pre`` on hand-written
kernels, and their plain PyTorch versions.

``oadp_tpu`` leaves all of it to XLA (``oadp_tpu/models/clip.py:331-364``
``_embed_patches``, the conv at ``:350``, and ``ln_pre`` at ``:423``). On
the card, in bf16, the port computes ``x = ln_pre(cat(cls, conv1(images)) +
pos)`` in three launches (:func:`patch_embed_ln_pre`):

* :func:`patch_rows`: the conv's im2col rows ``(B * g * g, 3 * P * P)``
  bf16, in the K order ``(c, i, j)`` of ``conv1.reshape(D, -1)`` over the
  ``(D, 3, P, P)`` layout, zeros where a window crosses the padding
  (``csrc/embed.cu``);
* :func:`patch_embed`: the product with ``conv1`` K-major on ``ln_gemm``
  (``ops/attention.py:_ln_gemm``, no LayerNorm, no epilogue; a profile
  tells it from kernel 1's QKV product as the ``ln_gemm`` launch after
  ``patch_rows``): one fp32 sum, rounded once to bf16;
* :func:`embed_ln_pre`: the CLS row, the positional embedding and ``ln_pre``
  (``csrc/embed.cu``), rounding at each step as the plain route does.

Each entry takes its plain version on a CPU tensor and launches its kernel,
or raises, on a CUDA tensor. ``LAUNCHES`` counts the launches.
"""

__all__ = [
    'LAUNCHES',
    'embed_ln_pre',
    'embed_ln_pre_plain',
    'patch_embed',
    'patch_embed_ln_pre',
    'patch_embed_plain',
    'patch_embed_supported',
    'patch_geometry',
    'patch_rows',
    'patch_rows_plain',
    'reset_launches',
]

import torch
import torch.nn.functional as F

from . import attention as A
from . import cuda_lib
from .preprocess import matmul_f32

#: kernel launches per entry point, counted where the wrapper launches
LAUNCHES = {'patch_rows': 0, 'patch_embed': 0, 'embed_ln_pre': 0}

#: the widest row ``embed_ln_pre``'s kernel holds in a warp's registers
EMBED_MAX_WIDTH = 1024


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def patch_embed_supported(patch: int, width: int, image_size: int) -> bool:
    """Whether the encoders' patch embedding takes the kernels on the card:
    ``ln_gemm``'s depth ``3 * P * P`` a multiple of 64 (so ``P`` of 8, each
    16-byte store of ``patch_rows`` 8 columns of one patch row), ``D % 8 ==
    0`` and ``D <= 1024`` (``ln_gemm``'s output, ``embed_ln_pre``'s rows),
    and crop rows of 16-byte words (``image_size % 8 == 0``)."""
    return (3 * patch * patch % 64 == 0 and width % 8 == 0 and width <= EMBED_MAX_WIDTH
            and image_size % 8 == 0)


def patch_geometry(size: int, patch: int, stride: int) -> tuple[int, int]:
    """``(pad, g)``: the conv's padding on each side and its grid, as
    ``models/clip.py:ViTConfig.grid`` (the surgery's half stride pads by
    ``(P - 1) // 2``; the stock stride pads nothing)."""
    pad = 0 if stride == patch else (patch - 1) // 2
    return pad, (size + 2 * pad - patch) // stride + 1


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def patch_rows_plain(crops: torch.Tensor, patch: int, stride: int) -> torch.Tensor:
    """``(B, H, W, 3)`` → the conv's rows ``(B * g * g, 3 * P * P)``, row
    ``(b, gy, gx)``, column ``(c, i, j)``: ``F.pad`` and two unfolds."""
    b, h, w, _ = crops.shape
    pad, g = patch_geometry(h, patch, stride)
    x = F.pad(crops, (0, 0, pad, pad, pad, pad))
    # (B, g, g, 3, P, P): unfold appends each window's offset as a dimension
    x = x.unfold(1, patch, stride).unfold(2, patch, stride)[:, :g, :g]
    return x.reshape(b * g * g, 3 * patch * patch)


def patch_embed_plain(rows: torch.Tensor, conv1_wt: torch.Tensor) -> torch.Tensor:
    """``rows @ conv1_wt.T`` with one fp32 sum, rounded once to the rows'
    dtype (``conv1_wt`` is ``conv1.reshape(D, -1)``)."""
    return matmul_f32(rows, conv1_wt.t()).to(rows.dtype)


def embed_ln_pre_plain(rows, cls, pos, ln_scale, ln_bias) -> torch.Tensor:
    """``ln_pre(cat(cls, rows) + pos)`` over ``(B, g * g, D)`` rows →
    ``(B, 1 + g * g, D)``: ``models/clip.py``'s ``_embed_patches`` tail and
    ``_layer_norm`` (the CLS row and ``pos`` cast to the rows' dtype, the
    add rounded there, LayerNorm with fp32 statistics and the scale and
    bias cast to the rows' dtype, rounded once)."""
    b, _, d = rows.shape
    x = torch.cat([cls.to(rows.dtype).expand(b, 1, d), rows], 1) + pos.to(rows.dtype)
    return F.layer_norm(x, (d,), ln_scale.to(x.dtype), ln_bias.to(x.dtype), 1e-5)


# ---------------------------------------------------------------------------
# Kernel launchers
# ---------------------------------------------------------------------------


def patch_rows(crops: torch.Tensor, patch: int, stride: int) -> torch.Tensor:
    """The conv's im2col rows of ``(B, H, W, 3)`` crops, ``(B * g * g, 3 * P
    * P)`` (see :func:`patch_rows_plain`). On a CUDA tensor, one launch of
    ``csrc/embed.cu``'s ``patch_rows_kernel``: bound by bytes (0.62 GB read,
    2.47 GB written at 2048 crops of the surgery's half stride: ~0.92 ms)."""
    if crops.device.type == 'cpu':
        return patch_rows_plain(crops, patch, stride)
    name = 'patch_rows'
    A._check_cuda(name, crops)
    b, h, w, c = crops.shape
    if c != 3 or (w * 3) % 8 or patch % 8:
        raise ValueError(f'{name}: unsupported crops {tuple(crops.shape)} for P = {patch}, '
                         f'S = {stride}')
    pad, g = patch_geometry(h, patch, stride)
    rows = torch.empty((b * g * g, 3 * patch * patch), dtype=crops.dtype, device=crops.device)
    cuda_lib.check(cuda_lib.library().oadp_patch_rows(
        crops.data_ptr(), b, h, w, patch, stride, pad, g, rows.data_ptr(), A._stream(),
    ), name)
    LAUNCHES[name] += 1
    return rows


def patch_embed(rows: torch.Tensor, conv1_wt: torch.Tensor,
                bias: torch.Tensor | None = None) -> torch.Tensor:
    """``rows @ conv1_wt.T`` → ``(M, D)`` (see :func:`patch_embed_plain`). On
    a CUDA tensor, one ``ln_gemm`` launch without LayerNorm or epilogue, its
    plan from ``ln_gemm_plan``; ``bias`` is the launch's zero ``(D,)`` bf16
    vector (made here if None). At 2048 crops of the half stride it is 1.89
    TFLOP: bound by operations at ~1.9 ms."""
    if rows.device.type == 'cpu':
        return patch_embed_plain(rows, conv1_wt)
    name = 'patch_embed'
    if bias is None:
        bias = torch.zeros(conv1_wt.shape[0], dtype=rows.dtype, device=rows.device)
    A._check_cuda(name, rows, conv1_wt, bias)
    if rows.dim() != 2 or conv1_wt.shape[1] != rows.shape[1] or bias.shape != conv1_wt.shape[:1]:
        raise ValueError(f'{name}: rows {tuple(rows.shape)}, weight {tuple(conv1_wt.shape)}, '
                         f'bias {tuple(bias.shape)}')
    out = torch.empty((rows.shape[0], conv1_wt.shape[0]), dtype=rows.dtype, device=rows.device)
    A._ln_gemm(rows, conv1_wt, bias, out)
    LAUNCHES[name] += 1
    return out


def embed_ln_pre(rows, cls, pos, ln_scale, ln_bias, *, ln32=None) -> torch.Tensor:
    """``ln_pre(cat(cls, rows) + pos)`` → ``(B, 1 + g * g, D)`` (see
    :func:`embed_ln_pre_plain`). ``ln32`` is the fp32 pair of the
    bf16-rounded scale and bias (made here if None). On a CUDA tensor, one
    launch of ``csrc/embed.cu``'s ``embed_ln_pre_kernel``, a warp a row:
    bound by bytes (0.62 GB read, 0.62 GB written at 2048 crops: ~0.37
    ms)."""
    if rows.device.type == 'cpu':
        return embed_ln_pre_plain(rows, cls, pos, ln_scale, ln_bias)
    name = 'embed_ln_pre'
    b, n, d = rows.shape
    cls, pos = cls.to(rows.dtype).contiguous(), pos.to(rows.dtype).contiguous()
    if ln32 is None:
        ln32 = A.ln_fp32(ln_scale.to(rows.dtype), ln_bias.to(rows.dtype))
    A._check_cuda(name, rows, cls, pos)
    A._check_cuda(name, *ln32, dtype=torch.float32)
    if (cls.shape != (d,) or pos.shape != (n + 1, d) or ln32[0].shape != (d,)
            or ln32[1].shape != (d,) or d % 8 or d > EMBED_MAX_WIDTH):
        raise ValueError(f'{name}: rows {tuple(rows.shape)}, cls {tuple(cls.shape)}, '
                         f'pos {tuple(pos.shape)}')
    out = torch.empty((b, n + 1, d), dtype=rows.dtype, device=rows.device)
    cuda_lib.check(cuda_lib.library().oadp_embed_ln_pre(
        rows.data_ptr(), cls.data_ptr(), pos.data_ptr(), ln32[0].data_ptr(),
        ln32[1].data_ptr(), b, n + 1, d, out.data_ptr(), A._stream(),
    ), name)
    LAUNCHES[name] += 1
    return out


def patch_embed_ln_pre(images, conv1, cls, pos, ln_scale, ln_bias, stride: int, *,
                       conv1_wt=None, conv1_b=None, ln32=None) -> torch.Tensor:
    """``ln_pre`` of the patch embedding of ``(B, H, W, 3)`` images →
    ``(B, 1 + g * g, D)``: :func:`patch_rows`, :func:`patch_embed` and
    :func:`embed_ln_pre`, one launch each on the card. ``conv1`` is ``(D, 3,
    P, P)``; ``conv1_wt`` (``conv1.reshape(D, -1)``), ``conv1_b`` (zeros)
    and ``ln32`` are the prepared copies (``models/clip.py:
    prepare_kernel_params``), made here if None."""
    d, _, p, _ = conv1.shape
    if conv1_wt is None:
        conv1_wt = conv1.reshape(d, -1).contiguous()
    rows = patch_rows(images, p, stride)
    x = patch_embed(rows, conv1_wt, conv1_b)
    return embed_ln_pre(x.view(images.shape[0], -1, d), cls, pos, ln_scale, ln_bias, ln32=ln32)
