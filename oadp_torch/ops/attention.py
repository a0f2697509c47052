"""The CLIP encoders' fused layers: hand-written CUDA kernels and their
plain PyTorch versions.

Each entry point keeps the signature and layouts of its Pallas
counterpart in ``oadp_tpu/ops/attention.py`` (activations ``(B, N, D)``,
weights ``(in, out)``, bias ``(B, N)`` fp32 ``[patch biases..., y bias]``).
A tensor on the CPU takes the plain version, which sits beside the
kernel in this module; a CUDA tensor launches the kernel or raises.

The CUDA kernels read each weight K-major, ``(out, in)`` as the OpenAI
state dict holds it, and the LayerNorm scale and bias in fp32. The
caller makes those copies once (:func:`kmajor`, :func:`ln_fp32`;
``models/clip.py:prepare_kernel_params`` for a whole encoder) and passes
them by keyword (``qkv_wt``, ``out_wt``, ``fc_wt``, ``proj_wt``,
``ln32``); an entry point called without them makes them itself, a copy
per call.

The kernels (``oadp_torch/csrc``) are two families and one fused kernel:

* ``ln_gemm``: rows x W + bias with fp32 accumulation, an optional
  LayerNorm prologue (fp32 statistics, eps 1e-5) and an epilogue of
  none, quick_gelu or a residual add (the residual loaded by TMA); a
  persistent TMA + wgmma GEMM, which takes up to two row sets a launch
  (the surgery layer's x rows and y rows);
* ``attention``: persistent blocks over the (crop, head) items, Q, K and
  V of an item loaded by TMA while the previous item is computed,
  optional main rows and an optional side row (the OAKE masked attention
  pool as query N+1 over ``[k[1:], ky]``). Q, K, V and the side row's qy,
  ky, vy each come with their own strides, so they may be column slices
  of one packed qkv: no operand is copied;
* ``ln_qkv_attention``: kernel 3 for short sequences (the stock encoder's
  N = 50): an LN pass, then one kernel whose blocks each own a head and a
  range of crops, run the head's QKV product on wgmma and keep its q, k
  and v in shared memory, where a warpgroup of the same block attends
  each crop as soon as its rows are in. The qkv tensor never reaches
  device memory.

All keep the TPU semantics: the softmax clamps logits at 80 and
normalises after the PV product (``oadp_tpu/ops/attention.py:46-50``;
``PARITY.md`` lists the clamp as a documented deviation). Between the two
families the qkv intermediate round-trips device memory (about 1.9 GB per
layer at 2048 crops of 197 tokens): that traffic sits under parts bound by
something else (the QKV product by tensor-core operations, ``attention``
by instruction issue), and at N = 197 the crops a 128-row tile touches
take more shared memory than is left beside the product's ring
(:func:`ln_qkv_attention_fits`), so kernel 1 keeps the two families.
``LAUNCHES`` counts each entry point's kernel launches.
"""

__all__ = [
    'LAUNCHES',
    'fused_ln_mlp_rows',
    'fused_ln_mlp_rows_plain',
    'fused_ln_mlp_rows_supported',
    'fused_ln_qkv_attention',
    'fused_ln_qkv_attention_plain',
    'fused_ln_qkv_attention_supported',
    'fused_mha_qkv',
    'fused_mha_qkv_plain',
    'fused_mha_qkv_supported',
    'fused_side_attention',
    'fused_side_attention_plain',
    'fused_side_attention_supported',
    'fused_surgery_layer',
    'fused_surgery_layer_plain',
    'fused_surgery_layer_supported',
    'kmajor',
    'layer_norm',
    'ln_fp32',
    'ln_qkv_attention_fits',
    'reset_launches',
]

import math

import torch

from . import cuda_lib

#: logits above this are clamped before ``exp`` (the Pallas kernels'
#: ``_LOGIT_CLAMP``): softmax is exact whenever the row max is below it.
LOGIT_CLAMP = 80.0

#: kernel launches per entry point, counted where the wrapper launches
LAUNCHES = {
    'fused_surgery_layer': 0,
    'fused_ln_mlp_rows': 0,
    'fused_ln_qkv_attention': 0,
    'fused_mha_qkv': 0,
    'fused_side_attention': 0,
}

_EPI_NONE, _EPI_GELU, _EPI_RESIDUAL = 0, 1, 2
_HEAD_DIM = 64
_MAX_TOKENS = 256


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def kmajor(w: torch.Tensor) -> torch.Tensor:
    """An ``(in, out)`` weight as the K-major ``(out, in)`` copy that the
    CUDA kernels read."""
    return w.t().contiguous()


def ln_fp32(scale: torch.Tensor, bias: torch.Tensor) -> tuple:
    """A LayerNorm's scale and bias as the fp32 pair the CUDA kernels
    read."""
    return scale.float().contiguous(), bias.float().contiguous()


# ---------------------------------------------------------------------------
# Shape gates: the rules of oadp_tpu's ``*_supported`` (its TPU lane
# rules), without its backend test. ``models/clip.py`` picks both image
# encoders' wiring with them, by shape alone, on every device.
# ---------------------------------------------------------------------------


def fused_mha_qkv_supported(heads: int, head_dim: int) -> bool:
    hpb = max(128 // head_dim, 1)  # heads per 128-lane block
    return heads % hpb == 0 and (head_dim * hpb) % 128 == 0


def fused_side_attention_supported(heads: int, head_dim: int) -> bool:
    return (heads * head_dim) % 128 == 0


def fused_ln_qkv_attention_supported(heads: int, head_dim: int) -> bool:
    return (heads * head_dim) % 128 == 0


def fused_surgery_layer_supported(heads: int, head_dim: int) -> bool:
    return (heads * head_dim) % 128 == 0


def fused_ln_mlp_rows_supported(rows: int, width: int) -> bool:
    return width % 128 == 0 and rows % 8 == 0


# ``csrc/ln_qkv_attention.cu``'s shared memory (its ``layout``): a ring of
# at least two 40 KB stages (a 128 x 64 LN k-tile, a head's 192 x 64
# weight k-tile) beside a 24 KB slot (q, k and v tiles of 64 x 64) for
# every crop one 128-row tile can touch.
_SMEM_LIMIT = 232448
_QKV_STAGE = 128 * 64 * 2 + 3 * _HEAD_DIM * 64 * 2
_QKV_SLOT = 3 * 64 * 128
_QKV_FIXED = 1024 + 3 * _HEAD_DIM * 4 + 10 * 8  # alignment, bias, barriers


def ln_qkv_attention_fits(n: int, d: int) -> bool:
    """Whether the fused kernel 3 takes ``N`` tokens of width ``D``
    (``D = heads x 64``): 26 <= N <= 64 and D <= 1024, so the stock
    encoder's N = 50 does (218 KB) and the objects crops' N = 197 do not."""
    if not 0 < n <= 64 or d > 1024:
        return False
    slots = 127 // n + 2
    return (_SMEM_LIMIT - _QKV_FIXED - slots * _QKV_SLOT) // _QKV_STAGE >= 2


# ---------------------------------------------------------------------------
# Plain versions (the Pallas bodies written with torch ops)
# ---------------------------------------------------------------------------


def layer_norm(rows: torch.Tensor, scale, bias) -> torch.Tensor:
    """fp32 LayerNorm rounded to the activation type (the Pallas
    kernels' ``ln``)."""
    x = rows.float()
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + 1e-5)
    return (out * scale.float() + bias.float()).to(rows.dtype)


def _proj(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` from the activation type with fp32 accumulation."""
    return x.float() @ w.float() + b.float()


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    *lead, d = t.shape
    return t.reshape(*lead, heads, d // heads).movedim(-2, -3)


def _merge(t: torch.Tensor) -> torch.Tensor:
    t = t.movedim(-3, -2)
    return t.reshape(*t.shape[:-2], -1)


def _main_attention(qkv: torch.Tensor, heads: int, scale: float):
    """Unmasked per-head attention on packed ``(B, N, 3D)`` → ``(B, N, D)``."""
    d = qkv.shape[-1] // 3
    q, k, v = (_heads(t, heads) for t in qkv.split(d, -1))
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    e = torch.exp(torch.clamp(s, max=LOGIT_CLAMP))
    o = (e.to(qkv.dtype).float() @ v.float()) / e.sum(-1, keepdim=True)
    return _merge(o.to(qkv.dtype))


def _side_attention(k, v, qy, ky, vy, bias, heads: int, scale: float):
    """One query per crop over keys ``[k[1:], ky]`` and values ``[v[1:],
    vy]`` → ``(B, D)``; ``k``, ``v`` ``(B, N, D)``, the rest ``(B, D)``."""
    b = qy.shape[0]
    kp, vp = (_heads(t[:, 1:], heads) for t in (k, v))  # (B, h, P, hd)
    qh, kh, vh = (t.reshape(b, heads, -1) for t in (qy, ky, vy))
    s = (kp.float() @ qh.float()[..., None])[..., 0] * scale  # (B, h, P)
    s = s + bias[:, None, :-1]
    sy = (qh.float() * kh.float()).sum(-1) * scale + bias[:, None, -1]
    e = torch.exp(torch.clamp(s, max=LOGIT_CLAMP))
    ey = torch.exp(torch.clamp(sy, max=LOGIT_CLAMP))
    o = (e.to(k.dtype).float()[:, :, None] @ vp.float())[:, :, 0]
    o = o + ey[..., None] * vh.float()
    o = o / (e.sum(-1) + ey)[..., None]
    return o.to(k.dtype).reshape(b, -1)


def fused_surgery_layer_plain(
    x, y, bias, ln_scale, ln_bias, qkv_w, qkv_b, heads: int, scale: float,
    with_main: bool = True, out_w=None, out_b=None,
):
    """Plain version of :func:`fused_surgery_layer`."""
    if out_w is not None and not with_main:
        raise ValueError('fold_out requires the main stream')
    n = x.shape[1]
    hy = torch.cat([
        layer_norm(x, ln_scale, ln_bias), layer_norm(y, ln_scale, ln_bias)[:, None],
    ], 1)
    qkv_all = _proj(hy, qkv_w, qkv_b).to(x.dtype)
    qkv, qkv_y = qkv_all[:, :n], qkv_all[:, n]
    d = x.shape[-1]
    side = _side_attention(
        qkv[..., d:2 * d], qkv[..., 2 * d:], *qkv_y.split(d, -1), bias.float(),
        heads, scale,
    )
    if not with_main:
        return side
    main = _main_attention(qkv, heads, scale)
    if out_w is None:
        return main, side
    proj = _proj(torch.cat([main, side[:, None]], 1), out_w, out_b)
    return (
        (x.float() + proj[:, :n]).to(x.dtype),
        (y.float() + proj[:, n]).to(y.dtype),
    )


def fused_ln_mlp_rows_plain(y, ln_scale, ln_bias, fc_w, fc_b, proj_w, proj_b):
    """Plain version of :func:`fused_ln_mlp_rows`."""
    h = _proj(layer_norm(y, ln_scale, ln_bias), fc_w, fc_b)
    h = (h * torch.sigmoid(1.702 * h)).to(y.dtype)
    return (y.float() + _proj(h, proj_w, proj_b)).to(y.dtype)


def fused_ln_qkv_attention_plain(
    x, ln_scale, ln_bias, qkv_w, qkv_b, heads: int, scale: float,
):
    """Plain version of :func:`fused_ln_qkv_attention`."""
    qkv = _proj(layer_norm(x, ln_scale, ln_bias), qkv_w, qkv_b).to(x.dtype)
    return _main_attention(qkv, heads, scale)


def fused_mha_qkv_plain(qkv, heads: int, scale: float):
    """Plain version of :func:`fused_mha_qkv`."""
    return _main_attention(qkv, heads, scale)


def fused_side_attention_plain(k, v, qy, ky, vy, bias, heads: int):
    """Plain version of :func:`fused_side_attention`."""
    scale = 1.0 / math.sqrt(k.shape[-1] // heads)
    return _side_attention(k, v, qy, ky, vy, bias.float(), heads, scale)


# ---------------------------------------------------------------------------
# Kernel launchers
# ---------------------------------------------------------------------------


def _check_cuda(name: str, *tensors: torch.Tensor, dtype=torch.bfloat16) -> None:
    for t in tensors:
        if t.device.type != 'cuda':
            raise ValueError(f'{name}: all tensors must be on one CUDA device')
        if t.dtype != dtype:
            raise TypeError(f'{name}: the CUDA kernel takes {dtype}, got {t.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{name}: tensors must be contiguous')
        if t.data_ptr() % 16:
            raise ValueError(f'{name}: tensors must be 16-byte aligned')


def _prepared(name: str, w: torch.Tensor, wt: torch.Tensor | None) -> torch.Tensor:
    """The K-major copy of ``w`` (in, out): ``wt`` checked, or made here."""
    if wt is None:
        wt = kmajor(w)
    _check_cuda(name, wt)
    if wt.shape != w.shape[::-1]:
        raise ValueError(f'{name}: K-major weight {tuple(wt.shape)} does not match '
                         f'{tuple(w.shape)}')
    return wt


def _prepared_ln(name: str, scale, bias, ln32) -> tuple:
    if ln32 is None:
        ln32 = ln_fp32(scale, bias)
    _check_cuda(name, *ln32, dtype=torch.float32)
    if ln32[0].shape != scale.shape or ln32[1].shape != bias.shape:
        raise ValueError(f'{name}: fp32 LayerNorm parameters do not match')
    return ln32


def _strided(t: torch.Tensor | None) -> tuple:
    """``(pointer, crop stride, row stride)`` of a bf16 CUDA operand of
    ``attention``: ``(B, N, D)`` or ``(B, D)`` rows whose last dimension is
    contiguous, such as a column slice of a packed qkv. The kernel reads
    16 bytes at a time, so the pointer must be 16-byte aligned and every
    stride a multiple of 8 elements; nothing is copied."""
    if t is None:
        return None, 0, 0
    if t.device.type != 'cuda' or t.dtype != torch.bfloat16 or t.data_ptr() % 16:
        raise ValueError('attention: operands must be 16-byte aligned bf16 on CUDA')
    strides = t.stride()
    if strides[-1] != 1 or any(s % 8 for s in strides[:-1]):
        raise ValueError('attention: the last dimension must be contiguous and '
                         f'the other strides multiples of 8, got {strides}')
    return t.data_ptr(), strides[0], strides[-2]


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _ln_gemm(a2d, wt, bias, out, ln32=None, epilogue=_EPI_NONE, residual=None,
             col0: int = 0, tile_n: int = 0, rows2=None):
    """``out = epilogue(LN?(a2d) @ wt[col0:col0+N].T + bias[col0:col0+N])``
    with ``N = out.shape[1]``; ``wt`` is the K-major weight (out, in) and
    ``ln32`` the fp32 LayerNorm pair. ``rows2``, ``(a2d, out, residual,
    col0)``, is a second row set of the same launches (same weight, K,
    LayerNorm and epilogue). Nothing is copied: each row slice of ``wt``
    and slice of ``bias`` is read in place. ``tile_n`` (64, 128, 256)
    overrides the kernel's choice of tile width."""
    k = a2d.shape[1]
    sets = [(a2d, out, residual, col0)] + ([rows2] if rows2 is not None else [])
    for a, o, r, c0 in sets:
        m, n = a.shape[0], o.shape[1]
        if (m == 0 or k % 64 or n % 8 or c0 % 8 or (ln32 is not None and k > 1024)
                or a.shape[1] != k or wt.shape[1] != k or c0 + n > wt.shape[0]
                or c0 + n > bias.shape[0] or o.shape[0] != m
                or (r is not None and r.shape != o.shape)
                or (r is None) != (epilogue != _EPI_RESIDUAL)
                or tile_n not in (0, 64, 128, 256)):
            raise ValueError(f'ln_gemm: unsupported shape M={m} K={k} N={n} '
                             f'wt={tuple(wt.shape)}')
    lib = cuda_lib.library()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    gamma = beta = ln_out = None
    if ln32 is not None:
        gamma, beta = ln32
        ln_out = torch.empty((sum(s[0].shape[0] for s in sets), k), dtype=a2d.dtype,
                             device=a2d.device)
    seg_args = []
    for a, o, r, c0 in sets + [(None, None, None, 0)] * (2 - len(sets)):
        seg_args += [ptr(a), 0 if a is None else a.shape[0], 0 if o is None else o.shape[1],
                     c0, ptr(r), ptr(o)]
    cuda_lib.check(lib.oadp_ln_gemm(
        k, ptr(gamma), ptr(beta), ptr(ln_out), wt.data_ptr(), bias.data_ptr(), epilogue,
        tile_n, *seg_args, _stream(),
    ), 'ln_gemm')


def _attention(q, k, v, heads: int, scale: float, out=None,
               qy=None, ky=None, vy=None, bias=None, side=None):
    """The ``attention`` kernel on ``(B, N, D)`` views ``q``, ``k``, ``v``
    (``q`` and ``out`` for the main rows; ``qy``, ``ky``, ``vy``, ``bias``
    and ``side`` for the side row)."""
    b, n, d = k.shape
    if n > _MAX_TOKENS or b == 0 or d != heads * _HEAD_DIM:
        raise ValueError(f'attention: unsupported shape B={b} N={n} D={d}')
    if (v.shape != k.shape or (out is not None and (q.shape != k.shape or out.shape != k.shape))
            or (side is not None and not (
                qy.shape == ky.shape == vy.shape == side.shape == (b, d)
                and bias.shape == (b, n) and bias.dtype == torch.float32
                and bias.is_contiguous() and bias.device == k.device))):
        raise ValueError('attention: operand shapes or types do not match')
    if any(t is not None and t.stride(0) < n * t.stride(1) for t in (q, k, v)):
        raise ValueError('attention: a crop stride is shorter than its N rows')
    args = (
        *_strided(q), *_strided(k), *_strided(v), *_strided(out),
        *_strided(qy)[::2], *_strided(ky)[::2], *_strided(vy)[::2],
        None if bias is None else bias.data_ptr(), *_strided(side)[::2],
    )
    lib = cuda_lib.library()
    cuda_lib.check(lib.oadp_attention(b, n, heads, float(scale), *args, _stream()),
                   'attention')


def _check_heads(name: str, d: int, heads: int) -> None:
    if d != heads * _HEAD_DIM:
        raise ValueError(f'{name}: the CUDA kernel takes head width 64 (D={d}, heads={heads})')


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def fused_surgery_layer(
    x: torch.Tensor,  # (B, N, D) main stream (pre-LN)
    y: torch.Tensor,  # (B, D) side stream (pre-LN)
    bias: torch.Tensor,  # (B, N) fp32: [patch biases..., y bias]
    ln_scale, ln_bias,  # (D,)
    qkv_w, qkv_b,  # (D, 3D), (3D,)
    heads: int,
    scale: float,
    with_main: bool = True,
    out_w=None,  # (D, D): fold the out-projection and both residuals
    out_b=None,
    *,
    qkv_wt=None,  # (3D, D) K-major copy of qkv_w (CUDA; made here if None)
    out_wt=None,  # (D, D) K-major copy of out_w
    ln32=None,  # fp32 (ln_scale, ln_bias)
):
    """One OAKE-surgery layer's attention: LN, QKV, the main stream's
    unmasked attention and the side stream's masked attention pool.

    Replaces ``oadp_tpu/ops/attention.py:fused_surgery_layer`` (kernel
    ``_surgery_layer_kernel``). Returns ``(main (B, N, D), side (B, D))``,
    only ``side`` with ``with_main=False``, or with ``out_w`` the
    post-residual streams ``(x + attn @ out_w + out_b, y + side @ out_w +
    out_b)``.

    On the H100 (bf16), four launches: the LN pass over the x rows and
    the y rows together; one ``ln_gemm`` for the QKV product of both row
    sets (the y rows as extra tiles of the x rows' launch); ``attention``
    for main and side rows; one ``ln_gemm`` with the residual epilogue
    for the out-projection of both, its residual tiles loaded by TMA. At
    2048 crops the layer is 2.16 TFLOP, bound by tensor-core operations
    (about 2.2 ms at 989 TFLOP/s). With ``with_main=False`` only the K and
    V columns of the x rows are projected, since no main query is needed.
    """
    if out_w is not None and not with_main:
        raise ValueError('fold_out requires the main stream')
    if x.device.type == 'cpu':
        return fused_surgery_layer_plain(
            x, y, bias, ln_scale, ln_bias, qkv_w, qkv_b, heads, scale,
            with_main, out_w, out_b,
        )
    b, n, d = x.shape
    name = 'fused_surgery_layer'
    tensors = [x, y, qkv_b]
    if out_w is not None:
        tensors.append(out_b)
    _check_cuda(name, *tensors)
    _check_heads(name, d, heads)
    if (y.shape != (b, d) or bias.shape != (b, n) or bias.dtype != torch.float32
            or bias.device != x.device
            or qkv_w.shape != (d, 3 * d) or qkv_b.shape != (3 * d,)):
        raise ValueError(f'{name}: shape or dtype mismatch')
    qkv_wt = _prepared(name, qkv_w, qkv_wt)
    ln = _prepared_ln(name, ln_scale, ln_bias, ln32)
    bias = bias.contiguous()
    qkv_y = torch.empty((b, 3 * d), dtype=x.dtype, device=x.device)
    y_rows = (y, qkv_y, None, 0)  # the y rows ride in the x rows' launches
    side = torch.empty((b, d), dtype=x.dtype, device=x.device)
    qy, ky, vy = qkv_y.split(d, -1)
    if not with_main:
        kv = torch.empty((b, n, 2 * d), dtype=x.dtype, device=x.device)
        _ln_gemm(x.view(b * n, d), qkv_wt, qkv_b, kv.view(b * n, 2 * d), ln32=ln, col0=d,
                 rows2=y_rows)
        _attention(None, *kv.split(d, -1), heads, scale,
                   qy=qy, ky=ky, vy=vy, bias=bias, side=side)
        LAUNCHES[name] += 1
        return side
    qkv = torch.empty((b, n, 3 * d), dtype=x.dtype, device=x.device)
    _ln_gemm(x.view(b * n, d), qkv_wt, qkv_b, qkv.view(b * n, 3 * d), ln32=ln, rows2=y_rows)
    main = torch.empty_like(x)
    _attention(*qkv.split(d, -1), heads, scale,
               out=main, qy=qy, ky=ky, vy=vy, bias=bias, side=side)
    if out_w is None:
        LAUNCHES[name] += 1
        return main, side
    if out_w.shape != (d, d) or out_b.shape != (d,):
        raise ValueError(f'{name}: out_w/out_b shape mismatch')
    out_wt = _prepared(name, out_w, out_wt)
    x_out = torch.empty_like(x)
    y_out = torch.empty_like(y)
    _ln_gemm(main.view(b * n, d), out_wt, out_b, x_out.view(b * n, d),
             epilogue=_EPI_RESIDUAL, residual=x.view(b * n, d),
             rows2=(side, y_out, y, 0))
    LAUNCHES[name] += 1
    return x_out, y_out


def fused_ln_mlp_rows(
    y: torch.Tensor,  # (B, D) rows
    ln_scale, ln_bias,  # (D,)
    fc_w, fc_b,  # (D, 4D), (4D,)
    proj_w, proj_b,  # (4D, D), (D,)
    *,
    fc_wt=None,  # (4D, D) K-major copy of fc_w (CUDA; made here if None)
    proj_wt=None,  # (D, 4D) K-major copy of proj_w
    ln32=None,  # fp32 (ln_scale, ln_bias)
):
    """``y + proj(quick_gelu(fc(LN(y))))`` over a ``(B, D)`` row batch.

    Replaces ``oadp_tpu/ops/attention.py:fused_ln_mlp_rows`` (kernel
    ``_row_mlp_kernel``). On the H100 (bf16): three launches, the LN pass,
    ``ln_gemm`` with the quick_gelu epilogue, ``ln_gemm`` with the residual
    epilogue, with the prepared K-major weights and fp32 LN parameters (no
    copy per call). At 2048 rows it is 19.3 GFLOP on 14 MB of weights:
    bound by operations at about 0.02 ms.
    """
    if y.device.type == 'cpu':
        return fused_ln_mlp_rows_plain(
            y, ln_scale, ln_bias, fc_w, fc_b, proj_w, proj_b
        )
    name = 'fused_ln_mlp_rows'
    _check_cuda(name, y, fc_b, proj_b)
    b, d = y.shape
    hidden = fc_w.shape[1]
    if fc_w.shape != (d, hidden) or proj_w.shape != (hidden, d):
        raise ValueError(f'{name}: shape mismatch')
    fc_wt = _prepared(name, fc_w, fc_wt)
    proj_wt = _prepared(name, proj_w, proj_wt)
    ln = _prepared_ln(name, ln_scale, ln_bias, ln32)
    h = torch.empty((b, hidden), dtype=y.dtype, device=y.device)
    _ln_gemm(y, fc_wt, fc_b, h, ln32=ln, epilogue=_EPI_GELU)
    out = torch.empty_like(y)
    _ln_gemm(h, proj_wt, proj_b, out, epilogue=_EPI_RESIDUAL, residual=y)
    LAUNCHES[name] += 1
    return out


def fused_ln_qkv_attention(
    x: torch.Tensor,  # (B, N, D) residual-stream input (pre-LN)
    ln_scale, ln_bias,  # (D,)
    qkv_w, qkv_b,  # (D, 3D), (3D,)
    heads: int,
    scale: float,
    *,
    qkv_wt=None,  # (3D, D) K-major copy of qkv_w (CUDA; made here if None)
    ln32=None,  # fp32 (ln_scale, ln_bias)
):
    """LayerNorm → QKV projection → softmax attention → ``(B, N, D)``,
    before the out-projection.

    Replaces ``oadp_tpu/ops/attention.py:fused_ln_qkv_attention`` (kernel
    ``_ln_qkv_attn_kernel``). On the H100 (bf16), routed by shape alone:
    where :func:`ln_qkv_attention_fits` (N = 50 of the stock encoder), two
    launches of ``csrc/ln_qkv_attention.cu``, the LN pass and the fused
    QKV product and attention, which keeps q, k and v in shared memory
    and writes no qkv tensor; else (N = 197) ``ln_gemm`` with the LN
    prologue, then ``attention`` on the main rows of the packed qkv it
    wrote. At the blocks batch (728 crops of 50 tokens) it is 134 GFLOP,
    bound by operations at 0.136 ms; at the globals batch (16 images) 3
    GFLOP, where launch latency and the 3.5 MB weight read bound it.
    """
    if x.device.type == 'cpu':
        return fused_ln_qkv_attention_plain(
            x, ln_scale, ln_bias, qkv_w, qkv_b, heads, scale
        )
    name = 'fused_ln_qkv_attention'
    _check_cuda(name, x, qkv_b)
    b, n, d = x.shape
    _check_heads(name, d, heads)
    if qkv_w.shape != (d, 3 * d) or qkv_b.shape != (3 * d,):
        raise ValueError(f'{name}: shape mismatch')
    qkv_wt = _prepared(name, qkv_w, qkv_wt)
    ln = _prepared_ln(name, ln_scale, ln_bias, ln32)
    out = torch.empty_like(x)
    if ln_qkv_attention_fits(n, d):
        ln_out = torch.empty_like(x)
        cuda_lib.check(cuda_lib.library().oadp_ln_qkv_attention(
            b, n, heads, float(scale), x.data_ptr(), ln[0].data_ptr(), ln[1].data_ptr(),
            ln_out.data_ptr(), qkv_wt.data_ptr(), qkv_b.data_ptr(), out.data_ptr(), _stream(),
        ), 'ln_qkv_attention')
    else:
        qkv = torch.empty((b, n, 3 * d), dtype=x.dtype, device=x.device)
        _ln_gemm(x.view(b * n, d), qkv_wt, qkv_b, qkv.view(b * n, 3 * d), ln32=ln)
        _attention(*qkv.split(d, -1), heads, scale, out=out)
    LAUNCHES[name] += 1
    return out


def fused_mha_qkv(
    qkv: torch.Tensor,  # (B, N, 3D) packed projection output
    heads: int,
    scale: float,
):
    """Multi-head attention straight off the packed QKV projection →
    ``(B, N, D)``; the heads are column slices, nothing is transposed.

    Replaces ``oadp_tpu/ops/attention.py:fused_mha_qkv`` (kernel
    ``_mha_packed_kernel``), the surgery encoder's main stream in its
    split wiring. On the H100 (bf16): ``attention`` on the main rows, with
    Q, K and V read in place from ``qkv`` (any view whose last dimension
    is contiguous). It reads qkv and writes the output once, 4 x B x N x
    D x 2 bytes (2.48 GB at 2048 crops of 197 tokens): bound by bytes at
    about 0.74 ms, against 0.25 ms of tensor-core operations.
    """
    if qkv.device.type == 'cpu':
        return fused_mha_qkv_plain(qkv, heads, scale)
    b, n, d3 = qkv.shape
    out = torch.empty((b, n, d3 // 3), dtype=qkv.dtype, device=qkv.device)
    _attention(*qkv.split(d3 // 3, -1), heads, scale, out=out)
    LAUNCHES['fused_mha_qkv'] += 1
    return out


def fused_side_attention(
    k: torch.Tensor,  # (B, N, D) keys; row 0 (the main CLS) is excluded
    v: torch.Tensor,  # (B, N, D)
    qy: torch.Tensor,  # (B, D) side-stream query
    ky: torch.Tensor,  # (B, D) side token's own key
    vy: torch.Tensor,  # (B, D) side token's own value
    bias: torch.Tensor,  # (B, N) fp32: [patch biases..., y bias]
    heads: int,
):
    """One-query masked attention over ``[patches, y]`` → ``(B, D)``, at
    scale ``1 / sqrt(D / heads)``.

    Replaces ``oadp_tpu/ops/attention.py:fused_side_attention`` (kernel
    ``_side_attn_kernel``), the surgery encoder's side row in its split
    wiring. On the H100 (bf16): ``attention`` on the side row alone. ``k``
    and ``v`` may be column slices of a packed qkv or kv (row stride 3D or
    2D), read in place. It reads K and V once, 2 x B x N x D x 2 bytes
    (1.24 GB at 2048 crops): bound by bytes at about 0.37 ms.
    """
    if k.device.type == 'cpu':
        return fused_side_attention_plain(k, v, qy, ky, vy, bias, heads)
    b, n, d = k.shape
    side = torch.empty((b, d), dtype=k.dtype, device=k.device)
    _attention(None, k, v, heads, 1.0 / math.sqrt(d // heads),
               qy=qy, ky=ky, vy=vy, bias=bias.contiguous(), side=side)
    LAUNCHES['fused_side_attention'] += 1
    return side
