"""The CLIP encoders' fused layers: hand-written CUDA kernels and their
plain PyTorch versions.

Each entry point keeps the signature and layouts of its Pallas
counterpart in ``oadp_tpu/ops/attention.py`` (activations ``(B, N, D)``,
weights ``(in, out)``, bias ``(B, N)`` fp32 ``[patch biases..., y bias]``).
A tensor on the CPU takes the plain version, which sits beside the
kernel in this module; a CUDA tensor launches the kernel or raises.

The kernels (``oadp_torch/csrc``) are two families:

* ``ln_gemm``: rows x W + bias with fp32 accumulation, an optional
  LayerNorm prologue (fp32 statistics, eps 1e-5) and an epilogue of
  none, quick_gelu or a residual add;
* ``attention``: one block per (crop, head), K and V of the head in
  shared memory, optional main rows and an optional side row (the OAKE
  masked attention pool as query N+1 over ``[k[1:], ky]``).

Both keep the TPU semantics: the softmax clamps logits at 80 and
normalises after the PV product (``oadp_tpu/ops/attention.py:46-50``;
``PARITY.md`` lists the clamp as a documented deviation). In this first
version the qkv intermediate round-trips device memory between the two
kernels (about 1.9 GB per layer at 2048 crops); keeping it on chip is
later work. ``LAUNCHES`` counts each entry point's kernel launches.
"""

__all__ = [
    'LAUNCHES',
    'fused_ln_mlp_rows',
    'fused_ln_mlp_rows_plain',
    'fused_ln_qkv_attention',
    'fused_ln_qkv_attention_plain',
    'fused_surgery_layer',
    'fused_surgery_layer_plain',
    'layer_norm',
    'reset_launches',
]

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
}

_EPI_NONE, _EPI_GELU, _EPI_RESIDUAL = 0, 1, 2
_HEAD_DIM = 64
_MAX_TOKENS = 256


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def _side_attention(qkv, qkv_y, bias, heads: int, scale: float):
    """One query per crop over keys ``[k[1:], ky]`` → ``(B, D)``."""
    d = qkv.shape[-1] // 3
    k, v = (_heads(t[:, 1:], heads) for t in qkv[..., d:].split(d, -1))
    b = qkv_y.shape[0]
    qy, ky, vy = (t.reshape(b, heads, -1) for t in qkv_y.split(d, -1))
    s = (k.float() @ qy.float()[..., None])[..., 0] * scale  # (B, h, P)
    s = s + bias[:, None, :-1]
    sy = (qy.float() * ky.float()).sum(-1) * scale + bias[:, None, -1]
    e = torch.exp(torch.clamp(s, max=LOGIT_CLAMP))
    ey = torch.exp(torch.clamp(sy, max=LOGIT_CLAMP))
    o = (e.to(qkv.dtype).float()[:, :, None] @ v.float())[:, :, 0]
    o = o + ey[..., None] * vy.float()
    o = o / (e.sum(-1) + ey)[..., None]
    return o.to(qkv.dtype).reshape(o.shape[0], -1)


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
    side = _side_attention(qkv, qkv_y, bias.float(), heads, scale)
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


# ---------------------------------------------------------------------------
# Kernel launchers
# ---------------------------------------------------------------------------


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != 'cuda':
            raise ValueError(f'{name}: all tensors must be on one CUDA device')
        if t.dtype != torch.bfloat16:
            raise TypeError(f'{name}: the CUDA kernel takes bfloat16, got {t.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{name}: tensors must be contiguous')
        if t.data_ptr() % 16:
            raise ValueError(f'{name}: tensors must be 16-byte aligned')


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _ln_gemm(a2d, w, bias, out, ln=None, epilogue=_EPI_NONE, residual=None,
             col0: int = 0):
    """``out = epilogue(LN?(a2d) @ w[:, col0:col0+N] + bias[col0:col0+N])``
    with ``N = out.shape[1]``."""
    m, k = a2d.shape
    n = out.shape[1]
    if (k % 64 or n % 8 or col0 % 8 or (m + 127) // 128 >= 65536
            or (ln is not None and k > 1024)
            or w.shape[0] != k or col0 + n > w.shape[1] or out.shape[0] != m):
        raise ValueError(f'ln_gemm: unsupported shape M={m} K={k} N={n} w={tuple(w.shape)}')
    lib = cuda_lib.library()
    # both operands K-major for wgmma: the weight slice is transposed here
    # (3.5 MB for the QKV weight, microseconds against a milliseconds GEMM)
    wt = w[:, col0:col0 + n].t().contiguous()
    bias = bias[col0:col0 + n].contiguous()
    gamma = beta = ln_out = None
    if ln is not None:
        gamma = ln[0].float().contiguous()
        beta = ln[1].float().contiguous()
        ln_out = torch.empty_like(a2d)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    cuda_lib.check(lib.oadp_ln_gemm(
        a2d.data_ptr(), m, k, ptr(gamma), ptr(beta), ptr(ln_out),
        wt.data_ptr(), n, bias.data_ptr(), epilogue, ptr(residual),
        out.data_ptr(), _stream(),
    ), 'ln_gemm')


def _attention(qkv, b: int, n: int, heads: int, ld: int, offs, scale: float,
               out=None, qkv_y=None, bias=None, side=None):
    if n > _MAX_TOKENS or b >= 65536:
        raise ValueError(f'attention: unsupported shape B={b} N={n}')
    lib = cuda_lib.library()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    d = heads * _HEAD_DIM
    cuda_lib.check(lib.oadp_attention(
        qkv.data_ptr(), b, n, heads, ld, *offs, float(scale),
        ptr(out), d, ptr(qkv_y), 3 * d, ptr(bias), ptr(side), d, _stream(),
    ), 'attention')


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
):
    """One OAKE-surgery layer's attention: LN, QKV, the main stream's
    unmasked attention and the side stream's masked attention pool.

    Replaces ``oadp_tpu/ops/attention.py:fused_surgery_layer`` (kernel
    ``_surgery_layer_kernel``). Returns ``(main (B, N, D), side (B, D))``,
    only ``side`` with ``with_main=False``, or with ``out_w`` the
    post-residual streams ``(x + attn @ out_w + out_b, y + side @ out_w +
    out_b)``.

    On the H100 (bf16): ``ln_gemm`` with the LN prologue over the x rows
    and over the y rows, then ``attention`` for main and side rows, then
    ``ln_gemm`` with the residual epilogue for the out-projection of both.
    At 2048 crops the layer is 2.16 TFLOP, bound by tensor-core operations
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
    tensors = [x, y, ln_scale, ln_bias, qkv_w, qkv_b]
    if out_w is not None:
        tensors += [out_w, out_b]
    _check_cuda(name, *tensors)
    _check_heads(name, d, heads)
    if (y.shape != (b, d) or bias.shape != (b, n) or bias.dtype != torch.float32
            or bias.device != x.device
            or qkv_w.shape != (d, 3 * d) or qkv_b.shape != (3 * d,)):
        raise ValueError(f'{name}: shape or dtype mismatch')
    bias = bias.contiguous()
    ln = (ln_scale, ln_bias)
    qkv_y = torch.empty((b, 3 * d), dtype=x.dtype, device=x.device)
    _ln_gemm(y, qkv_w, qkv_b, qkv_y, ln=ln)
    side = torch.empty((b, d), dtype=x.dtype, device=x.device)
    if not with_main:
        kv = torch.empty((b * n, 2 * d), dtype=x.dtype, device=x.device)
        _ln_gemm(x.view(b * n, d), qkv_w, qkv_b, kv, ln=ln, col0=d)
        _attention(kv, b, n, heads, 2 * d, (0, 0, d), scale,
                   qkv_y=qkv_y, bias=bias, side=side)
        LAUNCHES[name] += 1
        return side
    qkv = torch.empty((b * n, 3 * d), dtype=x.dtype, device=x.device)
    _ln_gemm(x.view(b * n, d), qkv_w, qkv_b, qkv, ln=ln)
    main = torch.empty_like(x)
    _attention(qkv, b, n, heads, 3 * d, (0, d, 2 * d), scale,
               out=main, qkv_y=qkv_y, bias=bias, side=side)
    if out_w is None:
        LAUNCHES[name] += 1
        return main, side
    if out_w.shape != (d, d) or out_b.shape != (d,):
        raise ValueError(f'{name}: out_w/out_b shape mismatch')
    x_out = torch.empty_like(x)
    y_out = torch.empty_like(y)
    _ln_gemm(main.view(b * n, d), out_w, out_b, x_out.view(b * n, d),
             epilogue=_EPI_RESIDUAL, residual=x)
    _ln_gemm(side, out_w, out_b, y_out, epilogue=_EPI_RESIDUAL, residual=y)
    LAUNCHES[name] += 1
    return x_out, y_out


def fused_ln_mlp_rows(
    y: torch.Tensor,  # (B, D) rows
    ln_scale, ln_bias,  # (D,)
    fc_w, fc_b,  # (D, 4D), (4D,)
    proj_w, proj_b,  # (4D, D), (D,)
):
    """``y + proj(quick_gelu(fc(LN(y))))`` over a ``(B, D)`` row batch.

    Replaces ``oadp_tpu/ops/attention.py:fused_ln_mlp_rows`` (kernel
    ``_row_mlp_kernel``). On the H100 (bf16): ``ln_gemm`` with the LN
    prologue and the quick_gelu epilogue, then ``ln_gemm`` with the
    residual epilogue. At 2048 rows it is 19.3 GFLOP on 14 MB of weights:
    bound by operations at about 0.02 ms, so at this size the two launches
    and the weight reads dominate.
    """
    if y.device.type == 'cpu':
        return fused_ln_mlp_rows_plain(
            y, ln_scale, ln_bias, fc_w, fc_b, proj_w, proj_b
        )
    name = 'fused_ln_mlp_rows'
    _check_cuda(name, y, ln_scale, ln_bias, fc_w, fc_b, proj_w, proj_b)
    b, d = y.shape
    hidden = fc_w.shape[1]
    if fc_w.shape != (d, hidden) or proj_w.shape != (hidden, d):
        raise ValueError(f'{name}: shape mismatch')
    h = torch.empty((b, hidden), dtype=y.dtype, device=y.device)
    _ln_gemm(y, fc_w, fc_b, h, ln=(ln_scale, ln_bias), epilogue=_EPI_GELU)
    out = torch.empty_like(y)
    _ln_gemm(h, proj_w, proj_b, out, epilogue=_EPI_RESIDUAL, residual=y)
    LAUNCHES[name] += 1
    return out


def fused_ln_qkv_attention(
    x: torch.Tensor,  # (B, N, D) residual-stream input (pre-LN)
    ln_scale, ln_bias,  # (D,)
    qkv_w, qkv_b,  # (D, 3D), (3D,)
    heads: int,
    scale: float,
):
    """LayerNorm → QKV projection → softmax attention → ``(B, N, D)``,
    before the out-projection.

    Replaces ``oadp_tpu/ops/attention.py:fused_ln_qkv_attention`` (kernel
    ``_ln_qkv_attn_kernel``). On the H100 (bf16): ``ln_gemm`` with the LN
    prologue, then ``attention`` on the main rows. At the globals batch
    (16 images of 50 tokens) it is about 3 GFLOP, a few microseconds of
    tensor-core time, so launch latency and the 3.5 MB weight read bound it.
    """
    if x.device.type == 'cpu':
        return fused_ln_qkv_attention_plain(
            x, ln_scale, ln_bias, qkv_w, qkv_b, heads, scale
        )
    name = 'fused_ln_qkv_attention'
    _check_cuda(name, x, ln_scale, ln_bias, qkv_w, qkv_b)
    b, n, d = x.shape
    _check_heads(name, d, heads)
    if qkv_w.shape != (d, 3 * d) or qkv_b.shape != (3 * d,):
        raise ValueError(f'{name}: shape mismatch')
    qkv = torch.empty((b * n, 3 * d), dtype=x.dtype, device=x.device)
    _ln_gemm(x.view(b * n, d), qkv_w, qkv_b, qkv, ln=(ln_scale, ln_bias))
    out = torch.empty_like(x)
    _attention(qkv, b, n, heads, 3 * d, (0, d, 2 * d), scale, out=out)
    LAUNCHES[name] += 1
    return out
