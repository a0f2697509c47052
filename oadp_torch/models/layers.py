"""Functional building blocks of the detector stack: convolution, batch
norm and max pooling (port of ``oadp_tpu/models/layers.py``).

Conventions: activations are NCHW, convolution kernels OIHW (PyTorch's
``Conv2d`` layout), parameters and batch-norm statistics are plain dicts of
tensors with ``oadp_tpu``'s keys (``w``/``b``, ``scale``/``bias``,
``mean``/``var``). Batch norm comes in two forms: :func:`batch_norm` on the
running statistics, and :func:`batch_norm_train` on the batch's, which
returns the new running statistics. Random init draws from a
``torch.Generator`` (not ``oadp_tpu``'s draws); shapes and bounds are
``oadp_tpu``'s.
"""

__all__ = [
    'BN_EPS',
    'state_tensor',
    'conv',
    'init_conv',
    'batch_norm',
    'batch_norm_train',
    'init_bn',
    'max_pool',
]

from typing import Any

import torch
import torch.nn.functional as F

Params = dict[str, Any]

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # torch default


def state_tensor(value) -> torch.Tensor:
    """A state-dict value (tensor or array) as an fp32 CPU tensor of its
    own."""
    return torch.as_tensor(value).detach().float().cpu().clone()


def uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    """``U(-bound, bound)`` fp32 on the generator's device."""
    return (torch.rand(*shape, generator=gen, device=gen.device) * 2 - 1) * bound


def normal(gen: torch.Generator, shape, std: float) -> torch.Tensor:
    return torch.randn(*shape, generator=gen, device=gen.device) * std


def init_conv(
    gen: torch.Generator, k: int, c_in: int, c_out: int, bias: bool = False,
) -> Params:
    """Kaiming-uniform fan-in init (torch ``Conv2d`` default)."""
    fan_in = k * k * c_in
    p = {'w': uniform(gen, (c_out, c_in, k, k), (6.0 / fan_in) ** 0.5)}
    if bias:
        p['b'] = uniform(gen, (c_out,), (1.0 / fan_in) ** 0.5)
    return p


def conv(x: torch.Tensor, p: Params, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """``x (N, C, H, W)`` with ``p['w'] (O, I, kH, kW)`` cast to ``x``'s
    dtype; the bias, if any, is added after the convolution, as
    ``oadp_tpu`` adds it."""
    out = F.conv2d(x, p['w'].to(x.dtype), stride=stride, padding=padding)
    if 'b' in p:
        out = out + p['b'].to(x.dtype)[:, None, None]
    return out


def init_bn(c: int, device=None) -> tuple[Params, Params]:
    """Returns ``(params, stats)``: affine params and running stats."""
    params = {'scale': torch.ones(c, device=device), 'bias': torch.zeros(c, device=device)}
    stats = {'mean': torch.zeros(c, device=device), 'var': torch.ones(c, device=device)}
    return params, stats


def batch_norm(
    x: torch.Tensor, p: Params, stats: Params, eps: float = BN_EPS,
) -> torch.Tensor:
    """Eval-mode batch norm over dim 1 (channels) with the running stats,
    computed in fp32 and cast back to ``x``'s dtype."""
    shape = (1, -1) + (1,) * (x.ndim - 2)
    inv = torch.rsqrt(stats['var'] + eps) * p['scale'].float()
    out = (x.float() - stats['mean'].reshape(shape)) * inv.reshape(shape)
    return (out + p['bias'].float().reshape(shape)).to(x.dtype)


def batch_norm_train(
    x: torch.Tensor,
    p: Params,
    stats: Params,
    mask: torch.Tensor | None = None,
    all_sum=None,
    momentum: float = BN_MOMENTUM,
    eps: float = BN_EPS,
) -> tuple[torch.Tensor, Params]:
    """Train-mode batch norm over dim 1: normalises with the batch's
    statistics (biased variance, fp32) and returns ``(out, new_stats)``, the
    running statistics moved by ``momentum`` towards the batch mean and the
    unbiased variance, as torch's ``BatchNorm`` moves them.

    ``mask`` (bool over dim 0) leaves padded rows out of the statistics
    (mmdet never pads RoI batches). ``all_sum`` sums the per-channel sums and
    the count over the processes of a run before each division, so that the
    statistics are those of the global batch (mmcv ``SyncBN``; ``oadp_tpu``
    gets them from one program over its mesh)."""
    xf = x.float()
    dims = [0] + list(range(2, x.ndim))
    shape = (1, -1) + (1,) * (x.ndim - 2)
    total = (lambda t: t) if all_sum is None else all_sum
    if mask is None:
        m = None
        n = xf.new_tensor(float(xf.numel() // xf.shape[1]))
    else:
        m = mask.reshape((-1,) + (1,) * (x.ndim - 1)).float()
        n = m.sum() * float(torch.Size(x.shape[2:]).numel())
    n = total(n).clamp(min=1.0)
    mean = total((xf if m is None else xf * m).sum(dims)) / n
    sq = (xf - mean.reshape(shape)).square()
    var = total((sq if m is None else sq * m).sum(dims)) / n
    unbiased = var * n / (n - 1).clamp(min=1.0)
    new_stats = {'mean': (1 - momentum) * stats['mean'] + momentum * mean.detach(),
                 'var': (1 - momentum) * stats['var'] + momentum * unbiased.detach()}
    inv = torch.rsqrt(var + eps) * p['scale'].float()
    out = (xf - mean.reshape(shape)) * inv.reshape(shape) + p['bias'].float().reshape(shape)
    return out.to(x.dtype), new_stats


def max_pool(x: torch.Tensor, window: int, stride: int, padding: int) -> torch.Tensor:
    """Max over ``window`` x ``window`` windows, padding with -inf."""
    return F.max_pool2d(x, window, stride, padding)
