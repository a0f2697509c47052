"""Functional building blocks of the detector stack: convolution, batch
norm and max pooling (port of ``oadp_tpu/models/layers.py``).

Conventions: activations are NCHW, convolution kernels OIHW (PyTorch's
``Conv2d`` layout), parameters and batch-norm statistics are plain dicts of
tensors with ``oadp_tpu``'s keys (``w``/``b``, ``scale``/``bias``,
``mean``/``var``). Only eval-mode batch norm is here: the inference path
never updates running statistics. Random init draws from a
``torch.Generator`` (not ``oadp_tpu``'s draws); shapes and bounds are
``oadp_tpu``'s.
"""

__all__ = [
    'BN_EPS',
    'state_tensor',
    'conv',
    'init_conv',
    'batch_norm',
    'init_bn',
    'max_pool',
]

from typing import Any

import torch
import torch.nn.functional as F

Params = dict[str, Any]

BN_EPS = 1e-5


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


def max_pool(x: torch.Tensor, window: int, stride: int, padding: int) -> torch.Tensor:
    """Max over ``window`` x ``window`` windows, padding with -inf."""
    return F.max_pool2d(x, window, stride, padding)
