"""Class-agnostic FCN mask head and its loss (port of
``oadp_tpu/models/mask_head.py``).

mmdet's ``FCNMaskHead`` as the OV-LVIS config sets it: 4 x (3x3 conv 256 +
ReLU), a 2x transposed-conv upsample + ReLU, 1x1 logits, one mask channel,
28 x 28 masks from 14 x 14 RoI features; the loss is the per-pixel BCE over
the positive RoIs. The upsample keeps
``ConvTranspose2d``'s ``(in, out, kH, kW)`` weight layout.
"""

__all__ = [
    'MaskHeadConfig',
    'init_mask_head',
    'mask_head_forward',
    'mask_loss',
    'convert_torch_mask_head',
]

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from ..base.losses import binary_cross_entropy
from .layers import conv, init_conv, state_tensor

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MaskHeadConfig:
    num_convs: int = 4
    in_channels: int = 256
    conv_channels: int = 256
    roi_size: int = 14
    mask_size: int = 28
    mask_thr_binary: float = 0.5


def init_mask_head(gen: torch.Generator, config: MaskHeadConfig = MaskHeadConfig()) -> Params:
    params: Params = {'convs': []}
    c = config.in_channels
    for _ in range(config.num_convs):
        params['convs'].append(init_conv(gen, 3, c, config.conv_channels, bias=True))
        c = config.conv_channels
    up = init_conv(gen, 2, c, c, bias=True)
    params['upsample'] = {'w': up['w'].transpose(0, 1).contiguous(), 'b': up['b']}
    params['logits'] = init_conv(gen, 1, c, 1, bias=True)
    return params


def mask_head_forward(params: Params, x: torch.Tensor) -> torch.Tensor:
    """``x (R, C, roi, roi)`` -> ``(R, 2*roi, 2*roi)`` mask logits."""
    for p in params['convs']:
        x = F.relu(conv(x, p, padding=1))
    # ConvTranspose2d(k=2, s=2): each input pixel maps onto its own 2x2
    # output block; the bias is added after, as oadp_tpu adds it
    up = F.conv_transpose2d(x, params['upsample']['w'].to(x.dtype), stride=2)
    x = F.relu(up + params['upsample']['b'].to(x.dtype)[:, None, None])
    return conv(x, params['logits'])[:, 0]


def mask_loss(
    logits: torch.Tensor,  # (R, m, m)
    targets: torch.Tensor,  # (R, m, m) float 0/1
    pos_mask: torch.Tensor,  # (R,)
    all_sum=None,
) -> torch.Tensor:
    """mmdet's mask CE: the per-pixel BCE averaged over the pixels and the
    positive RoIs (of every process, with ``all_sum``)."""
    weights = pos_mask[:, None, None].float().expand(logits.shape)
    n_pos = pos_mask.sum().float()
    n_pos = (n_pos if all_sum is None else all_sum(n_pos)).clamp(min=1.0)
    return binary_cross_entropy(logits, targets, weights,
                                n_pos * (logits.shape[1] * logits.shape[2]))


def convert_torch_mask_head(state: dict, prefix: str = 'roi_head.mask_head.') -> Params:
    """An mmdet ``FCNMaskHead`` state dict to params (torch layouts kept:
    conv ``(out, in, kH, kW)``, transposed conv ``(in, out, kH, kW)``)."""

    def a(name):
        return state_tensor(state[prefix + name])

    params: Params = {'convs': []}
    i = 0
    while f'{prefix}convs.{i}.conv.weight' in state:
        params['convs'].append({'w': a(f'convs.{i}.conv.weight'),
                                'b': a(f'convs.{i}.conv.bias')})
        i += 1
    params['upsample'] = {'w': a('upsample.weight'), 'b': a('upsample.bias')}
    params['logits'] = {'w': a('conv_logits.weight'), 'b': a('conv_logits.bias')}
    return params
