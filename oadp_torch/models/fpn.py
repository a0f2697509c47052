"""Feature Pyramid Network in PyTorch, NCHW (port of
``oadp_tpu/models/fpn.py``).

mmdet's ``FPN`` as the DP configs set it: 1x1 lateral convs, nearest 2x
top-down upsampling, 3x3 output convs, each followed by batch norm (the
ViLD overlay's SyncBN), no activations, and P6 as a stride-2 1x1 max pool
of P5. :func:`fpn_forward` runs the batch norms on their running
statistics, :func:`fpn_forward_train` on the batch's.
"""

__all__ = ['init_fpn_params', 'fpn_forward', 'fpn_forward_train', 'convert_torch_fpn']

from typing import Any

import torch

from .layers import (
    batch_norm, batch_norm_train, conv, init_bn, init_conv, max_pool, state_tensor,
)

Params = dict[str, Any]


def init_fpn_params(
    gen: torch.Generator,
    in_channels: tuple = (256, 512, 1024, 2048),
    out_channels: int = 256,
) -> tuple[Params, Params]:
    params: Params = {'laterals': [], 'outputs': []}
    stats: Params = {'laterals': [], 'outputs': []}
    for c in in_channels:
        bn, s = init_bn(out_channels, gen.device)
        params['laterals'].append({'conv': init_conv(gen, 1, c, out_channels), 'bn': bn})
        stats['laterals'].append({'bn': s})
    for _ in in_channels:
        bn, s = init_bn(out_channels, gen.device)
        params['outputs'].append(
            {'conv': init_conv(gen, 3, out_channels, out_channels), 'bn': bn})
        stats['outputs'].append({'bn': s})
    return params, stats


def _upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def _fpn(params: Params, stats: Params, feats: list[torch.Tensor], num_outs: int, norm
         ) -> tuple[list[torch.Tensor], Params]:
    """``norm(x, p, s) -> (y, new_s)`` after every conv."""
    new_stats: Params = {'laterals': [], 'outputs': []}
    laterals = []
    for i, f in enumerate(feats):
        x, s = norm(conv(f, params['laterals'][i]['conv']), params['laterals'][i]['bn'],
                    stats['laterals'][i]['bn'])
        laterals.append(x)
        new_stats['laterals'].append({'bn': s})
    for i in range(len(feats) - 1, 0, -1):
        laterals[i - 1] = laterals[i - 1] + _upsample_nearest_2x(laterals[i])
    outs = []
    for i, x in enumerate(laterals):
        y, s = norm(conv(x, params['outputs'][i]['conv'], padding=1),
                    params['outputs'][i]['bn'], stats['outputs'][i]['bn'])
        outs.append(y)
        new_stats['outputs'].append({'bn': s})
    while len(outs) < num_outs:
        outs.append(max_pool(outs[-1], 1, 2, 0))
    return outs, new_stats


def fpn_forward(
    params: Params, stats: Params, feats: list[torch.Tensor], num_outs: int = 5,
) -> list[torch.Tensor]:
    """``[C2..C5]`` (NCHW) to ``[P2..P6]``."""
    return _fpn(params, stats, feats, num_outs, lambda x, p, s: (batch_norm(x, p, s), s))[0]


def fpn_forward_train(
    params: Params, stats: Params, feats: list[torch.Tensor], num_outs: int = 5,
    all_sum=None,
) -> tuple[list[torch.Tensor], Params]:
    """``([P2..P6], new_stats)`` with train-mode batch norms (statistics of
    the global batch when ``all_sum`` sums over processes)."""
    return _fpn(params, stats, feats, num_outs,
                lambda x, p, s: batch_norm_train(x, p, s, all_sum=all_sum))


def convert_torch_fpn(
    state: dict, prefix: str = 'neck.', n_levels: int = 4,
) -> tuple[Params, Params]:
    """An mmdet FPN state dict (``neck.lateral_convs.{i}.conv/bn``,
    ``neck.fpn_convs.{i}.conv/bn``) to ``(params, stats)``. A module with
    no ``.bn`` (plain FPN, conv bias) gets the identity batch norm that
    ``oadp_tpu`` gives it (``var = 1 - 1e-5``)."""

    def a(name):
        return state_tensor(state[prefix + name])

    def module(base):
        p: Params = {'conv': {'w': a(f'{base}.conv.weight')}}
        if f'{prefix}{base}.conv.bias' in state:
            p['conv']['b'] = a(f'{base}.conv.bias')
        if f'{prefix}{base}.bn.weight' in state:
            p['bn'] = {'scale': a(f'{base}.bn.weight'), 'bias': a(f'{base}.bn.bias')}
            s = {'mean': a(f'{base}.bn.running_mean'), 'var': a(f'{base}.bn.running_var')}
        else:
            c = p['conv']['w'].shape[0]
            p['bn'] = {'scale': torch.ones(c), 'bias': torch.zeros(c)}
            s = {'mean': torch.zeros(c), 'var': torch.ones(c) - 1e-5}
        return p, {'bn': s}

    params: Params = {'laterals': [], 'outputs': []}
    stats: Params = {'laterals': [], 'outputs': []}
    for i in range(n_levels):
        p, s = module(f'lateral_convs.{i}')
        params['laterals'].append(p)
        stats['laterals'].append(s)
        p, s = module(f'fpn_convs.{i}')
        params['outputs'].append(p)
        stats['outputs'].append(s)
    return params, stats
