"""ResNet-50 backbone in PyTorch, NCHW (port of ``oadp_tpu/models/resnet.py``).

mmdet's ``ResNet`` as the DP configs set it: depth 50, four stages, all
four outputs, ``style='pytorch'`` (stride in the 3x3 conv) or ``'caffe'``
(stride in the first 1x1), ``norm_eval=True`` (batch norm on its running
statistics, in training too, while its affine trains) and
``frozen_stages=1`` (the stem and stage 1 take no gradient: their parameters
are detached). Every convolution's eval-mode batch norm is folded into it
(:func:`_conv_bn_eval`). The paddings are explicit integers, as in
``oadp_tpu``.

Training with ``norm_eval=False`` (no DP config sets it) normalises every
batch norm with the batch's statistics and moves its running statistics, in
the frozen stages too, as ``oadp_tpu`` does (mmdet keeps frozen stages in
eval mode: a deviation of ``oadp_tpu`` that the port reproduces).

:func:`convert_torch_resnet` reads a torchvision / mmdet ``backbone.*``
state dict straight into this tree (OIHW weights kept).
"""

__all__ = [
    'ResNetConfig',
    'STAGE_BLOCKS',
    'init_resnet_params',
    'resnet_forward',
    'convert_torch_resnet',
]

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from .clip import map_params
from .layers import (
    BN_EPS, batch_norm_train, conv, init_bn, init_conv, max_pool, state_tensor,
)

Params = dict[str, Any]

STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    depth: int = 50
    style: str = 'pytorch'  # or 'caffe'
    frozen_stages: int = 1
    norm_eval: bool = True
    base_channels: int = 64
    blocks: tuple | None = None  # override stage depths (tests/DRY_RUN)

    @property
    def stage_blocks(self) -> tuple:
        return self.blocks or STAGE_BLOCKS[self.depth]

    @property
    def out_channels(self) -> tuple:
        c = self.base_channels
        return (c * 4, c * 8, c * 16, c * 32)


def _init_bottleneck(gen, c_in: int, c_mid: int, downsample: bool):
    c_out = c_mid * 4
    bn1, s1 = init_bn(c_mid, gen.device)
    bn2, s2 = init_bn(c_mid, gen.device)
    bn3, s3 = init_bn(c_out, gen.device)
    p = {
        'conv1': init_conv(gen, 1, c_in, c_mid), 'bn1': bn1,
        'conv2': init_conv(gen, 3, c_mid, c_mid), 'bn2': bn2,
        'conv3': init_conv(gen, 1, c_mid, c_out), 'bn3': bn3,
    }
    s = {'bn1': s1, 'bn2': s2, 'bn3': s3}
    if downsample:
        bnd, sd = init_bn(c_out, gen.device)
        p['downsample'] = {'conv': init_conv(gen, 1, c_in, c_out), 'bn': bnd}
        s['downsample'] = {'bn': sd}
    return p, s


def init_resnet_params(
    gen: torch.Generator, config: ResNetConfig = ResNetConfig()
) -> tuple[Params, Params]:
    """Returns ``(params, bn_stats)``."""
    bn_stem, s_stem = init_bn(config.base_channels, gen.device)
    params: Params = {'stem': {'conv': init_conv(gen, 7, 3, config.base_channels),
                               'bn': bn_stem}}
    stats: Params = {'stem': {'bn': s_stem}}
    c_in = config.base_channels
    for i, n_blocks in enumerate(config.stage_blocks):
        c_mid = config.base_channels * (2 ** i)
        stage_p, stage_s = [], []
        for b in range(n_blocks):
            p, s = _init_bottleneck(gen, c_in if b == 0 else c_mid * 4, c_mid, b == 0)
            stage_p.append(p)
            stage_s.append(s)
            c_in = c_mid * 4
        params[f'layer{i + 1}'] = stage_p
        stats[f'layer{i + 1}'] = stage_s
    return params, stats


def _conv_bn_eval(x, cp: Params, bp: Params, bs: Params, stride: int = 1,
                  padding: int = 0) -> torch.Tensor:
    """Conv followed by eval-mode BN, the BN folded into the conv:
    ``w' = w * inv`` and ``b' = bias - mean * inv`` with ``inv = scale *
    rsqrt(var + eps)``. The fold is done in fp32 and cast to the activation
    dtype after, as ``oadp_tpu`` does, so bf16 agrees with it."""
    inv = torch.rsqrt(bs['var'] + BN_EPS) * bp['scale'].float()
    w = cp['w'].float() * inv[:, None, None, None]
    b = bp['bias'].float() - bs['mean'] * inv
    out = conv(x, {'w': w}, stride=stride, padding=padding)
    return out + b.to(out.dtype)[:, None, None]


def _conv_bn(x, cp: Params, bp: Params, bs: Params, stride: int = 1, padding: int = 0,
             train: bool = False, all_sum=None) -> tuple[torch.Tensor, Params]:
    """Conv and batch norm: ``(out, new_stats)``. Eval mode folds the batch
    norm into the conv and keeps ``bs``; train mode normalises with the
    batch's statistics (summed over processes by ``all_sum``)."""
    if not train:
        return _conv_bn_eval(x, cp, bp, bs, stride=stride, padding=padding), bs
    return batch_norm_train(conv(x, cp, stride=stride, padding=padding), bp, bs,
                            all_sum=all_sum)


def _bottleneck(x, p: Params, s: Params, stride: int, style: str, train: bool = False,
                all_sum=None) -> tuple[torch.Tensor, Params]:
    stride1, stride2 = (stride, 1) if style == 'caffe' else (1, stride)
    new: Params = {}
    out, new['bn1'] = _conv_bn(x, p['conv1'], p['bn1'], s['bn1'], stride=stride1,
                               train=train, all_sum=all_sum)
    out, new['bn2'] = _conv_bn(F.relu(out), p['conv2'], p['bn2'], s['bn2'], stride=stride2,
                               padding=1, train=train, all_sum=all_sum)
    out, new['bn3'] = _conv_bn(F.relu(out), p['conv3'], p['bn3'], s['bn3'], train=train,
                               all_sum=all_sum)
    if 'downsample' in p:
        identity, ds = _conv_bn(x, p['downsample']['conv'], p['downsample']['bn'],
                                s['downsample']['bn'], stride=stride, train=train,
                                all_sum=all_sum)
        new['downsample'] = {'bn': ds}
    else:
        identity = x
    return F.relu(out + identity), new


def resnet_forward(
    params: Params,
    stats: Params,
    images: torch.Tensor,  # (B, 3, H, W) normalized
    config: ResNetConfig = ResNetConfig(),
    train: bool = False,
    all_sum=None,
) -> tuple[list[torch.Tensor], Params]:
    """Returns ``([C2, C3, C4, C5], new_stats)``. The stages up to
    ``frozen_stages`` read detached parameters. With ``norm_eval`` (or not
    ``train``) every batch norm runs on its running statistics and
    ``new_stats`` is ``stats``; training without ``norm_eval`` gives every
    stage's batch norms the global batch's statistics (``all_sum`` sums
    their moments over processes, as ``models/fpn.py:fpn_forward_train``
    does)."""
    train_bn = train and not config.norm_eval

    def frozen(tree, stage: int):
        if config.frozen_stages < stage:
            return tree
        return map_params(tree, torch.Tensor.detach)

    stem = frozen(params['stem'], 0)
    x, stem_bn = _conv_bn(images, stem['conv'], stem['bn'], stats['stem']['bn'], stride=2,
                          padding=3, train=train_bn, all_sum=all_sum)
    new_stats: Params = {'stem': {'bn': stem_bn}}
    x = max_pool(F.relu(x), 3, 2, 1)
    outs = []
    for i in range(4):
        name = f'layer{i + 1}'
        stride = 1 if i == 0 else 2
        new_stats[name] = []
        for b, (bp, bs) in enumerate(zip(frozen(params[name], i + 1), stats[name])):
            x, ns = _bottleneck(x, bp, bs, stride if b == 0 else 1, config.style, train_bn,
                                all_sum)
            new_stats[name].append(ns)
        outs.append(x)
    return outs, new_stats if train_bn else stats


# ---------------------------------------------------------------------------
# Weight conversion
# ---------------------------------------------------------------------------


def convert_torch_resnet(
    state: dict, prefix: str = '', depth: int = 50,
) -> tuple[Params, Params]:
    """A torchvision/mmdet ResNet state dict to ``(params, stats)``; the
    conv weights keep their ``(O, I, kH, kW)`` layout. ``prefix`` e.g.
    ``'backbone.'`` for mmdet checkpoints. Stage depths are ``depth``'s,
    as in ``oadp_tpu``."""

    def a(name):
        return state_tensor(state[prefix + name])

    def bn(name):
        return ({'scale': a(f'{name}.weight'), 'bias': a(f'{name}.bias')},
                {'mean': a(f'{name}.running_mean'), 'var': a(f'{name}.running_var')})

    stem_bn, stem_stats = bn('bn1')
    params: Params = {'stem': {'conv': {'w': a('conv1.weight')}, 'bn': stem_bn}}
    stats: Params = {'stem': {'bn': stem_stats}}
    for i, n_blocks in enumerate(STAGE_BLOCKS[depth]):
        stage_p, stage_s = [], []
        for b in range(n_blocks):
            base = f'layer{i + 1}.{b}'
            p: Params = {}
            s: Params = {}
            for j in (1, 2, 3):
                p[f'conv{j}'] = {'w': a(f'{base}.conv{j}.weight')}
                p[f'bn{j}'], s[f'bn{j}'] = bn(f'{base}.bn{j}')
            if f'{prefix}{base}.downsample.0.weight' in state:
                dbn, dst = bn(f'{base}.downsample.1')
                p['downsample'] = {'conv': {'w': a(f'{base}.downsample.0.weight')},
                                   'bn': dbn}
                s['downsample'] = {'bn': dst}
            stage_p.append(p)
            stage_s.append(s)
        params[f'layer{i + 1}'] = stage_p
        stats[f'layer{i + 1}'] = stage_s
    return params, stats
