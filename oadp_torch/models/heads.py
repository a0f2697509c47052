"""RoI heads and text-embedding classifiers of the DP detector (port of
``oadp_tpu/models/heads.py``).

* :func:`classifier_forward`: a normalized linear projection, cosine logits
  against frozen CLIP text embeddings (+ a background embedding), then
  the ViLD temperature (``'vild'``) or a scaler and bias (``'affine'``).
  In train mode the novel columns are ``NEG_INF`` and ``'vild'`` divides by
  ``scaler_train``. The text embeddings never take a gradient, nor does a
  ``freeze_bg`` background (both detached). Logits stay fp32: a novel
  logit of ``-1e10 / 0.007`` goes through ``log_softmax`` unharmed.
* :func:`convfc_forward` / :func:`convfc_forward_train`: mmdet's
  ``Shared{2FC,4Conv1FC}BBoxHead`` towers, their batch norms on the running
  statistics or on the batch's (over the valid RoI rows only). RoI features
  are ``(R, C, roi, roi)`` and are flattened (C, H, W) as torch flattens
  them, so the first fc's rows are in that order (``oadp_tpu`` flattens
  (H, W, C); ``models/detector.py:from_jax_params`` permutes its rows).
* :func:`global_head_forward`: mean-pooled last FPN level -> classifier.

Linear weights are ``(in, out)``, as in ``oadp_tpu``.
"""

__all__ = [
    'ClassifierConfig',
    'init_classifier',
    'classifier_forward',
    'HeadConfig',
    'init_convfc_head',
    'convfc_forward',
    'convfc_forward_train',
    'init_global_head',
    'global_head_forward',
    'convert_torch_convfc_head',
    'NEG_INF',
]

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from .layers import (
    batch_norm, batch_norm_train, conv, init_bn, init_conv, normal, state_tensor, uniform,
)

Params = dict[str, Any]
NEG_INF = -1e10


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    in_features: int = 1024
    embedding_dim: int = 512
    num_bases: int = 48
    num_all: int = 65
    with_bg: bool = True
    freeze_bg: bool = False  # object head: bg exists but never trains
    # 'vild': logits / (train ? scaler_train : scaler_val)
    # 'affine': logits * scaler - bias
    # 'none': raw cosine logits
    mode: str = 'none'
    scaler_train: float = 0.007
    scaler_val: float = 0.01
    scaler: float = 1.0
    bias: float = 0.0


def init_classifier(
    gen: torch.Generator, embeddings: torch.Tensor, config: ClassifierConfig,
) -> Params:
    d = embeddings.shape[1]
    bound = (6.0 / (config.in_features + d)) ** 0.5  # xavier_uniform
    p: Params = {
        'linear': {'w': uniform(gen, (config.in_features, d), bound),
                   'b': torch.zeros(d, device=gen.device)},
        'embeddings': embeddings.to(gen.device, torch.float32).clone(),
    }
    if config.with_bg:
        p['bg'] = uniform(gen, (1, d), (6.0 / (1 + d)) ** 0.5)
    return p


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-12)


def classifier_forward(
    params: Params, x: torch.Tensor, config: ClassifierConfig, train: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(logits (N, K[+1]), projection (N, D))``, both fp32, the
    projection L2-normalized."""
    proj = x @ params['linear']['w'].to(x.dtype) + params['linear']['b'].to(x.dtype)
    proj = _l2_normalize(proj.float())
    emb = params['embeddings'].detach()
    if 'bg' in params:
        bg = params['bg'].detach() if config.freeze_bg else params['bg']
        emb = torch.cat([emb, _l2_normalize(bg)])
    logits = proj @ emb.T
    if train:
        k = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where((k >= config.num_bases) & (k < config.num_all), NEG_INF, logits)
    if config.mode == 'vild':
        logits = logits / (config.scaler_train if train else config.scaler_val)
    elif config.mode == 'affine':
        logits = logits * config.scaler - config.bias
    return logits, proj


@dataclasses.dataclass(frozen=True)
class HeadConfig:
    num_convs: int = 0
    num_fcs: int = 2
    in_channels: int = 256
    conv_channels: int = 256
    fc_channels: int = 1024
    roi_size: int = 7
    with_reg: bool = False
    reg_class_agnostic: bool = True
    # ObjectMixin: force the background logit to -inf
    suppress_bg_logit: bool = False
    classifier: ClassifierConfig = ClassifierConfig()


def init_convfc_head(
    gen: torch.Generator, embeddings: torch.Tensor, config: HeadConfig,
) -> tuple[Params, Params]:
    """Returns ``(params, bn_stats)``."""
    params: Params = {'convs': [], 'fcs': []}
    stats: Params = {'convs': []}
    c = config.in_channels
    for _ in range(config.num_convs):
        bn, s = init_bn(config.conv_channels, gen.device)
        params['convs'].append({'conv': init_conv(gen, 3, c, config.conv_channels), 'bn': bn})
        stats['convs'].append({'bn': s})
        c = config.conv_channels
    dim = c * config.roi_size * config.roi_size
    for _ in range(config.num_fcs):
        bound = (6.0 / (dim + config.fc_channels)) ** 0.5
        params['fcs'].append({'w': uniform(gen, (dim, config.fc_channels), bound),
                              'b': torch.zeros(config.fc_channels, device=gen.device)})
        dim = config.fc_channels
    params['cls'] = init_classifier(gen, embeddings, config.classifier)
    if config.with_reg:
        out = 4 if config.reg_class_agnostic else 4 * config.classifier.num_all
        params['reg'] = {'w': normal(gen, (dim, out), 0.001),
                         'b': torch.zeros(out, device=gen.device)}
    return params, stats


def _convfc(params: Params, stats: Params, x: torch.Tensor, config: HeadConfig,
            train: bool, norm) -> tuple[torch.Tensor, torch.Tensor | None, torch.Tensor, Params]:
    """``norm(x, p, s) -> (y, new_s)`` after every conv."""
    new_stats: Params = {'convs': []}
    for p, s in zip(params['convs'], stats['convs']):
        x, ns = norm(conv(x, p['conv'], padding=1), p['bn'], s['bn'])
        new_stats['convs'].append({'bn': ns})
        x = F.relu(x)
    x = x.reshape(x.shape[0], -1)  # (C, H, W) flatten
    for p in params['fcs']:
        x = F.relu(x @ p['w'].to(x.dtype) + p['b'].to(x.dtype))
    logits, proj = classifier_forward(params['cls'], x, config.classifier, train)
    if config.suppress_bg_logit:
        logits = torch.cat([logits[:, :-1], torch.full_like(logits[:, -1:], NEG_INF)], 1)
    reg = None
    if 'reg' in params:
        reg = x @ params['reg']['w'].to(x.dtype) + params['reg']['b'].to(x.dtype)
    return logits, reg, proj, new_stats


def convfc_forward(
    params: Params, stats: Params, x: torch.Tensor, config: HeadConfig,
) -> tuple[torch.Tensor, torch.Tensor | None, torch.Tensor]:
    """``x (R, C, roi, roi)`` -> ``(cls_logits, reg_deltas | None,
    projection)``, eval mode."""
    return _convfc(params, stats, x, config, False,
                   lambda y, p, s: (batch_norm(y, p, s), s))[:3]


def convfc_forward_train(
    params: Params, stats: Params, x: torch.Tensor, config: HeadConfig,
    valid: torch.Tensor | None = None, all_sum=None,
) -> tuple[torch.Tensor, torch.Tensor | None, torch.Tensor, Params]:
    """Train mode: ``(cls_logits, reg_deltas | None, projection,
    new_stats)``; the batch norms' statistics over the rows that ``valid``
    marks (of the global batch when ``all_sum`` sums over processes)."""
    return _convfc(params, stats, x, config, True,
                   lambda y, p, s: batch_norm_train(y, p, s, mask=valid, all_sum=all_sum))


def init_global_head(
    gen: torch.Generator, embeddings: torch.Tensor, config: ClassifierConfig,
) -> Params:
    return {'cls': init_classifier(gen, embeddings, config)}


def global_head_forward(
    params: Params, feats: list[torch.Tensor], config: ClassifierConfig, train: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean-pool the last FPN map (NCHW) -> classifier."""
    return classifier_forward(params['cls'], feats[-1].mean(dim=(2, 3)), config, train)


def convert_torch_convfc_head(
    state: dict, prefix: str, config: HeadConfig, init_params: Params,
) -> tuple[Params, Params]:
    """mmdet ``ConvFCBBoxHead`` (+ OADP ``Classifier``) state dict ->
    ``(params, stats)``: ``shared_convs.{i}.conv/bn``, ``shared_fcs.{i}``
    (read as ``(in, out)``, the first one's rows already in the port's
    (C, H, W) order), ``fc_cls._linear``, ``fc_cls._bg_embedding``,
    ``fc_reg``. The text embeddings are a non-persistent buffer in the
    reference, so those of ``init_params`` are kept, as are its background
    embedding and regression layer where the state dict has none."""

    def a(name):
        return state_tensor(state[prefix + name])

    params: Params = {'convs': [], 'fcs': []}
    stats: Params = {'convs': []}
    for i in range(config.num_convs):
        base = f'shared_convs.{i}'
        params['convs'].append({
            'conv': {'w': a(f'{base}.conv.weight')},
            'bn': {'scale': a(f'{base}.bn.weight'), 'bias': a(f'{base}.bn.bias')},
        })
        stats['convs'].append({'bn': {'mean': a(f'{base}.bn.running_mean'),
                                      'var': a(f'{base}.bn.running_var')}})
    for i in range(config.num_fcs):
        params['fcs'].append({'w': a(f'shared_fcs.{i}.weight').T.contiguous(),
                              'b': a(f'shared_fcs.{i}.bias')})
    cls: Params = {
        'linear': {'w': a('fc_cls._linear.weight').T.contiguous(),
                   'b': a('fc_cls._linear.bias')},
        'embeddings': init_params['cls']['embeddings'].float().cpu().clone(),
    }
    if prefix + 'fc_cls._bg_embedding' in state:
        cls['bg'] = a('fc_cls._bg_embedding')
    elif 'bg' in init_params['cls']:
        cls['bg'] = init_params['cls']['bg'].float().cpu().clone()
    params['cls'] = cls
    if config.with_reg and prefix + 'fc_reg.weight' in state:
        params['reg'] = {'w': a('fc_reg.weight').T.contiguous(), 'b': a('fc_reg.bias')}
    elif 'reg' in init_params:
        params['reg'] = init_params['reg']
    return params, stats
