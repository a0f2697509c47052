"""Config -> detector assembly for the DP CLIs (port of
``oadp_tpu/dp/builder.py``).

Prompt loading with rows reordered to ``categories.all_``, the detector
config and its random init, the graft of a pretrained mmdet-layout
checkpoint (SoCo / torchvision backbones, and the heads of a trained
reference checkpoint), and the anchors of each static canvas.

The tree is built and grafted on the CPU, from a ``torch.Generator``
seeded with ``seed`` (not ``oadp_tpu``'s draws), so that a run on the card
and one on the CPU start from the same weights; :meth:`DetectorBundle.to`
moves it.
"""

__all__ = [
    'load_prompts',
    'build_detector',
    'canvas_anchors',
    'DetectorBundle',
]

import dataclasses
import pathlib
from typing import Any

import numpy as np
import torch

from ..base import Categories
from ..models import detector as DET
from ..models import fpn as FP
from ..models import resnet as RN
from ..models import rpn as RPN
from ..models.clip import map_params
from ..models.heads import convert_torch_convfc_head
from ..models.layers import state_tensor
from ..models.mask_head import convert_torch_mask_head
from ..utils import Config, load_pth, logger


def load_prompts(
    path: str, categories: Categories, embedding_dim: int = 512,
) -> dict[str, Any]:
    """Load a prompt file ``{names, embeddings[, scaler, bias]}`` and
    reorder rows to ``categories.all_``. A missing file gives random
    normalized embeddings (numpy, seed 0, as ``oadp_tpu``'s) with a
    warning."""
    if path and pathlib.Path(path).exists():
        data = load_pth(path)
        names = list(data['names'])
        emb = np.asarray(data['embeddings'], np.float32)
        emb = emb[[names.index(n) for n in categories.all_]]
        out = {'embeddings': emb}
        if 'scaler' in data:
            out['scaler'] = float(np.asarray(data['scaler']).reshape(()))
            out['bias'] = float(np.asarray(data['bias']).reshape(()))
        return out
    logger.warning('prompt file %s not found; using random embeddings', path)
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((categories.num_all, embedding_dim)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    return {'embeddings': emb}


@dataclasses.dataclass
class DetectorBundle:
    config: DET.DetectorConfig
    params: Any
    stats: Any

    def to(self, device: torch.device) -> 'DetectorBundle':
        """This bundle with every tensor on ``device``."""
        return DetectorBundle(
            self.config,
            map_params(self.params, lambda t: t.to(device)),
            map_params(self.stats, lambda t: t.to(device)),
        )

    def _graft_heads(self, state: dict, path: str) -> None:
        """Graft a trained reference checkpoint's RoI and global heads
        (``roi_head.bbox_head``, ``roi_head._object_head``,
        ``roi_head._block_head``, ``_global_head._classifier``)."""
        heads = [
            ('bbox_head', 'roi_head.bbox_head.', self.config.bbox_head),
            ('object_head', 'roi_head._object_head.', self.config.object_head),
            ('block_head', 'roi_head._block_head.', self.config.block_head),
        ]
        for name, prefix, cfg in heads:
            if name not in self.params or not any(k.startswith(prefix) for k in state):
                continue
            p, s = convert_torch_convfc_head(state, prefix, cfg, self.params[name])
            self.params[name] = p
            if name in self.stats:
                self.stats[name] = s
            logger.info('grafted %s from %s', name, path)
        gp = '_global_head._classifier.'
        if 'global_head' in self.params and any(k.startswith(gp) for k in state):
            cls = self.params['global_head']['cls']
            cls['linear'] = {'w': state_tensor(state[gp + '_linear.weight']).T.contiguous(),
                             'b': state_tensor(state[gp + '_linear.bias'])}
            if gp + '_bg_embedding' in state:
                cls['bg'] = state_tensor(state[gp + '_bg_embedding'])
            logger.info('grafted global_head from %s', path)

    def load_pretrained(self, path: str) -> None:
        """Graft a torch checkpoint (SoCo / mmdet ``state_dict`` with
        ``backbone.*`` / ``neck.*``, or a bare torchvision ResNet) onto the
        random init."""
        if not path or not pathlib.Path(path).exists():
            if path:
                logger.warning('pretrained %s not found; keeping init', path)
            return
        raw = torch.load(path, map_location='cpu', weights_only=False)
        state = raw.get('state_dict', raw) if isinstance(raw, dict) else raw
        if any(k.startswith('backbone.') for k in state):
            self.params['backbone'], self.stats['backbone'] = RN.convert_torch_resnet(
                state, 'backbone.')
            if any(k.startswith('neck.') for k in state):
                self.params['fpn'], self.stats['fpn'] = FP.convert_torch_fpn(state, 'neck.')
            if any(k.startswith('rpn_head.') for k in state):
                self.params['rpn'] = RPN.convert_torch_rpn(state)
            if 'mask_head' in self.params and any(
                    k.startswith('roi_head.mask_head.') for k in state):
                # a partial mask head raises here (oadp_tpu warns and keeps
                # the random init, whose masks would mean nothing)
                self.params['mask_head'] = convert_torch_mask_head(state)
                logger.info('grafted mask head from %s', path)
            if any(k.startswith('roi_head.bbox_head.') for k in state):
                self._graft_heads(state, path)
            logger.info('loaded pretrained backbone(+neck) from %s', path)
        elif 'conv1.weight' in state:
            self.params['backbone'], self.stats['backbone'] = RN.convert_torch_resnet(state)
            logger.info('loaded torchvision backbone from %s', path)
        else:
            logger.warning('unrecognized checkpoint format: %s', path)


def build_detector(
    model_cfg: Config, categories: Categories, seed: int = 0,
) -> DetectorBundle:
    """``model_cfg`` mirrors the reference model config surface: prompts,
    scalers, head toggles, optional size overrides, and
    ``backbone.norm_eval`` (False trains the backbone's batch norms). The
    bundle is on the CPU."""
    emb_dim = model_cfg.get('sizes', {}).get('embedding_dim', 512)
    bbox_prompts = load_prompts(model_cfg.get('prompts', 'data/prompts/vild.pth'),
                                categories, embedding_dim=emb_dim)
    ml = load_prompts(model_cfg.get('ml_prompts', 'data/prompts/ml_coco.pth'),
                      categories, embedding_dim=emb_dim)
    vild_scaler = model_cfg.get('vild_scaler', {})
    config = DET.DetectorConfig.build(
        categories.num_bases,
        categories.num_all,
        with_global=model_cfg.get('with_global', True),
        with_block=model_cfg.get('with_block', True),
        with_mask=model_cfg.get('with_mask', False),
        backbone_style=model_cfg.get('backbone_style', 'caffe'),
        vild_scaler_train=vild_scaler.get('train', 0.007),
        vild_scaler_val=vild_scaler.get('val', 0.01),
        cls_scaler=ml.get('scaler', 1.0),
        cls_bias=ml.get('bias', 0.0),
        head_cls_mode=model_cfg.get('head_cls_mode', 'affine'),
        global_vild_scaler=(tuple(model_cfg['global_vild_scaler'])
                            if 'global_vild_scaler' in model_cfg else None),
        **model_cfg.get('overrides', {}),
    )
    config = _apply_size_overrides(config, model_cfg)
    if 'norm_eval' in model_cfg.get('backbone', {}):
        config = dataclasses.replace(config, backbone=dataclasses.replace(
            config.backbone, norm_eval=bool(model_cfg.backbone.norm_eval)))
    params, stats = DET.init_detector(
        torch.Generator().manual_seed(seed), config,
        torch.from_numpy(bbox_prompts['embeddings']), torch.from_numpy(ml['embeddings']))
    bundle = DetectorBundle(config, params, stats)
    bundle.load_pretrained(model_cfg.get('pretrained', ''))
    return bundle


def _apply_size_overrides(config: DET.DetectorConfig, model_cfg: Config) -> DET.DetectorConfig:
    """Optional scale-down knobs for tests/DRY_RUN (mini backbone etc.)."""
    sizes = model_cfg.get('sizes')
    if not sizes:
        return config
    fpn_ch = sizes.get('fpn_channels', 256)
    fc = sizes.get('fc_channels', 1024)
    emb = sizes.get('embedding_dim', 512)

    def head(h):
        return dataclasses.replace(
            h, in_channels=fpn_ch, conv_channels=fpn_ch, fc_channels=fc,
            classifier=dataclasses.replace(h.classifier, in_features=fc, embedding_dim=emb))

    return dataclasses.replace(
        config,
        backbone=dataclasses.replace(
            config.backbone,
            base_channels=sizes.get('base_channels', 64),
            blocks=tuple(sizes['stage_blocks']) if 'stage_blocks' in sizes else None,
        ),
        fpn_channels=fpn_ch,
        bbox_head=head(config.bbox_head),
        object_head=head(config.object_head),
        block_head=head(config.block_head),
        global_cls=dataclasses.replace(config.global_cls, in_features=fpn_ch,
                                       embedding_dim=emb),
        mask_head=dataclasses.replace(config.mask_head, in_channels=fpn_ch,
                                      conv_channels=fpn_ch),
    )


def canvas_anchors(
    config: DET.DetectorConfig, canvas: tuple[int, int], device: torch.device | str = 'cpu',
) -> list[torch.Tensor]:
    """Per-level anchors for a static (H, W) canvas on ``device``."""
    gen = config.anchor_generator
    sizes = [(-(-canvas[0] // s), -(-canvas[1] // s)) for s in gen.strides]
    return [torch.from_numpy(a).to(device) for a in gen.grid_anchors(sizes)]
