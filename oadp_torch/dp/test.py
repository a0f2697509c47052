"""DP test CLI: ``python -m oadp_torch.dp.test <config> <checkpoint>
[--override .k:v ...]`` (port of ``oadp_tpu/dp/test.py``).

Runs the detector over the validator dataset on ``model.device`` (default
``cuda``; a run without a card raises unless the config says ``'cpu'``)
and returns the OV-COCO or OV-LVIS metrics. With ``DUMP=<dir>`` it writes
per-image raw logit records instead.

The checkpoint argument is a checkpoint of the port's trainer
(``ckpt_<step>.pth``, or the ``latest.txt`` that names one): its params and
batch-norm statistics replace the config's weights, and its directory is the
gather root of a multi-process eval. With ``none`` the weights come from
``model.pretrained`` (an mmdet-layout state dict), as in ``oadp_tpu``. fp32
eval on the card runs with TF32 off for convolutions and matmuls
(``oadp_tpu``'s fp32 is the reference); ``validator.bf16=True`` runs
activations in bf16.
"""

__all__ = ['main', 'parse_args']

import argparse
import pathlib

import torch

from ..base import Globals, coco, lvis
from ..oake.encoders import resolve_device
from ..utils import (
    Config, DictAction, Store, logger, maybe_initialize_distributed, rank, world_size,
)
from .builder import build_detector
from .datasets import CocoDetDataset
from .evaluator import DetEvaluator
from .trainer import Trainer


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('config', type=Config.load)
    parser.add_argument('checkpoint', type=str)
    parser.add_argument('--override', action=DictAction, nargs='+')
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    config: Config = args.config
    if args.override:
        config.override(args.override)
    if Store.DRY_RUN:
        config.validator.dataloader['samples_per_gpu'] = 1
    trained = bool(args.checkpoint) and args.checkpoint != 'none'
    if world_size() > 1 and not trained and not Store.DUMP:
        raise SystemExit(
            'multi-process dp.test without a checkpoint has no shared gather '
            'root: set DUMP=<directory all ranks share>')
    device = resolve_device(config.model.get('device', 'cuda'))
    if maybe_initialize_distributed(device) and device.type == 'cuda':
        device = torch.device('cuda', torch.cuda.current_device())
    if device.type == 'cuda':
        # fp32 eval is compared with oadp_tpu's fp32: no TF32 products
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    Globals.categories = {'coco': coco, 'lvis': lvis}[config.categories]
    bundle = build_detector(config.model, Globals.categories).to(device)
    if trained:
        state = Trainer.restore(args.checkpoint, device)
        bundle.params, bundle.stats = state.params, state.stats
        logger.info('loaded checkpoint %s (step %d)', args.checkpoint, state.step)
    val_cfg = config.validator.dataloader.dataset
    dataset = CocoDetDataset(val_cfg.ann_file, val_cfg.img_prefix, Globals.categories,
                             test_mode=True)
    batch_cfg = config.validator.dataloader.get('batch', Config())
    evaluator = DetEvaluator(
        dataset,
        bundle.config,
        Globals.categories,
        device=device,
        batch_size=int(config.validator.dataloader.get('samples_per_gpu', 1)),
        canvas=tuple(batch_cfg.get('canvas', (832, 1344))),
        scale=tuple(batch_cfg.get('scale', (1333, 800))),
        eval_type='lvis' if config.categories == 'lvis' else 'ov_coco',
        bf16=bool(config.get('validator', Config()).get('bf16', False)),
        # multi-process gather root: every rank reads the checkpoint there
        work_dir=pathlib.Path(args.checkpoint).parent if trained else None,
    )
    metrics = evaluator.run(bundle.params, bundle.stats)
    if rank() == 0:
        for k, v in sorted(metrics.items()):
            logger.info('%s: %s', k, v)
    return metrics


if __name__ == '__main__':
    main()
