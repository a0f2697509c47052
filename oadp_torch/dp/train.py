"""DP training CLI: ``python -m oadp_torch.dp.train <name> <config>
[--override .k:v ...]`` (port of ``oadp_tpu/dp/train.py``).

Trains on ``model.device`` (default ``cuda``; a run without a card raises
unless the config says ``'cpu'``). The work dir is ``work_dirs/<name>``
(``work_dirs/dry_run/<name>`` under ``DRY_RUN``, which also sets the log,
checkpoint and eval intervals to 1, 6 and 3 and the batch to 1, as
``oadp/dp/train.py:34-56``), with the resolved config and ``train.log``
(``train.rank<r>.log`` on the other ranks). ``TRAIN_WITH_VAL_DATASET``
trains on the validator's images and OAKE features. ``trainer.load_from``
grafts an mmdet-layout checkpoint (``DetectorBundle.load_pretrained``);
``trainer.resume_from`` continues a checkpoint of this trainer.

``trainer.bf16`` defaults to True on the card and False on the CPU.
Under ``torchrun`` (``WORLD_SIZE`` > 1) the processes form one data-parallel
run (NCCL on cards, gloo on the CPU): each loads its share of every global
batch of ``samples_per_gpu`` images a process.
"""

__all__ = ['main', 'parse_args', 'build_train_loader', 'build_evaluator']

import argparse
import pathlib

import torch

from ..base import Globals, coco, lvis
from ..oake.encoders import resolve_device
from ..utils import (
    Config, DictAction, Store, add_file_handler, end_rank, logger, maybe_initialize_distributed,
    rank, world_size,
)
from .builder import build_detector
from .datasets import (
    BatchBuilder, ClassBalancedWrapper, CocoDetDataset, LoadClipFeatures, Loader,
    TrainTransform,
)
from .evaluator import DetEvaluator
from .trainer import Trainer, TrainState


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('name', type=str)
    parser.add_argument('config', type=Config.load)
    parser.add_argument('--override', action=DictAction, nargs='+')
    return parser.parse_args(argv)


def build_train_loader(config: Config, categories, model_cfg) -> Loader:
    """This process's loader: its share of each global batch."""
    ds_cfg = config.trainer.dataloader.dataset
    if Store.TRAIN_WITH_VAL_DATASET:
        val_ds = config.validator.dataloader.dataset
        ds_cfg = ds_cfg.copy()
        ds_cfg.update(ann_file=val_ds.ann_file, img_prefix=val_ds.img_prefix)
        if 'clip_features' in ds_cfg:
            # the OAKE stores follow the dataset swap (reference
            # oadp/dp/datasets.py:152-155: task_name train -> val)
            ds_cfg.clip_features = {
                k: v.replace('train', 'val') if isinstance(v, str) else v
                for k, v in ds_cfg.clip_features.items()}
    clip = LoadClipFeatures(**ds_cfg.clip_features) if 'clip_features' in ds_cfg else None
    with_mask = bool(model_cfg.get('with_mask', False))
    dataset = CocoDetDataset(ds_cfg.ann_file, ds_cfg.img_prefix, categories,
                             clip_features=clip, with_mask=with_mask)
    if ds_cfg.get('oversample_thr'):
        dataset = ClassBalancedWrapper(dataset, float(ds_cfg.oversample_thr))
    batch_cfg = config.trainer.dataloader.get('batch', Config())
    builder = BatchBuilder(
        canvas=tuple(batch_cfg.get('canvas', (832, 1344))),
        max_gts=batch_cfg.get('max_gts', 100),
        max_blocks=batch_cfg.get('max_blocks', 128),
        max_objects=batch_cfg.get('max_objects', 512),
        embedding_dim=model_cfg.get('sizes', {}).get('embedding_dim', 512),
        num_all=categories.num_all,
        with_clip=clip is not None,
        with_mask=with_mask,
        max_polygon_parts=batch_cfg.get('max_polygon_parts', 8),
        max_polygon_verts=batch_cfg.get('max_polygon_verts', 96),
    )
    seed = config.trainer.get('seed', 3407)
    scales = tuple(tuple(s) for s in batch_cfg.get('scales', ((1330, 640), (1333, 800))))
    return Loader(dataset, builder, int(config.trainer.dataloader.get('samples_per_gpu', 2)),
                  TrainTransform(scales=scales, seed=seed + rank()), shuffle=True, seed=seed,
                  process_index=rank(), process_count=world_size())


def build_evaluator(config: Config, categories, bundle, bf16: bool, device,
                    work_dir=None) -> DetEvaluator:
    val_cfg = config.validator.dataloader.dataset
    dataset = CocoDetDataset(val_cfg.ann_file, val_cfg.img_prefix, categories, test_mode=True)
    batch_cfg = config.validator.dataloader.get('batch', Config())
    return DetEvaluator(
        dataset, bundle.config, categories, device=device,
        batch_size=int(config.validator.dataloader.get('samples_per_gpu', 1)),
        canvas=tuple(batch_cfg.get('canvas', (832, 1344))),
        scale=tuple(batch_cfg.get('scale', (1333, 800))),
        eval_type='lvis' if config.categories == 'lvis' else 'ov_coco',
        bf16=bf16, work_dir=work_dir,
    )


def main(argv=None) -> TrainState:
    args = parse_args(argv)
    config: Config = args.config
    if args.override:
        config.override(args.override)
    device = resolve_device(config.model.get('device', 'cuda'))
    # the process group first, as the reference's NCCL init (oadp/dp/train.py:61-63)
    if maybe_initialize_distributed(device) and device.type == 'cuda':
        device = torch.device('cuda', torch.cuda.current_device())

    name = pathlib.Path(args.name)
    if Store.DRY_RUN:
        name = pathlib.Path('dry_run') / name
        config.trainer.setdefault('log_config', Config())['interval'] = 1
        config.trainer.setdefault('checkpoint_config', Config())['interval'] = 6
        config.trainer.setdefault('evaluation', Config())['interval'] = 3
        config.trainer.dataloader['samples_per_gpu'] = 1
        config.validator.dataloader['samples_per_gpu'] = 1
    work_dir = pathlib.Path('work_dirs') / name
    work_dir.mkdir(parents=True, exist_ok=True)
    # every rank shares the work dir: the config dump is rank 0's, and each
    # rank logs to its own file (rank 0 keeps the reference's train.log)
    if rank() == 0:
        config.dump(work_dir / 'config.py')
        add_file_handler(work_dir / 'train.log')
    else:
        add_file_handler(work_dir / f'train.rank{rank()}.log')

    Globals.categories = {'coco': coco, 'lvis': lvis}[config.categories]
    import oadp_torch
    logger.info('env: oadp_torch %s, torch %s, device %s%s, %d process(es)',
                oadp_torch.__version__, torch.__version__, device,
                f' ({torch.cuda.get_device_name(device)})' if device.type == 'cuda' else '',
                world_size())

    bundle = build_detector(config.model, Globals.categories,
                            seed=config.trainer.get('seed', 3407))
    if config.trainer.get('load_from'):
        bundle.load_pretrained(config.trainer.load_from)
    bundle = bundle.to(device)

    loader = build_train_loader(config, Globals.categories, config.model)
    bf16 = bool(config.trainer.get('bf16', device.type == 'cuda'))
    evaluator = build_evaluator(config, Globals.categories, bundle, bf16, device,
                                work_dir=work_dir)
    trainer = Trainer(bundle, config.trainer, loader, work_dir, evaluator=evaluator,
                      bf16=bf16, device=device)
    resume = None
    if config.trainer.get('resume_from'):
        resume = Trainer.restore(config.trainer.resume_from, device)
        logger.info('resumed from %s @ step %d', config.trainer.resume_from, resume.step)
    return trainer.fit(resume)


if __name__ == '__main__':
    main()
    if world_size() > 1:  # a rank of a multi-process run (see utils.end_rank)
        end_rank()
