"""Entry points for a quick check of the port: one forward step on the card
and a multi-process dry run of a full train step (port of
``__graft_entry__.py``).

``entry()`` returns ``(fn, args)``: the OAKE-objects forward step (device
resample coefficients, crops, CLIP normalisation, the surgery encoder with
its masked attention pool, L2 normalisation; ``oake/objects.py``'s hot
path, through ``OakeSteps``) at batch 16 on a 256 pad, with random
ViT-B/32 weights on the card in bf16. It raises without a card.

``dryrun_multichip(n)`` runs one full OADP train step (ResNet + FPN + RPN +
RCNN + the OV heads with every loss, and the torch-SGD update) at mini
widths over exactly ``n`` processes: NCCL, one card a process, or gloo on
the CPU with ``device='cpu'`` (``oadp_tpu``'s dry run is a CPU mesh). The
batch is split over the processes and the step's sums and gradient average
span them (``utils/dist.py``). It raises rather than run on fewer.

    python -m oadp_torch.entry [n]               # the NCCL dry run on n cards
                                                 # (default: every card),
                                                 # then entry() on the card
    python -m oadp_torch.entry [n] --device cpu  # the gloo dry run alone
                                                 # (default n: 8)
"""

__all__ = ['entry', 'dryrun_multichip']

import argparse
import os

import numpy as np
import torch

PAD, BATCH, K_PAD = 256, 16, 13


def _example_inputs(grid: int, pad: int = PAD, batch: int = BATCH, seed: int = 0):
    """``(image (pad, pad, 3) uint8, meta (batch, 9), masks (batch, grid,
    grid))`` drawn as ``__graft_entry__.entry`` draws them."""
    from .ops import preprocess as P

    rng = np.random.default_rng(seed)
    image = rng.integers(0, 256, (pad, pad, 3), np.uint8)
    sides = rng.uniform(32, 250, batch)
    x0 = rng.uniform(0, pad - 32, batch)
    y0 = rng.uniform(0, pad - 32, batch)
    boxes = np.stack([x0, y0, x0 + sides, y0 + sides], -1)
    meta = P.clip_transform_meta(pad, pad, boxes)
    masks = (rng.random((batch, grid, grid)) > 0.5).astype(np.float32)
    return image, meta, masks


def entry():
    """(fn, example_args): the OAKE-objects forward step on the card
    (``OakeSteps.objects_step``, the objects CLI's own), random ViT-B/32
    weights (seed 0) in bf16; ``fn(*args)`` gives ``(16, 512)`` unit
    embeddings."""
    from .oake.encoders import OakeSteps, load_clip

    model = load_clip(None, 'bfloat16', device='cuda')
    image, meta, masks = _example_inputs(model.grid)
    return OakeSteps(model, PAD, PAD).objects_step, (image, meta, masks, K_PAD)


def _mini_detector_config():
    """``__graft_entry__._mini_detector_config``: the full head zoo at tiny
    widths (ResNet stages of one block, FPN 16, heads 16/32, embeddings 8)."""
    import dataclasses

    from .models import detector as DET
    from .models import resnet as RN

    cfg = DET.DetectorConfig.build(
        3, 5, rcnn_samples=16, rpn_samples=8, rpn_train_nms_pre=32, rpn_train_max=16,
        rpn_test_nms_pre=32, rpn_test_max=16, rcnn_max_per_img=4)

    def head(h):
        return dataclasses.replace(
            h, in_channels=16, conv_channels=16, fc_channels=32,
            classifier=dataclasses.replace(h.classifier, in_features=32, embedding_dim=8))

    return dataclasses.replace(
        cfg, backbone=RN.ResNetConfig(style='caffe', base_channels=8, blocks=(1, 1, 1, 1)),
        fpn_channels=16, bbox_head=head(cfg.bbox_head), object_head=head(cfg.object_head),
        block_head=head(cfg.block_head),
        global_cls=dataclasses.replace(cfg.global_cls, in_features=16, embedding_dim=8))


def dryrun_multichip(n_devices: int, device: str = 'cuda') -> None:
    """One full OADP train step at mini widths over exactly ``n_devices``
    processes (NCCL, one card a process; gloo with ``device='cpu'``);
    raises if any process fails, if the loss is not finite, or if there are
    fewer cards than processes."""
    from .utils import spawn_ranks

    if device not in ('cpu', 'cuda'):
        raise ValueError(f"device must be 'cpu' or 'cuda', not {device!r}")
    if device == 'cuda' and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f'a {n_devices}-process NCCL dry run needs {n_devices} CUDA '
                           f'devices; torch sees {torch.cuda.device_count()}')
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # each rank ends by end_rank: a normal exit after the step's backward
    # beside a gloo group aborted now and then in the interpreter's teardown
    code = (f'from oadp_torch import entry, utils; entry._dryrun_rank({int(n_devices)}, '
            f'{device!r}); utils.end_rank()')
    spawn_ranks(n_devices, ['-c', code], repo, env=dict(
        OMP_NUM_THREADS='1',
        PYTHONPATH=os.pathsep.join(filter(None, [repo, os.environ.get('PYTHONPATH')]))))


def _dryrun_rank(n_devices: int, device: str) -> None:
    """One process of :func:`dryrun_multichip`: its two images of the global
    batch of ``2 * n_devices``, the step, and the checks."""
    import torch.distributed as dist

    from .dp.builder import canvas_anchors
    from .dp.synthetic import make_embeddings, make_train_batch, make_train_step
    from .dp.trainer import _leaves, _lr_mult_tree, sgd_init, trainable_mask_tree
    from .models import detector as DET
    from .models.clip import map_params
    from .utils import Collective, maybe_initialize_distributed, rank, world_size

    dev = torch.device(device)
    if not maybe_initialize_distributed(dev):  # one process: a group of one all the same
        if dev.type == 'cuda':
            torch.cuda.set_device(0)
        dist.init_process_group('nccl' if dev.type == 'cuda' else 'gloo')
    if world_size() != n_devices:
        raise RuntimeError(f'the dry run must span {n_devices} processes, not {world_size()}')
    if dev.type == 'cuda':
        dev = torch.device('cuda', torch.cuda.current_device())
    config = _mini_detector_config()
    canvas = 64
    params, stats = DET.init_detector(torch.Generator().manual_seed(0), config,
                                      torch.from_numpy(make_embeddings(5, 8)))
    params, stats = (map_params(tree, lambda t: t.to(dev)) for tree in (params, stats))
    anchors = canvas_anchors(config, (canvas, canvas), dev)
    step = make_train_step(config, anchors, _lr_mult_tree(params, {'bbox_head': 0.5}),
                           trainable_mask_tree(params, config), coll=Collective.of_run())
    b = 2 * n_devices
    batch = make_train_batch(b, (canvas, canvas), num_bases=3, num_all=5, emb_dim=8, n_gt=4,
                             n_blocks=6, n_objects=8, n_gt_valid=3)
    local = {k: torch.from_numpy(v[2 * rank():2 * rank() + 2]).to(dev) for k, v in batch.items()}
    local['images'] = DET.ingest_images(local['images'])
    draws = DET.make_draws(torch.Generator(device=dev).manual_seed(rank()), config, 2,
                           sum(len(a) for a in anchors), 4)
    params, stats, _, total = step(params, stats, sgd_init(params), local, 100, draws)
    total = total.detach().reshape(1).clone()
    dist.all_reduce(total)
    if not torch.isfinite(total).all():
        raise AssertionError(f'dry run: loss {float(total)}')
    # every process ends the step with the same params
    digest = torch.stack([t.double().sum() for t in _leaves(params)])
    digests = [torch.empty_like(digest) for _ in range(n_devices)]
    dist.all_gather(digests, digest)
    if not all(torch.equal(d, digests[0]) for d in digests):
        raise AssertionError('dry run: the processes hold different params after the step')
    if rank() == 0:
        print(f'dryrun ok ({n_devices} processes, {device}): loss {float(total):.4f}',
              flush=True)
    dist.destroy_process_group()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog='python -m oadp_torch.entry', description=(
        'the dry run of one train step over n processes, then entry() on the card'))
    p.add_argument('n', nargs='?', type=int,
                   help='processes (default: every card; 8 with --device cpu)')
    p.add_argument('--device', choices=('cuda', 'cpu'), default='cuda',
                   help="'cpu': the dry run on gloo processes alone (entry() needs a card)")
    args = p.parse_args(argv)
    if args.device == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for the gloo dry run")
    n = args.n or (torch.cuda.device_count() if args.device == 'cuda' else 8)
    dryrun_multichip(n, args.device)
    backend = 'NCCL' if args.device == 'cuda' else 'gloo'
    print(f'dryrun ok ({n}-process {backend} data-parallel step)', flush=True)
    if args.device == 'cpu':
        return
    fn, example = entry()
    out = fn(*example)
    if out.shape != (BATCH, 512) or not torch.isfinite(out).all():
        raise AssertionError(f'entry: {tuple(out.shape)} embeddings, finite: '
                             f'{bool(torch.isfinite(out).all())}')
    print('entry ok:', tuple(out.shape), flush=True)


if __name__ == '__main__':
    main()
