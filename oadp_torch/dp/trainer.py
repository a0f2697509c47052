"""DP training runtime: torch-SGD, the schedule, the train step, the loop
with its hooks, and checkpoints (port of ``oadp_tpu/dp/trainer.py``).

* torch-SGD semantics (``buf = m * buf + (g + wd * p); p -= lr * mult *
  buf``) with per-path lr multipliers (``configs/dp/oadp_ov_coco.py``:
  ``bbox_head`` 0.5); the leaves that take no gradient (the frozen stem and
  stage 1, the text embeddings, the object head's background) take neither
  weight decay nor momentum, as ``torch.optim.SGD`` skips a parameter whose
  grad is None (:func:`trainable_mask_tree`);
* linear warm-up over 500 iterations from 0.001, then step decay
  (``configs/dp/schedules/base.py``), milestones by iteration or by epoch;
* the step (:func:`build_train_step`): every loss of
  :func:`models.detector.forward_train` summed, with ``loss_clip_global``
  divided by the world size (the reference's DDP averages the gradient of
  a loss that each rank sums), gradients by autograd, averaged over the
  processes of a data-parallel run, then the update;
* bf16 activations with fp32 parameters and losses (``oadp_tpu``'s
  replacement for mmcv fp16 with loss scaling, ``configs/dp/base.py:9``).

:class:`Trainer` runs iteration- or epoch-based schedules with log,
checkpoint and eval hooks. The sampler's draws come from one
``torch.Generator`` on the device, seeded by the config's seed and the
rank. The metrics of a log window are summed on the device and read once
per window. Checkpoints are ``torch.save`` files of the port's own
(``ckpt_<step>.pth``: params, BN stats, momentum buffers, step, every
process's generator state and the metric window) with a ``.meta.json`` beside them
and ``latest.txt`` naming the newest; a resume continues the same draw
stream and the loader at the same batch.
"""

__all__ = [
    'TrainState', 'Trainer', 'build_train_step', 'sgd_init', 'sgd_update', 'lr_at',
    'trainable_mask_tree',
]

import dataclasses
import json
import pathlib
import time
from typing import Any, Callable

import numpy as np
import torch

from ..models import detector as DET
from ..models.clip import map_params
from ..oake.encoders import resolve_device
from ..utils import Collective, Config, logger, rank, world_size
from . import datasets
from .builder import DetectorBundle, canvas_anchors

Params = dict[str, Any]


def _leaves(tree) -> list:
    """The leaves of a parameter tree in a fixed order (None kept)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _like(tree, leaves: list):
    """``leaves`` (in :func:`_leaves` order) in the structure of ``tree``."""
    it = iter(leaves)
    return map_params(tree, lambda _: next(it))


def sgd_init(params: Params) -> Params:
    return map_params(params, torch.zeros_like)


def lr_at(
    step: int,
    base_lr: float,
    milestones: tuple,
    warmup_iters: int = 500,
    warmup_ratio: float = 0.001,
    gamma: float = 0.1,
) -> float:
    """mmcv's ``StepLrUpdater`` with linear warm-up, in fp32 arithmetic as
    ``oadp_tpu`` computes it."""
    f32 = np.float32
    frac = np.clip(f32(step) / f32(max(warmup_iters, 1)), f32(0), f32(1))
    warm = f32(warmup_ratio) + (f32(1) - f32(warmup_ratio)) * frac
    decay = f32(1)
    for m in milestones:
        decay = decay * (f32(gamma) if step >= m else f32(1))
    return float(f32(base_lr) * warm * decay)


def _lr_mult_tree(params: Params, rules: dict[str, float]) -> Params:
    """Per-leaf lr multipliers by top-level path prefix (mmdet
    ``paramwise_cfg.custom_keys``)."""

    def mult_for(path: str) -> float:
        for key, mult in rules.items():
            if path.startswith(key):
                return mult
        return 1.0

    return {k: map_params(v, lambda _, m=mult_for(k): m) for k, v in params.items()}


def trainable_mask_tree(params: Params, config) -> Params:
    """Per-leaf trainable flags: False for the leaves that the model
    detaches (the frozen backbone stages, the text embeddings of every
    classifier, a ``freeze_bg`` background). ``config`` is a
    :class:`~oadp_torch.models.detector.DetectorConfig`."""

    def full(tree, val):
        return map_params(tree, lambda _: val)

    mask = {k: full(v, True) for k, v in params.items()}
    fs = config.backbone.frozen_stages
    if fs >= 0:
        mask['backbone']['stem'] = full(params['backbone']['stem'], False)
    for i in range(1, 5):
        name = f'layer{i}'
        if fs >= i and name in params['backbone']:
            mask['backbone'][name] = full(params['backbone'][name], False)
    heads = [('bbox_head', config.bbox_head.classifier),
             ('object_head', config.object_head.classifier),
             ('block_head', config.block_head.classifier),
             ('global_head', config.global_cls)]
    for head, cls_cfg in heads:
        if head not in params:
            continue
        cls = params[head]['cls']
        mask[head]['cls']['embeddings'] = False
        if cls_cfg.freeze_bg and 'bg' in cls:
            mask[head]['cls']['bg'] = False
    return mask


@torch.no_grad()
def sgd_update(
    params: Params,
    grads: Params,
    bufs: Params,
    lr: float,
    lr_mults: Params,
    momentum: float = 0.9,
    weight_decay: float = 2.5e-5,
    trainable: Params | None = None,
) -> tuple[Params, Params]:
    """torch.optim.SGD, in place on ``params`` and ``bufs``:
    ``buf = m * buf + (g + wd * p); p -= lr * mult * buf``. Leaves marked
    False in ``trainable`` are left alone; a trainable leaf without a
    gradient (None) is updated as with a zero one, as ``oadp_tpu`` updates
    it. Returns ``(params, bufs)``."""
    flags = _leaves(trainable) if trainable is not None else None
    groups: dict[float, tuple[list, list, list]] = {}
    for i, (p, g, b, m) in enumerate(zip(_leaves(params), _leaves(grads), _leaves(bufs),
                                         _leaves(lr_mults))):
        if flags is not None and not flags[i]:
            continue
        ps, gs, bs = groups.setdefault(m, ([], [], []))
        ps.append(p)
        gs.append(torch.zeros_like(p) if g is None else g.float())
        bs.append(b)
    for m, (ps, gs, bs) in groups.items():
        gs = torch._foreach_add(gs, ps, alpha=weight_decay)
        torch._foreach_mul_(bs, momentum)
        torch._foreach_add_(bs, gs)
        torch._foreach_add_(ps, bs, alpha=-lr * m)
    return params, bufs


def _gradients(objective: torch.Tensor, leaves: list[torch.Tensor]) -> list:
    """The backward pass: d objective / d leaf (zeros where unused, so that
    every process averages the same list of tensors)."""
    return list(torch.autograd.grad(objective, leaves, allow_unused=True,
                                    materialize_grads=True))


def build_train_step(
    config,
    anchors: list[torch.Tensor],
    lr_mults: Params,
    trainable: Params,
    base_lr: float = 0.02,
    milestones: tuple = (30000,),
    momentum: float = 0.9,
    weight_decay: float = 2.5e-5,
    warmup_iters: int = 500,
    warmup_ratio: float = 0.001,
    world: int | None = None,
    coll: Collective = Collective(),
) -> Callable:
    """THE train step: all losses, autograd, the gradients averaged over
    ``coll``'s processes, and the torch-SGD update (in place).

    ``step_fn(params, stats, bufs, batch, step, draws) -> (params, new_stats,
    bufs, losses)``; ``losses`` holds each loss's detached share (summed
    over the processes it is the global value), ``total`` and ``lr``.
    ``world`` divides ``loss_clip_global`` (default: ``coll``'s world size;
    a single process that stands for a run of several passes theirs).
    Each process's objective is its share of the total times the world
    size, so that the average of the gradients is the gradient of the
    total."""
    world = coll.world if world is None else world
    flags = _leaves(trainable)

    def step_fn(params, stats, bufs, batch, step: int, draws):
        leaves = [p for p, t in zip(_leaves(params), flags) if t]
        with torch.enable_grad():
            for p in leaves:
                p.requires_grad_(True)
            losses, new_stats = DET.forward_train(params, stats, batch, config, anchors, step,
                                                  draws, coll)
            if 'loss_clip_global' in losses:
                losses['loss_clip_global'] = losses['loss_clip_global'] / world
            total = sum(v for k, v in losses.items() if k.startswith('loss'))
            grads = _gradients(total * coll.world, leaves)
        coll.average(grads)
        it = iter(grads)
        grad_tree = _like(params, [next(it) if t else None for t in flags])
        lr = lr_at(step, base_lr, milestones, warmup_iters, warmup_ratio)
        sgd_update(params, grad_tree, bufs, lr, lr_mults, momentum, weight_decay, trainable)
        out = {k: v.detach() for k, v in losses.items()}
        out['total'] = total.detach()
        out['lr'] = lr
        return params, new_stats, bufs, out

    return step_fn


@dataclasses.dataclass
class TrainState:
    params: Params
    stats: Params
    bufs: Params
    step: int
    # deterministic resume: this process's generator state and the
    # cumulative metric window (None on a fresh start)
    generator_state: torch.Tensor | None = None
    win: torch.Tensor | None = None


class Trainer:
    """Iteration- or epoch-based training with log, checkpoint and eval
    hooks, on ``device`` (the card unless the caller asks for the CPU; the
    bundle is moved there); with a process group, one data-parallel process
    of the run (its loader holds its share of each global batch)."""

    def __init__(
        self,
        bundle: DetectorBundle,
        trainer_cfg: Config,
        train_loader,
        work_dir,
        evaluator=None,
        bf16: bool = False,
        device: torch.device | str = 'cuda',
        coll: Collective | None = None,
    ) -> None:
        self.device = resolve_device(device)
        self.bundle = bundle.to(self.device)
        self.cfg = trainer_cfg
        self.loader = train_loader
        self.work_dir = pathlib.Path(work_dir)
        self.evaluator = evaluator
        self.dtype = torch.bfloat16 if bf16 else torch.float32
        self.coll = coll or Collective.of_run()

        opt = trainer_cfg.get('optimizer', Config())
        self.base_lr = float(opt.get('lr', 0.02))
        self.momentum = float(opt.get('momentum', 0.9))
        self.weight_decay = float(opt.get('weight_decay', 2.5e-5))
        self.lr_rules = {k: float(v.get('lr_mult', 1.0))
                         for k, v in opt.get('paramwise', {}).items()}
        lr_cfg = trainer_cfg.get('lr_config', Config())
        self.milestones = tuple(lr_cfg.get('step', ()))
        self.warmup_iters = int(lr_cfg.get('warmup_iters', 500))
        self.warmup_ratio = float(lr_cfg.get('warmup_ratio', 0.001))
        self.by_epoch = bool(lr_cfg.get('by_epoch', True))

        runner = trainer_cfg.get('runner', Config())
        self.epoch_based = runner.get('type', 'IterBasedRunner') == 'EpochBasedRunner'
        self.max_iters = int(runner.get('max_iters', 0) or 0)
        self.max_epochs = int(runner.get('max_epochs', 0) or 0)
        self.log_interval = int(trainer_cfg.get('log_config', {}).get('interval', 50))
        ckpt = trainer_cfg.get('checkpoint_config', {})
        self.ckpt_interval = int(ckpt.get('interval', 2000))
        self.ckpt_by_epoch = bool(ckpt.get('by_epoch', True))
        # under mmcv's EpochBasedRunner the EvalHook interval counts epochs
        # (configs/dp/schedules/2x.py), under IterBasedRunner iterations
        evaluation = trainer_cfg.get('evaluation', {})
        self.eval_interval = int(evaluation.get('interval', 2000))
        self.eval_by_epoch = bool(evaluation.get('by_epoch', self.epoch_based))
        self.seed = int(trainer_cfg.get('seed', 3407))
        # profile=dict(start=i, stop=j, dir='...'): a torch.profiler trace
        # of iterations [i, j)
        self.profile = trainer_cfg.get('profile')
        self._steps: dict[tuple, tuple[Callable, list[torch.Tensor]]] = {}
        self._keys: list[str] = []  # the metric order of the window vector

    def _milestone_iters(self, epoch_len: int) -> tuple:
        if self.by_epoch and self.epoch_based:
            return tuple(int(m) * epoch_len for m in self.milestones)
        return tuple(int(m) for m in self.milestones)

    def _step_for(self, canvas: tuple, epoch_len: int):
        key = (canvas, epoch_len)
        if key not in self._steps:
            config = self.bundle.config
            anchors = canvas_anchors(config, canvas, self.device)
            self._steps[key] = (build_train_step(
                config, anchors,
                _lr_mult_tree(self.bundle.params, self.lr_rules),
                trainable_mask_tree(self.bundle.params, config),
                base_lr=self.base_lr, milestones=self._milestone_iters(epoch_len),
                momentum=self.momentum, weight_decay=self.weight_decay,
                warmup_iters=self.warmup_iters, warmup_ratio=self.warmup_ratio,
                coll=self.coll,
            ), anchors)
        return self._steps[key]

    def device_batch(self, batch: dict) -> dict[str, torch.Tensor]:
        """A loader batch on the device; the uint8 canvases normalised there
        into ``(B, 3, H, W)`` activations of the run's dtype."""
        out = {k: torch.from_numpy(np.asarray(v)).to(self.device, non_blocking=True)
               for k, v in batch.items() if k not in ('image_ids', 'scale_factor')}
        out['images'] = DET.ingest_images(out['images'], self.dtype)
        return out

    def generator(self, state: torch.Tensor | None = None) -> torch.Generator:
        """The sampler's generator on the device: seeded by the seed and the
        rank, or at ``state``."""
        gen = torch.Generator(device=self.device)
        if state is None:
            gen.manual_seed(self.seed + rank())
        else:
            gen.set_state(state)
        return gen

    def _log(self, step: int, max_iters: int, cum: torch.Tensor, prev: torch.Tensor,
             n: int, lr_sum: float, images: int, seconds: float) -> None:
        avg = dict(zip(self._keys, ((cum - prev) / n).tolist()))
        logger.info('iter %d/%d lr %.2e total %.4f (%s) %.2f img/s', step, max_iters,
                    lr_sum / n, avg.pop('total'),
                    ' '.join(f'{k} {v:.4f}' for k, v in sorted(avg.items())),
                    images / max(seconds, 1e-6))

    def fit(self, resume_state: TrainState | None = None) -> TrainState:
        epoch_len = max(len(self.loader), 1)
        max_iters = self.max_epochs * epoch_len if self.epoch_based else self.max_iters
        state = resume_state or TrainState(self.bundle.params, self.bundle.stats,
                                           sgd_init(self.bundle.params), 0)
        gen = self.generator(state.generator_state)
        win = state.win.to(self.device) if state.win is not None else None
        # the global cumulative window at the last log (read on the host)
        prev = self.coll.sum(win.clone()).cpu() if win is not None else None
        step = state.step
        epoch, skip = divmod(step, epoch_len)
        win_n, lr_sum, n_images, t0 = 0, 0.0, 0, time.time()
        prof = None

        def sync_state():
            state.step, state.generator_state, state.win = step, gen.get_state(), win

        while step < max_iters:
            for batch in self.loader.epoch(epoch, start=skip):
                if step >= max_iters:
                    break
                step_fn, anchors = self._step_for(datasets.batch_canvas(batch), epoch_len)
                if self.profile and step == int(self.profile['start']):
                    prof = _start_profiler(self.device)
                data = self.device_batch(batch)
                draws = DET.make_draws(gen, self.bundle.config, data['images'].shape[0],
                                       sum(len(a) for a in anchors), data['gt_boxes'].shape[1])
                state.params, state.stats, state.bufs, losses = step_fn(
                    state.params, state.stats, state.bufs, data, step, draws)
                lr_sum += losses.pop('lr')
                if not self._keys:
                    self._keys = sorted(losses)
                vec = torch.stack([losses[k].float() for k in self._keys])
                if win is None:
                    win, prev = torch.zeros_like(vec), torch.zeros(len(vec))
                win = win + vec
                step += 1
                win_n += 1
                n_images += data['images'].shape[0] * self.coll.world
                if prof is not None and step == int(self.profile['stop']):
                    _stop_profiler(prof, self.device, pathlib.Path(self.profile['dir']))
                    prof = None
                if step % self.log_interval == 0:
                    cum = self.coll.sum(win.clone()).cpu()  # one read per window
                    self._log(step, max_iters, cum, prev, win_n, lr_sum, n_images,
                              time.time() - t0)
                    prev = cum
                    win_n, lr_sum, n_images, t0 = 0, 0.0, 0, time.time()
                if not self.ckpt_by_epoch and step % self.ckpt_interval == 0:
                    sync_state()
                    self.save(state)
                if (self.evaluator is not None and not self.eval_by_epoch
                        and step % self.eval_interval == 0):
                    logger.info('eval @%d: %s', step,
                                self.evaluator.run(state.params, state.stats))
            skip = 0
            epoch += 1
            if self.ckpt_by_epoch and self.epoch_based and epoch % max(self.ckpt_interval, 1) == 0:
                sync_state()
                self.save(state)
            if (self.evaluator is not None and self.eval_by_epoch
                    and epoch % max(self.eval_interval, 1) == 0):
                logger.info('eval @epoch %d: %s', epoch,
                            self.evaluator.run(state.params, state.stats))
        sync_state()
        self.save(state)
        return state

    # -- checkpoints -----------------------------------------------------------

    def save(self, state: TrainState) -> pathlib.Path:
        """Rank 0 writes ``ckpt_<step>.pth``, its ``.meta.json`` and
        ``latest.txt``; every process returns the checkpoint's path."""
        path = (self.work_dir / f'ckpt_{state.step}.pth').absolute()
        # each process draws from its own generator: keep every one's state
        generator_states = [state.generator_state]
        if self.coll.world > 1:
            generator_states = [None] * self.coll.world
            torch.distributed.all_gather_object(generator_states, state.generator_state)
        if rank() != 0:
            return path
        self.work_dir.mkdir(parents=True, exist_ok=True)

        def cpu(tree):
            return map_params(tree, lambda t: t.detach().cpu())

        torch.save({
            'params': cpu(state.params),
            'stats': cpu(state.stats),
            'bufs': cpu(state.bufs),
            'step': state.step,
            'generator_states': generator_states,
            'win': None if state.win is None else state.win.cpu(),
            'win_keys': list(self._keys),
        }, path)
        import oadp_torch
        from ..base import Globals
        cats = getattr(Globals, 'categories', None)
        path.with_name(f'{path.stem}.meta.json').write_text(json.dumps({
            'oadp_torch_version': oadp_torch.__version__,
            'torch_version': torch.__version__,
            'step': int(state.step),
            'classes': list(cats.all_) if cats is not None else None,
        }))
        (self.work_dir / 'latest.txt').write_text(str(path))
        logger.info('saved checkpoint %s', path)
        return path

    @staticmethod
    def restore(path, device: torch.device | str = 'cpu') -> TrainState:
        """A checkpoint (or ``latest.txt``, which names one) as a
        :class:`TrainState` on ``device``, with this process's generator
        state (on the CPU, as ``Generator.set_state`` takes it). A run of
        another process count starts its draws anew."""
        path = pathlib.Path(path)
        if path.suffix == '.txt':
            path = pathlib.Path(path.read_text().strip())
        ckpt = torch.load(path, map_location='cpu', weights_only=False)

        def put(tree):
            return map_params(tree, lambda t: t.to(device))

        states = ckpt['generator_states']
        if len(states) != world_size():
            logger.warning('checkpoint of %d process(es) resumed by %d: the sampler draws '
                           'start anew', len(states), world_size())
        return TrainState(put(ckpt['params']), put(ckpt['stats']), put(ckpt['bufs']),
                          int(ckpt['step']),
                          states[rank()] if len(states) == world_size() else None,
                          ckpt['win'])


def _start_profiler(device: torch.device):
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_profiler(prof, device: torch.device, out_dir: pathlib.Path) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    prof.stop()
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f'trace_rank{rank()}.json'
    prof.export_chrome_trace(str(path))
    logger.info('profiler trace written to %s', path)
