"""``python -m oadp_torch.dp.train`` on the CPU, on ``tests/synthetic_data.py``
data at the small widths of ``tests/test_dp_e2e.py``, ``DRY_RUN=1``: the same
log keys as ``python -m oadp_tpu.dp.train`` and a checkpoint written;
``resume_from``; ``TRAIN_WITH_VAL_DATASET``; a 2-process gloo run whose
first step's gradients, params and batch-norm statistics equal one
process's step on the concatenated batch (with the same draws), then
``dp.test`` on its checkpoint; on a host with several cards (``cuda``
marker), one NCCL process a card against one card's step."""

import importlib.util
import json
import os
import pathlib
import re

import numpy as np
import pytest
import torch

from oadp_torch.utils import Config

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = ".model.device:'cpu'"


def _sibling(name: str):
    """A module of this directory, loaded by path: on a host where an
    installed package is also called ``tests``, ``import tests.x`` finds
    that one (this directory has no ``__init__.py``)."""
    spec = importlib.util.spec_from_file_location(f'_{name}', pathlib.Path(__file__).with_name(
        f'{name}.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope='module')
def workspace(tmp_path_factory):
    make_synthetic_dp = _sibling('synthetic_data').make_synthetic_dp
    CFG_TEMPLATE = _sibling('test_dp_e2e').CFG_TEMPLATE

    # no 'train' in the path: TRAIN_WITH_VAL_DATASET rewrites it
    root = tmp_path_factory.mktemp('dpt')
    data = make_synthetic_dp(root)
    cfg = root / 'config.py'
    cfg.write_text(CFG_TEMPLATE.format(
        vild=str(pathlib.Path(data['prompts']) / 'vild.pth'),
        ml=str(pathlib.Path(data['prompts']) / 'ml.pth'),
        ann=data['ann_file'], img=data['root'], oake=data['oake_root']))
    return root, cfg


@pytest.fixture()
def dry_run(workspace, monkeypatch):
    monkeypatch.chdir(workspace[0])
    monkeypatch.setenv('DRY_RUN', '1')
    monkeypatch.setenv('JAX_DISABLE_COMPILATION_CACHE', '1')
    return workspace


def _log_keys(log: str) -> tuple[int, set[str]]:
    """The iterations and the metric names of the ``iter`` log lines."""
    lines = [ln for ln in log.splitlines() if re.search(r'iter \d+/\d+ lr', ln)]
    keys = set()
    for ln in lines:
        inner = ln[ln.index('(') + 1:ln.index(')')].split()
        keys |= set(inner[0::2])
    return len(lines), keys


@pytest.fixture(scope='module')
def port_run(workspace):
    """The port's CLI for 7 iterations: checkpoints at 6 and 7, in-train
    evaluations at 3 and 6."""
    from oadp_torch.dp import train as ttrain

    root, cfg = workspace
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        mp.setenv('DRY_RUN', '1')
        state = ttrain.main(['e2e', str(cfg), '--override', CPU, '.trainer.runner.max_iters:7'])
    return root / 'work_dirs' / 'dry_run' / 'e2e', state


def test_train_cli_same_log_keys_as_oadp_tpu(port_run, dry_run):
    from oadp_tpu.dp import train as jtrain

    work, state = port_run
    root, cfg = dry_run
    jtrain.main(['e2e_jax', str(cfg), '--override', '.trainer.runner.max_iters:1'])
    _, want = _log_keys((root / 'work_dirs/dry_run/e2e_jax/train.log').read_text())
    log = (work / 'train.log').read_text()
    n, got = _log_keys(log)
    assert n == 7 and 'iter 7/7' in log
    assert got == want and {'loss_rpn_cls', 'loss_cls', 'loss_clip_objects', 'loss_block',
                            'loss_global', 'loss_clip_global', 'recall_block', 'acc'} <= got
    assert log.count('eval @') == 2  # in-train evaluations at 3 and 6
    assert (work / 'config.py').exists()
    latest = pathlib.Path((work / 'latest.txt').read_text().strip())
    assert latest == (work / 'ckpt_7.pth').absolute() and (work / 'ckpt_6.pth').exists()
    meta = json.loads((work / 'ckpt_7.meta.json').read_text())
    assert meta['step'] == 7 and len(meta['classes']) == 65 and meta['oadp_torch_version']
    ckpt = torch.load(latest, weights_only=False)
    assert ckpt['step'] == state.step == 7
    for k, v in zip(ckpt['win_keys'], ckpt['win'].tolist()):
        assert np.isfinite(v), k


def test_resume_from(port_run, dry_run):
    from oadp_torch.dp import train as ttrain

    work, _ = port_run
    root, cfg = dry_run
    state = ttrain.main(['e2e_resumed', str(cfg), '--override', CPU,
                         '.trainer.runner.max_iters:9',
                         f".trainer.resume_from:'{work / 'ckpt_6.pth'}'"])
    log = (root / 'work_dirs/dry_run/e2e_resumed/train.log').read_text()
    assert 'resumed from' in log and 'iter 7/9' in log and 'iter 9/9' in log
    assert 'iter 6/9' not in log
    assert state.step == 9


def test_train_with_val_dataset(dry_run, monkeypatch):
    from oadp_torch.dp import train as ttrain

    root, cfg = dry_run
    monkeypatch.setenv('TRAIN_WITH_VAL_DATASET', '1')
    state = ttrain.main(['e2e_twv', str(cfg), '--override', CPU, '.trainer.runner.max_iters:1'])
    assert 'iter 1/1' in (root / 'work_dirs/dry_run/e2e_twv/train.log').read_text()
    assert state.step == 1


def test_cuda_default_without_card_raises(dry_run):
    from oadp_torch.dp import train as ttrain

    _, cfg = dry_run
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default device runs')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        ttrain.main(['e2e_card', str(cfg)])


# ---------------------------------------------------------------------------
# two processes (gloo)
# ---------------------------------------------------------------------------


def _run_ranks(root: pathlib.Path, cfg: pathlib.Path, world: int, device: str,
               overrides: tuple[str, ...] = (), tag: str = '') -> pathlib.Path:
    """``world`` processes of ``python -m oadp_torch.dp.train`` for one
    iteration in fp32 (torchrun's environment; gloo on the CPU, NCCL on
    cards, TF32 off), with ``overrides`` of the config; returns the run's
    work dir."""
    from oadp_torch.utils import spawn_ranks

    name = f'ddp_{device}{tag}'
    spawn_ranks(world, ['-m', 'oadp_torch.dp.train', name, str(cfg), '--override',
                        f".model.device:'{device}'", '.trainer.runner.max_iters:1',
                        '.trainer.bf16:False', *overrides], root, timeout=300,
                env=dict(PYTHONPATH=str(REPO), OMP_NUM_THREADS='1', NVIDIA_TF32_OVERRIDE='0'))
    work = root / 'work_dirs' / 'dry_run' / name
    assert (work / 'train.log').exists() and (work / f'train.rank{world - 1}.log').exists()
    assert f'{world} process(es)' in (work / 'train.log').read_text()
    return work


def _one_process_step(cfg_path: pathlib.Path, world: int, device: str = 'cpu',
                      overrides: dict | None = None):
    """The first step of a ``world``-process run, in this process: the
    ranks' first batches concatenated, each rank's draws from its own
    generator, ``loss_clip_global`` divided by ``world``."""
    from oadp_torch.base import Globals, coco
    from oadp_torch.dp import train as ttrain
    from oadp_torch.dp.builder import build_detector, canvas_anchors
    from oadp_torch.dp.datasets import batch_canvas
    from oadp_torch.dp.trainer import (
        Trainer, _lr_mult_tree, build_train_step, sgd_init, trainable_mask_tree,
    )
    from oadp_torch.models import detector as DET

    config = Config.load(cfg_path)
    config.override({'.model.device': device, **(overrides or {})})
    config.trainer.dataloader['samples_per_gpu'] = 1
    Globals.categories = coco
    bundle = build_detector(config.model, coco, seed=config.trainer.seed).to(torch.device(device))
    batches, draws = [], []
    for r in range(world):
        os.environ.update(RANK=str(r), WORLD_SIZE=str(world))
        try:
            loader = ttrain.build_train_loader(config, coco, config.model)
            batches.append(next(iter(loader.epoch(0))))
        finally:
            del os.environ['RANK'], os.environ['WORLD_SIZE']
    trainer = Trainer(bundle, config.trainer, None, '.', device=device)
    anchors = canvas_anchors(bundle.config, batch_canvas(batches[0]), device)
    for r in range(world):
        gen = torch.Generator(device=device).manual_seed(trainer.seed + r)
        draws.append(DET.make_draws(gen, bundle.config, 1, sum(len(a) for a in anchors),
                                    batches[0]['gt_boxes'].shape[1]))
    batch = {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}
    step_fn = build_train_step(
        bundle.config, anchors, _lr_mult_tree(bundle.params, trainer.lr_rules),
        trainable_mask_tree(bundle.params, bundle.config), base_lr=trainer.base_lr,
        milestones=trainer.milestones, momentum=trainer.momentum,
        weight_decay=trainer.weight_decay, warmup_iters=trainer.warmup_iters,
        warmup_ratio=trainer.warmup_ratio, world=world)
    params, stats, bufs, _ = step_fn(
        bundle.params, bundle.stats, sgd_init(bundle.params), trainer.device_batch(batch), 0,
        {k: torch.cat([d[k] for d in draws]) for k in draws[0]})
    return params, stats, bufs


def _check_first_step(work: pathlib.Path, cfg: pathlib.Path, world: int, device: str,
                      overrides: dict | None = None):
    """The run's step-1 checkpoint against one process's step: after one
    step the momentum buffers are the gradients (+ weight decay), so the
    averaged gradient is held to the one-process gradient."""
    from oadp_torch.dp.trainer import Trainer, _leaves

    got = Trainer.restore(work / 'latest.txt')
    assert got.step == 1
    params, stats, bufs = _one_process_step(cfg, world, device, overrides)
    n_moved = 0
    for g, w in zip(_leaves(got.bufs), _leaves(bufs)):
        scale = float(w.abs().max())
        np.testing.assert_allclose(g.numpy(), w.cpu().numpy(), atol=1e-4 * scale + 1e-9, rtol=0)
        n_moved += scale > 0
    assert n_moved > 50
    for g, w in zip(_leaves(got.params), _leaves(params)):
        np.testing.assert_allclose(g.numpy(), w.detach().cpu().numpy(), atol=1e-6, rtol=1e-6)
    for g, w in zip(_leaves(got.stats), _leaves(stats)):
        np.testing.assert_allclose(g.numpy(), w.cpu().numpy(), atol=1e-6, rtol=1e-5)


def test_two_process_step_equals_one_process_step(dry_run):
    """Two gloo processes, then ``dp.test`` on their checkpoint."""
    from oadp_torch.dp import test as ttest

    root, cfg = dry_run
    work = _run_ranks(root, cfg, 2, 'cpu')
    _check_first_step(work, cfg, 2, 'cpu')
    metrics = ttest.main([str(cfg), str(work / 'latest.txt'), '--override', CPU])
    assert 'COCO_48_17_bbox_mAP_50' in metrics


def test_two_process_step_backbone_bn_train(dry_run):
    """The same with ``model.backbone.norm_eval=False``: every backbone
    batch norm (the frozen stages' too) takes the global batch's statistics,
    so both ranks' new backbone statistics equal one process's on the
    concatenated batch, and they moved."""
    from oadp_torch.dp.trainer import Trainer, _leaves
    from oadp_torch.utils import Config

    root, cfg = dry_run
    work = _run_ranks(root, cfg, 2, 'cpu', ('.model.backbone.norm_eval:False',), '_bn_train')
    _check_first_step(work, cfg, 2, 'cpu', {'.model.backbone.norm_eval': False})
    from oadp_torch.base import coco
    from oadp_torch.dp.builder import build_detector

    config = Config.load(cfg)
    config.override({'.model.device': 'cpu'})
    before = build_detector(config.model, coco, seed=config.trainer.seed).stats['backbone']
    after = Trainer.restore(work / 'latest.txt').stats['backbone']
    assert all(not torch.equal(a, b) for a, b in zip(_leaves(before), _leaves(after)))


@pytest.mark.cuda
def test_card_processes_step_equals_one_card_step(dry_run):
    """One NCCL process a card (every card of the host), fp32 with TF32 off,
    against one card's step on the concatenated batch."""
    if torch.cuda.device_count() < 2:
        pytest.skip('needs two or more CUDA devices')
    root, cfg = dry_run
    world = torch.cuda.device_count()
    work = _run_ranks(root, cfg, world, 'cuda')
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        _check_first_step(work, cfg, world, 'cuda')
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn
