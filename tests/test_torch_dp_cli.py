"""``python -m oadp_torch.dp.test`` against ``python -m oadp_tpu.dp.test``
on the same synthetic data and the same mmdet-layout checkpoint
(``chip_smoke.mmdet_state_dict`` at small widths, as ``model.pretrained``),
``DRY_RUN=1``, on the CPU: the same metrics dict and the same DUMP records.
Also the CLI's refusal of the default card where there is none, and a
checkpoint of the port's trainer read in place of ``model.pretrained``."""

import json
import pathlib

import numpy as np
import pytest
import torch

from oadp_torch.utils import load_pth

torch.set_num_threads(1)

CFG = """
categories = 'coco'
model = dict(
    prompts={vild!r},
    ml_prompts={ml!r},
    pretrained={ckpt!r},
    backbone_style='caffe',
    sizes=dict(base_channels=8, fpn_channels=16, fc_channels=32, embedding_dim=32),
    overrides=dict(rpn_test_nms_pre=64, rpn_test_max=32, rcnn_max_per_img=16),
)
validator = dict(
    dataloader=dict(
        samples_per_gpu=1,
        dataset=dict(ann_file={ann!r}, img_prefix={img!r}),
        batch=dict(canvas=(192, 256), scale=(240, 144)),
    ),
)
"""
CPU = ['--override', ".model.device:'cpu'"]
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope='module')
def workspace(tmp_path_factory):
    import chip_smoke
    from tests.synthetic_data import make_synthetic_dp

    root = tmp_path_factory.mktemp('dp_cli')
    data = make_synthetic_dp(root)
    ckpt = root / 'mmdet.pth'
    torch.save({'state_dict': chip_smoke.mmdet_state_dict(seed=1, base=8, fpn=16, fc=32,
                                                          emb=32)}, ckpt)
    cfg = root / 'config.py'
    cfg.write_text(CFG.format(
        vild=str(pathlib.Path(data['prompts']) / 'vild.pth'),
        ml=str(pathlib.Path(data['prompts']) / 'ml.pth'),
        ckpt=str(ckpt), ann=data['ann_file'], img=data['root']))
    return root, cfg


@pytest.fixture()
def dry_run(workspace, monkeypatch):
    monkeypatch.chdir(workspace[0])
    monkeypatch.setenv('DRY_RUN', '1')
    monkeypatch.setenv('JAX_DISABLE_COMPILATION_CACHE', '1')
    return workspace


@pytest.fixture(scope='module')
def runs(workspace):
    """Both CLIs, metrics and DUMP mode, once for the module."""
    from oadp_torch.dp import test as ttest
    from oadp_tpu.dp import test as jtest

    root, cfg = workspace
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        mp.setenv('DRY_RUN', '1')
        mp.setenv('JAX_DISABLE_COMPILATION_CACHE', '1')
        out['jax'] = jtest.main([str(cfg), 'none'])
        out['torch'] = ttest.main([str(cfg), 'none', *CPU])
        for name, main, extra in (('jax', jtest.main, []), ('torch', ttest.main, CPU)):
            mp.setenv('DUMP', str(root / f'dump_{name}'))
            out[f'{name}_dump'] = main([str(cfg), 'none', *extra])
    return root, out


def test_metrics_equal_oadp_tpu(runs):
    _, out = runs
    want, got = out['jax'], out['torch']
    assert 'COCO_48_17_bbox_mAP_50' in got
    assert set(got) == set(want)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= 1e-6, (k, got[k], want[k])


def test_dump_records_equal_oadp_tpu(runs):
    root, out = runs
    assert out['jax_dump'] == out['torch_dump'] == {}
    want = sorted((root / 'dump_jax').glob('*.pth'))
    got = sorted((root / 'dump_torch').glob('*.pth'))
    assert [p.name for p in got] == [p.name for p in want] and len(got) == 3
    for g, w in zip(got, want):
        rg, rw = load_pth(g), load_pth(w)
        assert set(rg) == set(rw) == {'bboxes', 'bbox_logits', 'object_logits', 'objectness'}
        for k in rw:
            a, b = np.asarray(rg[k]), np.asarray(rw[k])
            assert a.dtype == b.dtype == np.float16 and a.shape == b.shape, k
            # fp16 records of fp32 values that differ by ~1e-5: equal up
            # to an fp16 rounding step
            np.testing.assert_allclose(a.astype(np.float32), b.astype(np.float32),
                                       rtol=2 ** -10, atol=1e-4, err_msg=k)


def test_cuda_default_without_card_raises(dry_run):
    from oadp_torch.dp import test as ttest

    _, cfg = dry_run
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default device runs')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        ttest.main([str(cfg), 'none'])


def _save_checkpoint(cfg: pathlib.Path, work: pathlib.Path) -> pathlib.Path:
    """A checkpoint written by ``Trainer.save`` with the params and
    statistics that ``model.pretrained`` gives; returns its ``latest.txt``."""
    from oadp_torch.base import Globals, coco
    from oadp_torch.dp.builder import build_detector
    from oadp_torch.dp.trainer import Trainer, TrainState, sgd_init
    from oadp_torch.utils import Config

    Globals.categories = coco
    bundle = build_detector(Config.load(cfg).model, coco)
    work.mkdir(parents=True, exist_ok=True)
    Trainer(bundle, Config(), None, work, device='cpu').save(
        TrainState(bundle.params, bundle.stats, sgd_init(bundle.params), 5))
    assert (work / 'ckpt_5.pth').exists()
    return work / 'latest.txt'


def test_trained_checkpoint_read_like_pretrained(runs, dry_run, monkeypatch):
    """A checkpoint of the port's trainer with the params and statistics
    that ``model.pretrained`` gives, read through ``latest.txt`` with no
    ``model.pretrained``: the same metrics as the ``none`` run, and the same
    DUMP records bit for bit (the metrics of random weights are 0 whatever
    the weights)."""
    from oadp_torch.dp import test as ttest

    _, out = runs
    root, cfg = dry_run
    work = _save_checkpoint(cfg, root / 'work_dirs' / 'saved').parent
    # the config's own weights are random: only the checkpoint's can match
    got = ttest.main([str(cfg), str(work / 'latest.txt'), *CPU, '.model.pretrained:None'])
    want = out['torch']
    assert set(got) == set(want) and 'COCO_48_17_bbox_mAP_50' in got
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= 1e-9, (k, got[k], want[k])
    monkeypatch.setenv('DUMP', str(root / 'dump_ckpt'))
    assert ttest.main([str(cfg), str(work / 'latest.txt'), *CPU, '.model.pretrained:None']) == {}
    want = sorted((root / 'dump_torch').glob('*.pth'))
    got = sorted((root / 'dump_ckpt').glob('*.pth'))
    assert [p.name for p in got] == [p.name for p in want] and len(got) == 3
    for g, w in zip(got, want):
        rg, rw = load_pth(g), load_pth(w)
        for k in rw:
            np.testing.assert_array_equal(np.asarray(rg[k]), np.asarray(rw[k]), err_msg=k)


def _two_processes(root: pathlib.Path, argv: list[str], *overrides: str, **env) -> dict:
    """Two gloo processes of ``python -m oadp_torch.dp.test`` (torchrun's
    environment); returns rank 0's metrics dict."""
    from oadp_torch.utils import spawn_ranks

    code = ('import json, sys; from oadp_torch.dp import test; '
            'print("METRICS " + json.dumps(test.main(sys.argv[1:])))')
    outs = spawn_ranks(2, ['-c', code, *argv, *CPU, *overrides], root, timeout=300, env=dict(
        PYTHONPATH=str(REPO), OMP_NUM_THREADS='1', DRY_RUN='1', **env))
    lines = [[ln for ln in out.splitlines() if ln.startswith('METRICS ')] for out in outs]
    assert all(len(x) == 1 for x in lines), outs
    assert json.loads(lines[1][0][8:]) == {}  # rank 1 returns nothing: rank 0 evaluates
    return json.loads(lines[0][0][8:])


def test_two_processes_equal_one_process(runs, dry_run):
    """``dp.test`` over two gloo processes (each loads its share of the 3
    images, the second's last batch a padded repeat): rank 0 merges every
    rank's detections through the checkpoint's directory after
    ``torch.distributed.barrier`` and gives the one-process metrics; in DUMP
    mode the two ranks' records together are the one-process DUMP."""
    _, out = runs
    root, cfg = dry_run
    ckpt = _save_checkpoint(cfg, root / 'work_dirs' / 'saved_2p')
    got = _two_processes(root, [str(cfg), str(ckpt)], '.model.pretrained:None')
    want = out['torch']
    assert set(got) == set(want) and 'COCO_48_17_bbox_mAP_50' in got
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= 1e-9, (k, got[k], want[k])
    assert not list((ckpt.parent / 'eval_gather').glob('*.pkl'))  # rank 0 removed the parts
    assert _two_processes(root, [str(cfg), 'none'], DUMP=str(root / 'dump_2p')) == {}
    want = sorted((root / 'dump_torch').glob('*.pth'))
    got = sorted((root / 'dump_2p').glob('*.pth'))
    assert [p.name for p in got] == [p.name for p in want] and len(got) == 3
    for g, w in zip(got, want):
        rg, rw = load_pth(g), load_pth(w)
        assert set(rg) == set(rw)
        for k in rw:
            np.testing.assert_array_equal(np.asarray(rg[k]), np.asarray(rw[k]), err_msg=k)
