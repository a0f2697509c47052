"""The calibration trial and sweep of the port (``oadp_torch.dp.test_calibrate``,
``oadp_torch.dp.calibrate_sweep``) against ``oadp_tpu.dp.test_calibrate`` and
``tools/calibrate_sweep.py``, on the CPU: ``_classify`` and ``rescore`` on
random records (identical labels, rows and valid flags, scores within 1e-5
rel), ``CalibrationRunner.run_trial`` and the CLI's JSON line on the DUMP
records of a ``DRY_RUN`` ``oadp_torch.dp.test``, the memory guard, the card
default, the sweep's history for both samplers, and the discrimination case
of ``tests/test_calibration_discrimination.py`` through the port."""

import importlib
import json
import math
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oadp_torch.dp import calibrate_sweep as tsweep
from oadp_torch.dp import test_calibrate as tc
from oadp_tpu.dp import test_calibrate as jc

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = ['--override', ".model.device:'cpu'"]
SCORE_RTOL = 1e-5

SETTINGS = {
    'defaults': dict(tc.DEFAULT_PARAMS),
    'perturbed': dict(tc.DEFAULT_PARAMS, bbox_base_scaler=1.3, bbox_novel_scaler=0.4,
                      bbox_novel_gamma=0.7, object_base_gamma=0.25, objectness_gamma=0.5),
    'drawn': {k: float(v) for k, v in zip(
        tsweep.SEARCH_SPACE,
        np.random.default_rng(7).uniform(*np.asarray(list(tsweep.SEARCH_SPACE.values())).T))},
}
CLASSES = {'c5': (3, 5), 'c65': (48, 65)}


def _records(num_all: int, b: int = 4, n: int = 64, seed: int = 0) -> dict[str, np.ndarray]:
    """Random DUMP-like records: overlapping boxes, logits with some columns
    at -inf, objectness with zeros, the last rows of each image not valid."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 200, (b, n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(10, 80, (b, n, 2))], -1).astype(np.float32)
    logits = [2 * rng.standard_normal((b, n, num_all + 1)).astype(np.float32) for _ in range(2)]
    for lg in logits:
        lg[:, ::5, 1] = -np.inf
        lg[:, 3::7, num_all - 1] = -np.inf
    objectness = rng.uniform(0, 1, (b, n)).astype(np.float32)
    objectness[:, ::9] = 0.0
    valid = np.ones((b, n), bool)
    valid[:, n - 5:] = False
    valid[1, :7] = False
    return dict(bboxes=boxes, bbox_logits=logits[0], object_logits=logits[1],
                objectness=objectness, valid=valid)


def _check_same(got, want) -> None:
    """``rescore`` outputs: identical labels, rows, valid flags and boxes,
    scores within ``SCORE_RTOL``."""
    dets, labels, rows, valid = (t.numpy() for t in got)
    wdets, wlabels, wrows, wvalid = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(valid, wvalid)
    np.testing.assert_array_equal(labels, wlabels)
    np.testing.assert_array_equal(rows, wrows)
    np.testing.assert_array_equal(dets[..., :4], wdets[..., :4])
    np.testing.assert_allclose(dets[..., 4], wdets[..., 4], rtol=SCORE_RTOL, atol=0)


@pytest.mark.parametrize('setting', list(SETTINGS))
@pytest.mark.parametrize('classes', list(CLASSES))
def test_classify_equal_oadp_tpu(classes, setting):
    nb, na = CLASSES[classes]
    rec = _records(na)
    p = [SETTINGS[setting][k] for k in tc.DEFAULT_PARAMS]
    for logits, (s_b, s_n, g_b, g_n) in ((rec['bbox_logits'], p[0:4]),
                                         (rec['object_logits'], p[4:8])):
        want = np.asarray(jc._classify(jnp.asarray(logits), *map(jnp.float32, (s_b, s_n, g_b, g_n)),
                                       nb, na))
        got = tc._classify(torch.from_numpy(logits), *map(
            lambda v: torch.tensor(v, dtype=torch.float32), (s_b, s_n, g_b, g_n)), nb, na)
        np.testing.assert_allclose(got.numpy(), want, rtol=SCORE_RTOL, atol=1e-30)


@pytest.mark.parametrize('setting', list(SETTINGS))
@pytest.mark.parametrize('classes', list(CLASSES))
def test_rescore_equal_oadp_tpu(classes, setting):
    nb, na = CLASSES[classes]
    rec = _records(na)
    p = [SETTINGS[setting][k] for k in tc.DEFAULT_PARAMS]
    kw = dict(num_bases=nb, num_all=na, max_per_img=100, score_thr=0.0, iou_threshold=0.5)
    want = jc.rescore(*(jnp.asarray(rec[k]) for k in rec), jnp.asarray(p, jnp.float32), **kw)
    got = tc.rescore(*(torch.from_numpy(rec[k]) for k in rec), p, **kw)
    _check_same(got, want)
    # detections kept, and none on a row that is not valid
    assert int(got[3].sum()) > 20
    rows = got[2].numpy()[got[3].numpy()].reshape(-1)
    assert not np.isin(rows, np.arange(59, 64)).any()


@pytest.mark.parametrize('classes', list(CLASSES))
def test_rescore_is_one_nms_call_a_batch(classes, monkeypatch):
    """``rescore`` puts a batch's B x C keep-set problems into one
    ``greedy_keep_sorted`` call (on the card, one ``greedy_nms`` launch),
    with an image that has no valid row, and its outputs equal
    ``oadp_tpu``'s and ``rescore`` image by image."""
    from oadp_torch.ops import nms as tnms

    nb, na = CLASSES[classes]
    rec = _records(na, b=5, seed=3)
    rec['valid'][2] = False
    p = [SETTINGS['perturbed'][k] for k in tc.DEFAULT_PARAMS]
    kw = dict(num_bases=nb, num_all=na, max_per_img=100, score_thr=0.0, iou_threshold=0.5)
    calls = []
    keep_fn = tnms.greedy_keep_sorted
    monkeypatch.setattr(tnms, 'greedy_keep_sorted',
                        lambda *a, **k: calls.append(a[1].shape) or keep_fn(*a, **k))
    got = tc.rescore(*(torch.from_numpy(rec[k]) for k in rec), p, **kw)
    assert calls == [(5 * na, rec['bboxes'].shape[1])]
    _check_same(got, jc.rescore(*(jnp.asarray(rec[k]) for k in rec), jnp.asarray(p, jnp.float32),
                                **kw))
    assert not got[3][2].any() and got[3][0].any()
    for i in range(5):
        one = tc.rescore(*(torch.from_numpy(rec[k][i:i + 1]) for k in rec), p, **kw)
        for g, w in zip(got, one):
            assert torch.equal(g[i:i + 1], w)


# ---------------------------------------------------------------------------
# the runner and the CLI on dp.test's DUMP records
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def dump(tmp_path_factory):
    """``DRY_RUN=1 DUMP=...`` ``python -m oadp_torch.dp.test`` on
    ``tests/synthetic_data.py`` data (3 images) with a small random
    mmdet-layout checkpoint, as ``tests/test_torch_dp_cli.py`` runs it."""
    import chip_smoke
    from oadp_torch.dp import test as ttest
    from tests.synthetic_data import make_synthetic_dp
    from tests.test_torch_dp_cli import CFG

    root = tmp_path_factory.mktemp('calib_dump')
    data = make_synthetic_dp(root)
    ckpt = root / 'mmdet.pth'
    torch.save({'state_dict': chip_smoke.mmdet_state_dict(seed=1, base=8, fpn=16, fc=32,
                                                          emb=32)}, ckpt)
    cfg = root / 'config.py'
    cfg.write_text(CFG.format(
        vild=str(pathlib.Path(data['prompts']) / 'vild.pth'),
        ml=str(pathlib.Path(data['prompts']) / 'ml.pth'),
        ckpt=str(ckpt), ann=data['ann_file'], img=data['root']))
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        mp.setenv('DRY_RUN', '1')
        mp.setenv('DUMP', str(root / 'dump'))
        assert ttest.main([str(cfg), 'none', *CPU]) == {}
    assert len(list((root / 'dump').glob('*.pth'))) == 3
    return root, cfg


@pytest.fixture()
def dry_run(dump, monkeypatch):
    monkeypatch.chdir(dump[0])
    monkeypatch.setenv('DRY_RUN', '1')
    return dump


def _runners(cfg: pathlib.Path, root: pathlib.Path):
    from oadp_torch.utils import Config as TConfig
    from oadp_tpu.utils import Config as JConfig

    return (tc.CalibrationRunner(TConfig.load(cfg), str(root / 'dump'), device='cpu'),
            jc.CalibrationRunner(JConfig.load(cfg), str(root / 'dump')))


@pytest.mark.parametrize('setting', list(SETTINGS))
def test_run_trial_equal_oadp_tpu(dry_run, setting):
    """The same dense arrays, the same per-image keep sets, the same
    metrics dict."""
    root, cfg = dry_run
    got, want = _runners(cfg, root)
    assert got.image_ids == want.image_ids and len(got.image_ids) == 3
    for name in ('bboxes', 'bbox_logits', 'object_logits', 'objectness', 'valid'):
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(want, name),
                                      err_msg=name)
    params = SETTINGS[setting]
    p = jnp.asarray([params[k] for k in tc.DEFAULT_PARAMS], jnp.float32)
    ref = jc.rescore(want.bboxes, want.bbox_logits, want.object_logits, want.objectness,
                     want.valid, p, num_bases=48, num_all=65, max_per_img=want.max_per_img,
                     score_thr=want.score_thr, iou_threshold=want.iou)
    out = got.rescore_batch(params, 0, 3)
    _check_same(out, ref)
    assert int(out[3].sum()) > 0
    metrics = got.run_trial(params)
    assert 'COCO_48_bbox_mAP_50' in metrics and metrics == want.run_trial(params)


def test_cli_line_equal_oadp_tpu(dry_run, capsys):
    root, cfg = dry_run
    params = json.dumps(SETTINGS['perturbed'])
    argv = ['trial', str(cfg), str(root / 'dump'), '--params', params]
    got = tc.main(argv + CPU)
    got_line = capsys.readouterr().out.strip().splitlines()[-1]
    jc.main(argv)
    want_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(got_line) == json.loads(want_line) == got
    assert got['metric'] == 'COCO_48_bbox_mAP_50' and got['params'] == SETTINGS['perturbed']


def test_cli_default_without_card_raises(dry_run, tmp_path):
    root, cfg = dry_run
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default device runs')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tc.main(['trial', str(cfg), str(root / 'dump')])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tsweep.main([str(cfg), str(root / 'dump'), '--trials', '1',
                     '--output', str(tmp_path / 'out.json')])


class _NoDenseArrays:
    """``numpy`` for the module under test, with its dense constructors
    refused."""

    def __getattr__(self, name):
        if name in ('zeros', 'full', 'empty', 'ones'):
            raise AssertionError(f'np.{name} called before the memory guard')
        return getattr(np, name)


def test_memory_guard_raises_before_any_allocation(dry_run, monkeypatch):
    from oadp_torch.utils import Config, PthAccessLayer

    root, cfg = dry_run
    config = Config.load(cfg)

    def no_read(self, key):
        raise AssertionError(f'record {key} read before the memory guard')

    monkeypatch.setattr(PthAccessLayer, '__getitem__', no_read)
    monkeypatch.setattr(tc, 'np', _NoDenseArrays())
    with pytest.raises(SystemExit, match='GB'):
        tc.CalibrationRunner(config, str(root / 'dump'), device='cpu', memory_budget_gb=1e-9)
    monkeypatch.setenv('OADP_CALIBRATE_MEM_GB', '0')
    with pytest.raises(SystemExit, match='GB'):
        tc.CalibrationRunner(config, str(root / 'dump'), device='cpu')


# ---------------------------------------------------------------------------
# the discrimination case and the sweep
# ---------------------------------------------------------------------------

N_IMAGES = 6
CANVAS = 200


def _prob_row(p_cls: float, cls: int, k1: int = 66) -> np.ndarray:
    p = np.full(k1, (1.0 - p_cls) / (k1 - 1), np.float64)
    p[cls] = p_cls
    return p


@pytest.fixture(scope='module')
def discrimination(tmp_path_factory):
    """``tests/test_calibration_discrimination.py``'s DUMP set: one base gt an
    image, a correct detection and two distractors that outrank it unless
    gamma_object / gamma_bbox lies in a window holding the default ratio and
    the objectness exponent is 0."""
    from oadp_torch.base import coco

    root = tmp_path_factory.mktemp('calib_disc')
    dump_dir = root / 'dump'
    dump_dir.mkdir()
    images, annotations = [], []
    categories = [dict(id=i + 1, name=name) for i, name in enumerate(coco.all_)]
    for i in range(N_IMAGES):
        img_id = 100 + i
        images.append(dict(id=img_id, file_name=f'{img_id:012d}.jpg', width=CANVAS,
                           height=CANVAS))
        annotations.append(dict(id=i + 1, image_id=img_id, category_id=i + 1,
                                bbox=[10.0, 10.0, 40.0, 40.0], area=1600.0, iscrowd=0))
        boxes = np.asarray([[10, 10, 50, 50], [100, 100, 140, 140], [10, 100, 50, 140]],
                           np.float32)
        pb = np.stack([_prob_row(0.40, i), _prob_row(0.20, i), _prob_row(0.52, i)])
        po = np.stack([_prob_row(0.20, i), _prob_row(0.40, i), _prob_row(0.10, i)])
        torch.save({
            'bboxes': torch.from_numpy(boxes),
            'bbox_logits': torch.from_numpy(np.log(pb).astype(np.float32)),
            'object_logits': torch.from_numpy(np.log(po).astype(np.float32)),
            'objectness': torch.from_numpy(np.asarray([0.4, 0.8, 0.8], np.float32)),
        }, dump_dir / f'{img_id:012d}.pth')
    ann_file = root / 'instances.json'
    ann_file.write_text(json.dumps(dict(images=images, annotations=annotations,
                                        categories=categories)))
    cfg = root / 'config.py'
    cfg.write_text(f'categories = {"coco"!r}\nvalidator = dict(dataloader=dict(dataset=dict('
                   f'ann_file={str(ann_file)!r}, img_prefix={str(root)!r})))\n')
    return root, cfg


def _value(runner, params) -> float:
    return float(runner.run_trial(params)['COCO_48_bbox_mAP_50'])


def test_discrimination_default_beats_perturbations(discrimination):
    from oadp_torch.utils import Config

    root, cfg = discrimination
    runner = tc.CalibrationRunner(Config.load(cfg), str(root / 'dump'), batch_size=N_IMAGES,
                                  max_proposals=3, device='cpu')
    default = _value(runner, dict(tc.DEFAULT_PARAMS))
    assert default == pytest.approx(1.0, abs=1e-6)
    for p in (dict(tc.DEFAULT_PARAMS, bbox_base_gamma=1 / 3, object_base_gamma=2 / 3),
              dict(tc.DEFAULT_PARAMS, bbox_base_gamma=0.8, object_base_gamma=0.2),
              dict(tc.DEFAULT_PARAMS, objectness_gamma=1.0)):
        assert _value(runner, p) < default - 0.25, p
    # the TPE of the port's sweep space reaches the optimum without the
    # defaults' warm start, as oadp_tpu's does
    from oadp_torch.utils.search import TpeSampler

    sampler = TpeSampler(tsweep.SEARCH_SPACE, seed=3)
    best = -1.0
    for _ in range(40):
        params = sampler.ask()
        value = _value(runner, params)
        sampler.tell(params, value)
        best = max(best, value)
        if best >= 1.0 - 1e-6:
            break
    assert best == pytest.approx(1.0, abs=1e-6) and math.isclose(best, default, abs_tol=1e-6)


@pytest.mark.parametrize('sampler', ['tpe', 'random'])
def test_sweep_history_equal_tool(discrimination, sampler, tmp_path, monkeypatch):
    """``--trials 6 --seed 0``: the port's sweep CLI and ``tools/
    calibrate_sweep.py`` give the same trials, values and best."""
    root, cfg = discrimination
    common = [str(cfg), str(root / 'dump'), '--trials', '6', '--seed', '0',
              '--sampler', sampler]
    got = tsweep.main(common + ['--output', str(tmp_path / 'port.json'), *CPU])
    monkeypatch.syspath_prepend(str(REPO))
    tool = importlib.import_module('tools.calibrate_sweep')
    monkeypatch.setattr(sys, 'argv', ['calibrate_sweep.py', *common, '--output',
                                      str(tmp_path / 'tool.json')])
    tool.main()
    want = json.loads((tmp_path / 'tool.json').read_text())
    assert json.loads((tmp_path / 'port.json').read_text()) == got == want
    values = [h['COCO_48_bbox_mAP_50'] for h in got['history']]
    assert len(values) == 6 and values[0] == pytest.approx(1.0, abs=1e-6)
    assert len(set(values)) > 1  # the draws move the metric
