"""The port's DP detector against ``oadp_tpu``'s, fp32 on the CPU:
``simple_test`` on one shared random detector for OV-COCO (C = 65) and
OV-LVIS (C = 1203, masks) at the small geometry of ``tests/test_dp_e2e.py``
(base 8, FPN 16, fc 32, embedding 32, blocks (1, 1, 1, 1), a 192 x 256
canvas); ``from_jax_params`` against the mmdet-layout loaders; the
builder's prompts and anchors; the evaluator's DUMP record, gather and
batch unpacking."""

import dataclasses
import functools
import importlib.util
import pathlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oadp_tpu.dp import builder as jbuilder
from oadp_tpu.dp import datasets as jdatasets
from oadp_tpu.dp.evaluator import DetEvaluator as JEvaluator
from oadp_tpu.models import detector as jdet
from oadp_tpu.models import fpn as jfpn
from oadp_tpu.models import heads as jheads
from oadp_tpu.models import mask_head as jmask
from oadp_tpu.models import resnet as jresnet
from oadp_tpu.models import rpn as jrpn
from oadp_torch.base import coco, lvis
from oadp_torch.dp import builder as tbuilder
from oadp_torch.dp import datasets as tdatasets
from oadp_torch.dp.evaluator import DetEvaluator as TEvaluator
from oadp_torch.models import detector as tdet
from oadp_torch.utils import Config


def _sibling(name: str):
    """A module of this directory, loaded by path: on a host where an
    installed package is also called ``tests``, ``import tests.x`` finds
    that one (this directory has no ``__init__.py``)."""
    spec = importlib.util.spec_from_file_location(f'_{name}', pathlib.Path(__file__).with_name(
        f'{name}.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_det_ops = _sibling('test_torch_det_ops')
jax_tree, randomize_bn = _det_ops.jax_tree, _det_ops.randomize_bn

torch.set_num_threads(1)

SIZES = dict(base_channels=8, fpn_channels=16, fc_channels=32, embedding_dim=32,
             stage_blocks=(1, 1, 1, 1))
TEST_CFG = dict(rpn_test_nms_pre=32, rpn_test_max=16, rcnn_max_per_img=8)
CANVAS = (192, 256)
CASES = {
    'ov_coco': (coco, {}),
    'ov_lvis': (lvis, dict(with_mask=True, head_cls_mode='vild', vild_scaler_train=0.01,
                           vild_scaler_val=0.007, global_vild_scaler=(0.007, 0.01))),
}


def _configs(categories, **kw):
    model = Config(dict(sizes=SIZES))
    args = (categories.num_bases, categories.num_all)
    return (jbuilder._apply_size_overrides(jdet.DetectorConfig.build(*args, **kw, **TEST_CFG),
                                           model),
            tbuilder._apply_size_overrides(tdet.DetectorConfig.build(*args, **kw, **TEST_CFG),
                                           model))


@functools.lru_cache()
def _run(case: str):
    """One random detector (the port's init, random batch norms), its
    ``oadp_tpu`` tree, and both ``simple_test`` outputs on one batch of two
    images."""
    categories, kw = CASES[case]
    jcfg, tcfg = _configs(categories, **kw)
    gen = torch.Generator().manual_seed(0)
    emb = torch.nn.functional.normalize(torch.randn(categories.num_all, 32, generator=gen),
                                        dim=-1)
    params, stats = tdet.init_detector(gen, tcfg, emb, emb.flip(0))
    randomize_bn(params, gen)
    randomize_bn(stats, gen)
    jparams, jstats = jax_tree(params), jax_tree(stats)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (2, *CANVAS, 3), dtype=np.uint8)
    img_hw = np.asarray([[192, 250], [180, 256]], np.float32)
    want = jax.jit(functools.partial(
        jdet.simple_test, config=jcfg, level_anchors=jbuilder.canvas_anchors(jcfg, CANVAS)))(
        jparams, jstats,
        dict(images=jdet.ingest_images(jnp.asarray(images)), img_hw=jnp.asarray(img_hw)))
    want = {k: None if v is None else np.asarray(v) for k, v in want.items()}
    with torch.inference_mode():
        got = tdet.simple_test(
            params, stats,
            dict(images=tdet.ingest_images(torch.from_numpy(images)),
                 img_hw=torch.from_numpy(img_hw)),
            tcfg, tbuilder.canvas_anchors(tcfg, CANVAS))
    return tcfg, got, want, (params, stats), (jparams, jstats)


@pytest.mark.parametrize('case', list(CASES))
def test_simple_test_pre_nms_tensors(case):
    """The decoded boxes, both heads' logits (as cosine logits: divided by
    the heads' scale) and the ensemble's probabilities at atol 1e-4."""
    cfg, got, want, _, _ = _run(case)
    np.testing.assert_allclose(got['boxes'].numpy(), want['boxes'], atol=1e-4, rtol=0)
    for key, head in (('bbox_logits', cfg.bbox_head), ('object_logits', cfg.object_head)):
        c = head.classifier
        scale = c.scaler_val if c.mode == 'vild' else 1 / c.scaler
        np.testing.assert_allclose(got[key].numpy() * scale, want[key] * scale, atol=1e-4,
                                   rtol=0, err_msg=key)
    np.testing.assert_array_equal(got['proposal_valid'].numpy(), want['proposal_valid'])
    np.testing.assert_allclose(got['objectness'].numpy(), want['objectness'], atol=1e-5, rtol=0)
    probs = [tdet.ensemble(torch.tensor(b).reshape(-1, b.shape[-1]),
                           torch.tensor(o).reshape(-1, o.shape[-1]), cfg).numpy()
             for b, o in ((got['bbox_logits'].numpy(), got['object_logits'].numpy()),
                          (want['bbox_logits'], want['object_logits']))]
    np.testing.assert_allclose(probs[0], probs[1], atol=1e-4, rtol=0)


@pytest.mark.parametrize('case', list(CASES))
def test_simple_test_detections(case):
    """Keep sets (the rows each detection came from), labels and ``valid``
    identical; boxes and scores at atol 1e-4; masks (OV-LVIS) too."""
    cfg, got, want, _, _ = _run(case)
    for key in ('det_rows', 'labels', 'valid'):
        np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)
    assert got['valid'].any()
    np.testing.assert_allclose(got['dets'].numpy(), want['dets'], atol=1e-4, rtol=0)
    assert got['labels'].max() < cfg.num_all
    if cfg.with_mask:
        assert got['masks'].shape == (2, cfg.rcnn_max_per_img, 28, 28)
        np.testing.assert_allclose(got['masks'].numpy(), want['masks'], atol=1e-4, rtol=0)
    else:
        assert got['masks'] is None and want['masks'] is None


@pytest.mark.parametrize('case', list(CASES))
def test_simple_test_nms_is_one_call_a_batch(case, monkeypatch):
    """``simple_test`` on a batch of two makes two ``greedy_keep_sorted``
    calls (on the card, two ``greedy_nms`` launches): the RPN's over both
    images and ``multiclass_nms``'s over both images' classes; its
    detections equal ``multiclass_nms`` image by image on its own boxes and
    probabilities."""
    from oadp_torch.ops import nms as tnms

    cfg, got, _, (params, stats), _ = _run(case)
    calls = []
    keep_fn = tnms.greedy_keep_sorted
    monkeypatch.setattr(tnms, 'greedy_keep_sorted',
                        lambda *a, **k: calls.append(tuple(a[1].shape)) or keep_fn(*a, **k))
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (2, *CANVAS, 3), dtype=np.uint8)
    img_hw = torch.tensor([[192, 250], [180, 256]], dtype=torch.float32)
    with torch.inference_mode():
        out = tdet.simple_test(params, stats, dict(images=tdet.ingest_images(
            torch.from_numpy(images)), img_hw=img_hw), cfg, tbuilder.canvas_anchors(cfg, CANVAS))
    n = cfg.rpn_test_max
    assert [c[0] for c in calls] == [2, 2 * cfg.num_all] and calls[1][1] == n
    probs = tdet.ensemble(out['bbox_logits'].reshape(2 * n, -1),
                          out['object_logits'].reshape(2 * n, -1), cfg).reshape(2, n, -1)
    for i in range(2):
        one = tnms.multiclass_nms(out['boxes'][i], torch.where(
            out['proposal_valid'][i][:, None], probs[i], 0.0), cfg.rcnn_score_thr,
            cfg.rcnn_nms_iou, cfg.rcnn_max_per_img, cfg.num_all)
        for key, w in zip(('dets', 'labels', 'det_rows', 'valid'), one):
            assert torch.equal(out[key][i], w), key
            assert torch.equal(got[key][i], w), key


def test_ensemble_matches_formula():
    """The ViLD ensemble: λ = 2/3 for bases and 1/3 for novels and bg, the
    bg renormalised to 1 - Σ, every row then renormalised."""
    cfg = _configs(coco)[1]
    rng = np.random.default_rng(1)
    b, o = (rng.standard_normal((5, 66)).astype(np.float32) * 3 for _ in range(2))
    lam = np.full(66, 1 / 3)
    lam[:48] = 2 / 3

    def softmax(x):
        e = np.exp(x - x.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    s = softmax(b.astype(np.float64)) ** lam * softmax(o.astype(np.float64)) ** (1 - lam)
    s[:, -1] = 1 - s[:, :-1].sum(-1)
    want = s / s.sum(-1, keepdims=True)
    got = tdet.ensemble(torch.from_numpy(b), torch.from_numpy(o), cfg).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


# ---------------------------------------------------------------------------
# weights: oadp_tpu's trees and the mmdet layout
# ---------------------------------------------------------------------------


def _jax_from_mmdet(state, cfg, init):
    """``oadp_tpu``'s converters on an mmdet state dict (numpy values)."""
    np_state = {k: v.numpy() for k, v in state.items()}
    params, stats = {}, {}
    params['backbone'], stats['backbone'] = jresnet.convert_torch_resnet(np_state, 'backbone.')
    params['fpn'], stats['fpn'] = jfpn.convert_torch_fpn(np_state, 'neck.')
    params['rpn'] = jrpn.convert_torch_rpn(np_state)
    for name, prefix, hcfg in (('bbox_head', 'roi_head.bbox_head.', cfg.bbox_head),
                               ('object_head', 'roi_head._object_head.', cfg.object_head)):
        params[name], stats[name] = jheads.convert_torch_convfc_head(
            np_state, prefix, hcfg, jax_tree(init[name]))
    params['mask_head'] = jmask.convert_torch_mask_head(np_state)
    return jax.tree.map(np.asarray, (params, stats))


def test_from_jax_params_equals_mmdet_loaders(tmp_path):
    """One random mmdet-layout state dict (``chip_smoke.mmdet_state_dict``,
    full ResNet-50 depth at small widths) read by ``oadp_tpu``'s converters
    then :func:`from_jax_params`, and by the port's loaders directly
    (``DetectorBundle.load_pretrained``): the same trees."""
    import chip_smoke

    state = chip_smoke.mmdet_state_dict(seed=3, base=8, fpn=16, fc=32, emb=32)
    sizes = {k: v for k, v in SIZES.items() if k != 'stage_blocks'}
    tcfg = tbuilder._apply_size_overrides(
        tdet.DetectorConfig.build(coco.num_bases, coco.num_all, with_mask=True),
        Config(dict(sizes=sizes)))
    emb = torch.nn.functional.normalize(torch.randn(65, 32), dim=-1)
    params, stats = tdet.init_detector(torch.Generator().manual_seed(0), tcfg, emb)
    bundle = tbuilder.DetectorBundle(tcfg, params, stats)
    init = {k: dict(v) for k, v in params.items()}
    jparams, jstats = _jax_from_mmdet(state, tcfg, init)
    torch.save({'state_dict': state}, tmp_path / 'mmdet.pth')
    bundle.load_pretrained(str(tmp_path / 'mmdet.pth'))
    fparams, fstats = tdet.from_jax_params(jparams, jstats)
    for got, want in ((bundle.params, fparams), (bundle.stats, fstats)):
        got = {k: v for k, v in got.items() if k in want}
        flat_g, flat_w = _leaves(got), _leaves(want)
        assert list(flat_g) == list(flat_w)
        for key in flat_w:
            torch.testing.assert_close(flat_g[key], flat_w[key], rtol=0, atol=0, msg=key)


def test_partial_mask_head_graft_raises(tmp_path):
    """A checkpoint whose mask head lacks keys fails the graft instead of
    leaving the random mask head in place."""
    import chip_smoke

    state = chip_smoke.mmdet_state_dict(seed=4, base=8, fpn=16, fc=32, emb=32)
    del state['roi_head.mask_head.conv_logits.weight']
    torch.save({'state_dict': state}, tmp_path / 'partial.pth')
    sizes = {k: v for k, v in SIZES.items() if k != 'stage_blocks'}
    cfg = tbuilder._apply_size_overrides(
        tdet.DetectorConfig.build(coco.num_bases, coco.num_all, with_mask=True),
        Config(dict(sizes=sizes)))
    emb = torch.nn.functional.normalize(torch.randn(65, 32), dim=-1)
    bundle = tbuilder.DetectorBundle(
        cfg, *tdet.init_detector(torch.Generator().manual_seed(0), cfg, emb))
    with pytest.raises(KeyError, match='conv_logits'):
        bundle.load_pretrained(str(tmp_path / 'partial.pth'))


def _leaves(tree, prefix=''):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in sorted(tree.items())
                for k2, v2 in _leaves(v, f'{prefix}{k}.').items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _leaves(v, f'{prefix}{i}.').items()}
    return {prefix[:-1]: tree}


def test_from_jax_params_round_trips_simple_test_tree():
    """The shared detector of the ``simple_test`` tests: the port's tree
    taken to ``oadp_tpu``'s and back is the same tree."""
    _, _, _, (params, stats), (jparams, jstats) = _run('ov_lvis')
    back_p, back_s = tdet.from_jax_params(jparams, jstats)
    for got, want in ((back_p, params), (back_s, stats)):
        flat_g, flat_w = _leaves(got), _leaves(want)
        assert list(flat_g) == list(flat_w)
        for key in flat_w:
            torch.testing.assert_close(flat_g[key], flat_w[key], rtol=0, atol=0, msg=key)


# ---------------------------------------------------------------------------
# builder
# ---------------------------------------------------------------------------


def test_load_prompts_reorders_as_oadp_tpu(tmp_path):
    from oadp_torch.utils import save_pth

    rng = np.random.default_rng(4)
    names = list(coco.all_)
    rng.shuffle(names)
    emb = rng.standard_normal((65, 8)).astype(np.float32)
    save_pth(dict(names=names, embeddings=emb, scaler=np.float32(50.0),
                  bias=np.float32(20.0)), tmp_path / 'p.pth')
    for path in (str(tmp_path / 'p.pth'), str(tmp_path / 'missing.pth')):
        got = tbuilder.load_prompts(path, coco, embedding_dim=8)
        want = jbuilder.load_prompts(path, coco, embedding_dim=8)
        assert set(got) == set(want)
        np.testing.assert_array_equal(got['embeddings'], want['embeddings'])
        for k in ('scaler', 'bias'):
            assert got.get(k) == want.get(k)


@pytest.mark.parametrize('canvas', [(832, 1344), (1344, 832)])
def test_canvas_anchors_match(canvas):
    jcfg, tcfg = _configs(coco)
    for got, want in zip(tbuilder.canvas_anchors(tcfg, canvas),
                         jbuilder.canvas_anchors(jcfg, canvas)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ingest_images_matches():
    images = np.random.default_rng(5).integers(0, 256, (2, 6, 7, 3), dtype=np.uint8)
    got = tdet.ingest_images(torch.from_numpy(images))
    want = np.asarray(jdet.ingest_images(jnp.asarray(images)))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-6, rtol=0)
    assert got.shape == (2, 3, 6, 7)


# ---------------------------------------------------------------------------
# evaluator pieces
# ---------------------------------------------------------------------------


def test_unpack_batch_inverts_pack_batch():
    rng = np.random.default_rng(6)
    batch = {
        'images': rng.integers(0, 256, (2, 8, 12, 3), dtype=np.uint8),
        'img_hw': rng.random((2, 2)).astype(np.float32),
        'gt_labels': rng.integers(0, 65, (2, 5)).astype(np.int32),
        'gt_valid': rng.random((2, 5)) < 0.5,
        'image_ids': np.asarray([3, 4]),
        'scale_factor': rng.random((2, 4)).astype(np.float32),
    }
    packed = tdatasets.pack_batch(dict(batch))
    want = jdatasets.unpack_batch(jnp.asarray(packed['packed']), packed['_pack_spec'])
    got = tdatasets.unpack_batch(torch.from_numpy(packed['packed']), packed['_pack_spec'])
    assert set(got) == set(want) == {'images', 'img_hw', 'gt_labels', 'gt_valid'}
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        np.testing.assert_array_equal(got[k].numpy(), batch[k])


def test_write_dump_matches():
    rng = np.random.default_rng(7)
    packed = np.concatenate([
        rng.uniform(0, 100, (6, 4)), rng.standard_normal((6, 8)),
        np.full((6, 1), -1e10), rng.random((6, 1)), (rng.random((6, 1)) < 0.7),
    ], -1).astype(np.float32)
    scale = np.asarray([2.0, 1.5, 2.0, 1.5], np.float32)
    records = []
    for cls in (TEvaluator, JEvaluator):
        store = {}
        cls._write_dump(type('Stub', (), {'_dump': store})(), 5, packed, scale)
        records.append(store['000000000005'])
    assert set(records[0]) == set(records[1]) == {
        'bboxes', 'bbox_logits', 'object_logits', 'objectness'}
    for k in records[0]:
        np.testing.assert_array_equal(records[0][k], records[1][k])
        assert records[0][k].dtype == np.float16


def test_gather_two_ranks(tmp_path):
    """Two ranks (threads) publish their parts and meet at a barrier;
    rank 0 merges both in rank order and cleans up, rank 1 gets None."""
    stub = type('Stub', (), {'work_dir': None})()
    parts = [[(1, ['a'])], [(2, ['b']), (3, [])]]
    barrier = threading.Barrier(2)
    out = [None, None]
    start = TEvaluator._gather_round

    def worker(rank):
        out[rank] = TEvaluator._gather(stub, parts[rank], process_index=rank,
                                       process_count=2, root=tmp_path,
                                       barrier=lambda: barrier.wait(timeout=30),
                                       timeout_s=30)

    threads = [threading.Thread(target=worker, args=(r,)) for r in (0, 1)]
    for t in threads:
        TEvaluator._gather_round = start  # the same round on both ranks
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert out[0] == parts[0] + parts[1] and out[1] is None
    assert not list(tmp_path.glob('eval_gather/round*'))
    assert TEvaluator._gather(stub, parts[0], process_count=1) == parts[0]


def test_gather_needs_a_process_group(tmp_path):
    """Several processes but no process group: the barrier raises instead
    of merging parts that may not be there."""
    stub = type('Stub', (), {'work_dir': None})()
    with pytest.raises(RuntimeError, match='process group'):
        TEvaluator._gather(stub, [], process_index=1, process_count=2, root=tmp_path)


def test_config_fields_match():
    """The port's ``DetectorConfig`` has ``oadp_tpu``'s fields and defaults,
    so one model config builds both."""
    jcfg, tcfg = _configs(lvis, **CASES['ov_lvis'][1])
    assert [f.name for f in dataclasses.fields(tcfg)] == [
        f.name for f in dataclasses.fields(jcfg)]
    for f in dataclasses.fields(jcfg):
        if f.name not in ('backbone', 'anchor_generator', 'mask_head', 'bbox_head',
                          'object_head', 'block_head', 'global_cls'):
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    for name in ('backbone', 'mask_head', 'global_cls'):
        assert dataclasses.asdict(getattr(tcfg, name)) == dataclasses.asdict(getattr(jcfg, name))
    for name in ('bbox_head', 'object_head', 'block_head'):
        assert dataclasses.asdict(getattr(tcfg, name)) == dataclasses.asdict(getattr(jcfg, name))
