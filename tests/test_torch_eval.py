"""The port's framework-free copies against their ``oadp_tpu`` originals:
the COCO and LVIS evaluators with the native matcher, the polygon-mask
functions (numpy ones bit-equal, ``rasterize_in_boxes`` ported to torch),
the search samplers, the DetPro repackager, the category splits,
``build_annotations`` and the ODPS shim."""

import copy
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from oadp_tpu.dp import coco_eval as jcoco
from oadp_tpu.dp import lvis_eval as jlvis
from oadp_tpu.ops import masks as jmasks
from oadp_torch.dp import coco_eval as tcoco
from oadp_torch.dp import lvis_eval as tlvis
from oadp_torch.ops import masks as tmasks


def _sibling(name: str):
    """A module of this directory, loaded by path: on a host where an
    installed package is also called ``tests``, ``import tests.x`` finds
    that one (this directory has no ``__init__.py``)."""
    spec = importlib.util.spec_from_file_location(f'_{name}', pathlib.Path(__file__).with_name(
        f'{name}.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_coco_eval = _sibling('test_coco_eval')
_dataset, _det = _coco_eval._dataset, _coco_eval._det

torch.set_num_threads(1)


def _random_coco(seed=1, n_img=20, n_cat=10):
    """``tests/test_coco_eval.py:test_eval_speed_smoke``'s data."""
    rng = np.random.default_rng(seed)
    anns, dets = [], []
    for i in range(n_img):
        for _ in range(5):
            c = int(rng.integers(1, n_cat + 1))
            x, y = rng.uniform(0, 400, 2)
            w, h = rng.uniform(10, 100, 2)
            anns.append((i, c, (x, y, w, h)))
            dets.append(_det(i, c, (x + rng.uniform(-3, 3), y + rng.uniform(-3, 3), w, h),
                             float(rng.uniform(0.5, 1.0))))
            dets.append(_det(i, int(rng.integers(1, n_cat + 1)),
                             tuple(rng.uniform(0, 300, 2)) + (20.0, 20.0),
                             float(rng.uniform(0, 0.5))))
    return _dataset(anns, n_img, range(1, n_cat + 1)), dets


_RANDOM = _random_coco()
# the cases of tests/test_coco_eval.py: (dataset, cat_ids, max_dets, dets)
COCO_CASES = {
    'perfect': (_dataset([(0, 1, (10, 10, 50, 50))]), [1, 2], None,
                [_det(0, 1, (10, 10, 50, 50), 0.9)]),
    'miss': (_dataset([(0, 1, (10, 10, 50, 50))]), [1, 2], None,
             [_det(0, 1, (200, 200, 20, 20), 0.9)]),
    'loose_box': (_dataset([(0, 1, (0, 0, 100, 100))]), [1], None,
                  [_det(0, 1, (0, 0, 76, 100), 0.9)]),
    'fp_before_tp': (_dataset([(0, 1, (10, 10, 50, 50))]), [1], None,
                     [_det(0, 1, (300, 300, 20, 20), 0.95), _det(0, 1, (10, 10, 50, 50), 0.9)]),
    'crowd': (_dataset([(0, 1, (10, 10, 50, 50)), (0, 1, (100, 100, 80, 80), 1)]), [1], None,
              [_det(0, 1, (10, 10, 50, 50), 0.9), _det(0, 1, (110, 110, 60, 60), 0.8)]),
    'max_dets': (_dataset([(0, 1, (10, 10, 50, 50))]), [1], (1, 2, 1000),
                 [_det(0, 1, (200, 200, 20, 20), 0.95), _det(0, 1, (300, 300, 20, 20), 0.94),
                  _det(0, 1, (10, 10, 50, 50), 0.9)]),
    'ov_triple': (_dataset([(0, 1, (10, 10, 50, 50)), (0, 2, (100, 100, 50, 50)),
                            (0, 3, (200, 200, 50, 50))], cats=(1, 2, 3)), [1, 2, 3], None,
                  [_det(0, 1, (10, 10, 50, 50), 0.9), _det(0, 2, (100, 100, 50, 50), 0.8)]),
    'area_ranges': (_dataset([(0, 1, (10, 10, 16, 16))]), [1], None,
                    [_det(0, 1, (10, 10, 16, 16), 0.9)]),
    'headline_at_100': (_dataset([(0, 1, (10, 10, 50, 50))]), [1], (100, 300, 1000),
                        [_det(0, 1, (200 + j, 500, 5, 5), 0.9 - j * 0.001) for j in range(110)]
                        + [_det(0, 1, (10, 10, 50, 50), 0.1)]),
    'random': (_RANDOM[0], list(range(1, 11)), None, _RANDOM[1]),
}


@pytest.mark.parametrize('case', list(COCO_CASES))
def test_coco_evaluator_equal(case):
    dataset, cat_ids, max_dets, dets = COCO_CASES[case]
    kw = {} if max_dets is None else dict(max_dets=max_dets)
    out = []
    for mod in (jcoco, tcoco):
        ev = mod.CocoEvaluator(copy.deepcopy(dataset), cat_ids, **kw)
        ev.evaluate(copy.deepcopy(dets))
        n_novel = 1 if len(cat_ids) > 1 else 0
        out.append((ev.eval, ev.summarize(),
                    mod.ov_coco_summary(ev, len(cat_ids) - n_novel, n_novel)))
    (jeval, jstats, jtriple), (teval, tstats, ttriple) = out
    for key in ('precision', 'recall'):
        np.testing.assert_array_equal(teval[key], jeval[key])
    assert tstats == jstats and ttriple == jtriple


def test_native_matcher_equals_python():
    """The port's C++ matcher (built into ``build/oadp_torch_native/``)
    against its Python version on randomized cases, as
    ``tests/test_coco_eval.py`` holds ``oadp_tpu``'s."""
    from oadp_torch.native import build_dir, load_library

    lib = load_library('cocoeval_match')
    if lib is None:
        pytest.skip('no C++ toolchain')
    assert any(build_dir().glob('cocoeval_match-*.so'))
    rng = np.random.default_rng(0)
    for _ in range(50):
        nd, ng = int(rng.integers(1, 12)), int(rng.integers(1, 8))
        ious = rng.random((nd, ng))
        g_ignore = np.sort(rng.random(ng) < 0.3)  # ignored gts last
        iscrowd = (rng.random(ng) < 0.2) & g_ignore
        want = tcoco._match_pairs_py(ious, g_ignore, iscrowd)
        for got in (tcoco._match_pairs(ious, g_ignore, iscrowd),
                    jcoco._match_pairs_py(ious, g_ignore, iscrowd)):
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])


@pytest.fixture(scope='module')
def lvis_set():
    """``tests/test_lvis_mask_ap_bound.py``'s synthetic LVIS set (polygon
    rings, stars, squares and slivers over 9 categories, 3 per frequency
    band), with negative categories on two images and detections there
    that the federated rule keeps (verified absent) and drops (unknown)."""
    from tests.test_lvis_mask_ap_bound import _build_eval_set

    dataset, dets = _build_eval_set()
    dataset['images'][0]['neg_category_ids'] = [5, 8]
    dataset['images'][1]['neg_category_ids'] = [0]
    extra = [dict(d, category_id=c, score=0.7) for d in dets[:2] for c in (0, 5, 8)]
    return dataset, dets + extra


@pytest.mark.parametrize('iou_type', ['bbox', 'segm'])
def test_lvis_evaluator_equal(lvis_set, iou_type):
    dataset, dets = lvis_set
    out = []
    for mod in (jlvis, tlvis):
        ev = mod.LvisEvaluator(copy.deepcopy(dataset), list(range(9)), iou_type=iou_type)
        ev.evaluate(copy.deepcopy(dets))
        out.append((ev.eval, mod.ov_lvis_summary(ev)))
    (jeval, jsum), (teval, tsum) = out
    np.testing.assert_array_equal(teval['precision'], jeval['precision'])
    assert tsum == jsum
    assert all(tsum[f'lvis_{iou_type}_AP{b}'] > 0 for b in 'rcf'), tsum


def _star(rng, cx=15.0, cy=15.0, n=12):
    angles = np.sort(rng.uniform(0, 2 * np.pi, n))
    radii = rng.uniform(3, 10, n)
    return np.stack([cx + radii * np.cos(angles), cy + radii * np.sin(angles)],
                    -1).reshape(-1).tolist()


def test_mask_numpy_functions_bit_equal():
    rng = np.random.default_rng(0)
    polys = [[_star(rng), _star(rng, 20, 12, 7)], [[2.0, 2, 8, 2, 8, 8, 2, 8]],
             [[0.0, 0, 1, 1]]]  # the last part has < 3 vertices
    for p in polys:
        for n_parts, n_verts in ((2, 16), (1, 128)):
            np.testing.assert_array_equal(tmasks.resample_polygons(p, n_parts, n_verts),
                                          jmasks.resample_polygons(p, n_parts, n_verts))
        for rect in ((0, 0, 30, 30), (3.5, -2.0, 17, 9), (0, 0, 0, 5)):
            np.testing.assert_array_equal(tmasks.polygon_raster_np(p, *rect),
                                          jmasks.polygon_raster_np(p, *rect))
    mask = rng.random((28, 28)).astype(np.float32)
    for box in ((0.0, 0, 8, 8), (2.3, 4.1, 30.7, 19.2)):
        for rect in ((0, 0, 8, 8), (2, 4, 29, 16)):
            np.testing.assert_array_equal(
                tmasks.paste_mask_np(mask, np.asarray(box), *rect),
                jmasks.paste_mask_np(mask, np.asarray(box), *rect))
    dt = [(rng.random((28, 28)).astype(np.float32), np.asarray(b)) for b in (
        (0.0, 0, 10, 10), (4.2, 3.1, 25.5, 22.0), (100.0, 100, 110, 120))]
    gt_polys = [[_star(rng)], [[0.0, 0, 10, 0, 10, 10, 0, 10]]]
    gt_boxes = np.asarray([[5.0, 5, 25, 25], [0.0, 0, 10, 10]])
    for crowd in ([False, False], [False, True]):
        np.testing.assert_array_equal(
            tmasks.mask_iou_pairs(dt, gt_polys, gt_boxes, np.asarray(crowd)),
            jmasks.mask_iou_pairs(dt, gt_polys, gt_boxes, np.asarray(crowd)))


@pytest.mark.parametrize('case', ['square', 'star'])
def test_rasterize_in_boxes_equal(case):
    """The torch port against the jnp original on the cases of
    ``tests/test_masks.py`` (a square in a 10 x 10 RoI grid, a random star
    resampled to 128 vertices in a 30 x 30 grid), and on several RoIs and
    parts at once."""
    import jax.numpy as jnp

    if case == 'square':
        polys = tmasks.resample_polygons([[2.0, 2, 8, 2, 8, 8, 2, 8]], 2, 32)[None]
        boxes, idx, size = np.asarray([[0.0, 0, 10, 10]], np.float32), [0], 10
    else:
        rng = np.random.default_rng(0)
        polys = np.stack([tmasks.resample_polygons([_star(rng), _star(rng, 8, 20, 9)], 2, 128),
                          tmasks.resample_polygons([_star(rng)], 2, 128)])
        boxes = np.asarray([[0.0, 0, 30, 30], [2.5, 1.25, 24.0, 27.5], [5.0, 5, 20, 20]],
                           np.float32)
        idx, size = [0, 1, 0], 30
    idx = np.asarray(idx, np.int32)
    want = np.asarray(jmasks.rasterize_in_boxes(jnp.asarray(polys), jnp.asarray(idx),
                                                jnp.asarray(boxes), out_size=size))
    got = tmasks.rasterize_in_boxes(torch.from_numpy(polys), torch.from_numpy(idx),
                                    torch.from_numpy(boxes), out_size=size)
    assert got.dtype == torch.float32 and got.shape == (len(idx), size, size)
    assert want.any()
    np.testing.assert_array_equal(got.numpy(), want)


def test_search_samplers_equal():
    from oadp_tpu.utils import search as jsearch
    from oadp_torch.utils import search as tsearch

    for n, d, seed in ((128, 9, 0), (7, 3, 5)):
        np.testing.assert_array_equal(tsearch.kronecker_sequence(n, d, seed),
                                      jsearch.kronecker_sequence(n, d, seed))
    space = {'a': (0.0, 2.0), 'b': (-1.0, 1.0), 'c': (0.5, 0.6)}
    samplers = [mod.TpeSampler(space, seed=3, n_startup=5) for mod in (jsearch, tsearch)]
    for _ in range(30):
        asked = [s.ask() for s in samplers]
        assert asked[0] == asked[1]
        value = -sum((v - 0.3) ** 2 for v in asked[0].values())
        for s, p in zip(samplers, asked):
            s.tell(p, value)


def test_detpro_main_equal(tmp_path):
    from oadp_tpu.prompts import detpro as jdetpro
    from oadp_torch.prompts import detpro as tdetpro
    from oadp_torch.utils import load_pth, save_pth

    emb = np.random.default_rng(0).standard_normal((4, 8)).astype(np.float32)
    save_pth(emb, tmp_path / 'iou_neg5_ens.pth')
    cats = [dict(id=3, name='stero_equipment'), dict(id=1, name='aerosol_can'),
            dict(id=4, name='zucchini'), dict(id=2, name='air_conditioner')]
    (tmp_path / 'lvis_val.json').write_text(json.dumps(dict(categories=cats)))
    outs = []
    for name, mod in (('jax', jdetpro), ('torch', tdetpro)):
        outs.append(tmp_path / name / 'detpro_lvis.pth')
        mod.main(['--embeddings', str(tmp_path / 'iou_neg5_ens.pth'),
                  '--ann-file', str(tmp_path / 'lvis_val.json'), '--output', str(outs[-1])])
    assert outs[0].read_bytes() == outs[1].read_bytes()
    pack = load_pth(outs[1])
    assert pack['names'] == ['aerosol_can', 'air_conditioner', 'stero_equipment', 'zucchini']
    np.testing.assert_array_equal(pack['embeddings'], emb)


def test_categories_equal():
    import pathlib

    import oadp_tpu.base as jbase
    import oadp_torch.base as tbase

    for name in ('coco', 'lvis'):
        jdata = pathlib.Path(jbase.__file__).parent / 'data' / f'{name}.json'
        tdata = pathlib.Path(tbase.__file__).parent / 'data' / f'{name}.json'
        assert tdata.read_bytes() == jdata.read_bytes()
        j, t = getattr(jbase, name), getattr(tbase, name)
        assert (t.bases, t.novels, t.all_) == (j.bases, j.novels, j.all_)
    assert (tbase.coco.num_bases, tbase.coco.num_novels) == (48, 17)
    assert (tbase.lvis.num_bases, tbase.lvis.num_novels) == (866, 337)


@pytest.mark.parametrize('dataset', ['coco', 'lvis'])
def test_build_annotations_equal(tmp_path, dataset):
    from oadp_tpu import build_annotations as jba
    from oadp_torch import build_annotations as tba
    from oadp_torch.base import coco, lvis

    cats = coco if dataset == 'coco' else lvis
    names = cats.all_
    rng = np.random.default_rng(0)
    order = rng.permutation(len(names))
    data = dict(
        categories=[dict(id=100 + int(i), name=names[i]) for i in order]
        + [dict(id=99, name='not_a_class')],
        images=[dict(id=i, neg_category_ids=[100 + len(names) - 1],
                     not_exhaustive_category_ids=[100]) for i in range(4)],
        annotations=[dict(id=j, image_id=j % 3, category_id=100 + int(c),
                          bbox=[0, 0, 10, 10], area=100, iscrowd=0)
                     for j, c in enumerate(rng.integers(0, len(names), 12))]
        + [dict(id=50, image_id=0, category_id=99, bbox=[0, 0, 1, 1], area=1, iscrowd=0)],
    )
    if dataset == 'coco':
        for img in data['images']:
            del img['neg_category_ids'], img['not_exhaustive_category_ids']
    for name, mod in (('jax', jba), ('torch', tba)):
        (tmp_path / name).mkdir()
        (tmp_path / name / 'ann.json').write_text(json.dumps(data))
        builder = (mod.COCOBuilder if dataset == 'coco' else mod.LVISBuilder)(
            str(tmp_path / name))
        builder.build('ann.json', min=True)
    made = sorted(p.name for p in (tmp_path / 'torch').iterdir())
    assert made == sorted(p.name for p in (tmp_path / 'jax').iterdir())
    assert len(made) == 4  # the input, all classes, bases, all classes without empty images
    for f in made:
        assert (tmp_path / 'torch' / f).read_bytes() == (tmp_path / 'jax' / f).read_bytes(), f


def test_odps_equal(tmp_path, monkeypatch):
    import os

    from oadp_tpu.base import odps as jodps
    from oadp_torch.base import odps as todps

    assert todps.ODPS_PATHS == jodps.ODPS_PATHS
    links = {}
    for name, mod in (('jax', jodps), ('torch', todps)):
        monkeypatch.delenv('ODPS', raising=False)
        monkeypatch.delenv('OADP_TEST_KEY', raising=False)
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        mod.odps_init(dict(OADP_TEST_KEY='1'))
        assert os.environ['ODPS'] == os.environ['OADP_TEST_KEY'] == '1'
        links[name] = {p: os.readlink(p) for p in sorted(os.listdir('.'))}
    assert links['torch'] == links['jax'] and set(links['torch']) == set(todps.ODPS_PATHS)
