"""The port's framework-free copies (``oadp_torch.utils``,
``oadp_torch.ops.boxes``) against their ``oadp_tpu`` originals: the same
config parse with ``_base_`` and ``--override``, byte-identical ``.pth``
files, the same box algebra; and the rank/world-size probe."""

import argparse

import numpy as np
import pytest

from oadp_tpu.ops import boxes as jboxes
from oadp_tpu.utils import config as jconfig
from oadp_tpu.utils import pth as jpth
from oadp_torch.ops import boxes as tboxes
from oadp_torch.utils import config as tconfig
from oadp_torch.utils import dist, pth as tpth
from oadp_torch.utils import Store


@pytest.mark.parametrize('name', ['objects_coco', 'objects_lvis', 'globals'])
def test_config_parse_equal(name):
    path = f'configs/oake/{name}.py'
    pairs = ['.model.device:"cpu"', '.batch_size:3', '.val.x.y:[1, 2]']
    parsed = []
    for mod in (jconfig, tconfig):
        cfg = mod.Config.load(path)
        parser = argparse.ArgumentParser()
        parser.add_argument('--override', action=mod.DictAction, nargs='+')
        cfg.override(parser.parse_args(['--override', *pairs]).override)
        parsed.append(cfg)
    assert parsed[0] == parsed[1]
    assert parsed[1].model.device == 'cpu' and parsed[1].val.x.y == [1, 2]


def test_pth_files_byte_identical(tmp_path):
    rec = dict(
        embeddings=np.random.RandomState(0).randn(5, 8).astype(np.float16),
        bboxes=np.arange(20, dtype=np.float16).reshape(5, 4),
    )
    (tmp_path / 'jax').mkdir()
    (tmp_path / 'torch').mkdir()
    jpth.save_pth(rec, tmp_path / 'jax' / 'r.pth')
    tpth.save_pth(rec, tmp_path / 'torch' / 'r.pth')
    assert (tmp_path / 'jax' / 'r.pth').read_bytes() == (
        tmp_path / 'torch' / 'r.pth').read_bytes()
    for sub in ('jax', 'torch'):
        for load in (jpth.load_pth, tpth.load_pth):
            back = load(tmp_path / sub / 'r.pth')
            for k in rec:
                np.testing.assert_array_equal(back[k], rec[k])


def test_boxes_equal():
    rng = np.random.RandomState(1)
    props = np.stack([
        rng.uniform(0, 300, 20), rng.uniform(0, 200, 20),
        rng.uniform(300, 640, 20), rng.uniform(200, 480, 20),
    ], -1).astype(np.float32)
    for mode in ('ADAPTIVE', 'CONSTANT', 'LONGEST_EDGE', 'RECTANGLE'):
        np.testing.assert_array_equal(
            tboxes.expand_boxes(props, 640, 480, mode),
            jboxes.expand_boxes(props, 640, 480, mode),
        )
    crops = tboxes.expand_boxes(props, 640, 480)
    fg = props - np.concatenate([crops[:, :2], crops[:, :2]], -1)
    np.testing.assert_array_equal(
        tboxes.grid_mask(fg, crops, 14), jboxes.grid_mask(fg, crops, 14)
    )
    np.testing.assert_array_equal(
        tboxes.filter_min_wh(props, 4, 4), jboxes.filter_min_wh(props, 4, 4)
    )


def test_rank_and_world_size(monkeypatch):
    monkeypatch.delenv('RANK', raising=False)
    monkeypatch.delenv('WORLD_SIZE', raising=False)
    assert (dist.rank(), dist.world_size()) == (0, 1)
    monkeypatch.setenv('RANK', '2')
    monkeypatch.setenv('WORLD_SIZE', '4')
    assert (dist.rank(), dist.world_size()) == (2, 4)


def test_store_flags(monkeypatch):
    monkeypatch.setenv('DRY_RUN', 'yes')
    monkeypatch.setenv('CPU', '1')
    assert Store.DRY_RUN and not Store.CUDA
