"""``oadp_torch.oake.partitions`` is a copy of ``oadp_tpu.oake.partitions``:
the same block plans and whole-image boxes over a sweep of image sizes,
sides below the block size included."""

import dataclasses
import itertools

import pytest

from oadp_torch.oake import partitions as tp
from oadp_tpu.oake import partitions as jp

def _plan(mod, *args):
    return dataclasses.asdict(mod.plan_blocks(*args))


SIDES = (1, 100, 223, 224, 225, 300, 335, 336, 337, 427, 480, 500, 612, 640)


@pytest.mark.parametrize('w', SIDES)
def test_plans_match(w):
    for h in SIDES:
        assert _plan(tp, w, h) == _plan(jp, w, h), (w, h)
        assert tp.first_block_bbox(w, h) == jp.first_block_bbox(w, h), (w, h)


def test_plans_match_other_settings():
    for (w, h), (block, stride, rescale) in itertools.product(
        ((640, 480), (333, 999), (150, 160)),
        ((224, 112, 1.5), (128, 64, 2.0), (224, 224, 1.25)),
    ):
        args = (w, h, block, stride, rescale)
        assert _plan(tp, *args) == _plan(jp, *args), args


def test_small_images_have_no_blocks():
    plan = tp.plan_blocks(200, 480)
    assert plan.levels == [(200, 480)] and plan.blocks == [] and plan.bboxes == []
