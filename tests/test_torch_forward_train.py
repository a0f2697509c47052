"""``forward_train`` of the port against ``oadp_tpu``'s, fp32 on the CPU, for
OV-COCO (C = 65, block and global heads) and OV-LVIS (C = 1203, masks) at the
mini geometry of ``tests/test_detector.py`` (ResNet stages (1, 1, 1, 1), FPN
32), from ``oadp_tpu``'s params (carried across by ``from_jax_params``) and
its draws: losses, new batch-norm statistics and per-leaf gradients; the
trainable masks and lr multipliers, and one full train step."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oadp_tpu.dp import trainer as jtrainer
from oadp_tpu.models import detector as jdet
from oadp_torch.dp import trainer as ttrainer
from oadp_torch.dp.synthetic import make_train_step
from oadp_torch.models import detector as tdet

torch.set_num_threads(1)

EMB_DIM = 16
CANVAS = 128
TRAIN_CFG = dict(rcnn_samples=32, rpn_samples=16, rpn_train_nms_pre=64, rpn_train_max=32,
                 rpn_test_nms_pre=64, rpn_test_max=32, rcnn_max_per_img=8)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def rel_close(got: torch.Tensor, want, rtol=1e-5, atol=1e-7, err_msg=''):
    np.testing.assert_allclose(got.detach().double().numpy(), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=err_msg)


# ---------------------------------------------------------------------------
# forward_train
# ---------------------------------------------------------------------------


def _mini_config(module, num_bases, num_all, **kw):
    """``tests/test_detector.py``'s tiny geometry in either package;
    ``norm_eval=False`` trains the backbone's batch norms."""
    kw = dict(kw)
    norm_eval = kw.pop('norm_eval', True)
    config = module.DetectorConfig.build(num_bases, num_all, backbone_style='caffe',
                                         **TRAIN_CFG, **kw)
    backbone = dataclasses.replace(config.backbone, base_channels=8, blocks=(1, 1, 1, 1),
                                   norm_eval=norm_eval)

    def head(h, convs=True):
        extra = dict(in_channels=32, conv_channels=32) if convs else dict(in_channels=32)
        return dataclasses.replace(h, fc_channels=64, classifier=dataclasses.replace(
            h.classifier, in_features=64, embedding_dim=EMB_DIM), **extra)

    return dataclasses.replace(
        config, backbone=backbone, fpn_channels=32, bbox_head=head(config.bbox_head),
        object_head=head(config.object_head), block_head=head(config.block_head, False),
        global_cls=dataclasses.replace(config.global_cls, in_features=32,
                                       embedding_dim=EMB_DIM),
        mask_head=dataclasses.replace(config.mask_head, num_convs=2, in_channels=32,
                                      conv_channels=32))


def _train_batch(num_all, b=2, g=4, k=6, o=8, masks=False, seed=1):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 80, (b, g, 2))
    gt = np.concatenate([xy, xy + rng.uniform(8, 40, (b, g, 2))], -1)
    oxy = rng.uniform(0, 80, (b, o, 2))
    ob = np.concatenate([oxy, oxy + rng.uniform(8, 40, (b, o, 2))], -1)
    bxy = rng.uniform(0, 60, (b, k, 2))
    bb = np.concatenate([bxy, bxy + rng.uniform(30, 60, (b, k, 2))], -1)
    batch = {
        'images': rng.standard_normal((b, CANVAS, CANVAS, 3)).astype(np.float32),
        'img_hw': np.asarray([[CANVAS, CANVAS], [120, 100]][:b], np.float32),
        'gt_boxes': gt.astype(np.float32),
        'gt_labels': rng.integers(0, min(num_all, 48), (b, g)).astype(np.int32),
        'gt_valid': np.asarray([[True] * (g - 1) + [False]] * b),
        'clip_global': rng.standard_normal((b, EMB_DIM)).astype(np.float32),
        'block_boxes': bb.astype(np.float32),
        'block_labels': (rng.random((b, k, num_all)) > 0.7).astype(np.float32),
        'clip_blocks': rng.standard_normal((b, k, EMB_DIM)).astype(np.float32),
        'block_valid': np.asarray([[True] * (k - 1) + [False]] * b),
        'object_boxes': ob.astype(np.float32),
        'clip_objects': rng.standard_normal((b, o, EMB_DIM)).astype(np.float32),
        'object_valid': np.asarray([[True] * (o - 1) + [False]] * b),
    }
    if masks:
        # a triangle inside each gt box, its corners off the RoI grid's lines
        # (a grid centre exactly on an edge is a tie that either side may
        # break), and an empty second part
        tri = np.full((b, g, 2, 6, 2), -1e6, np.float32)
        frac = np.asarray([(0.13, 0.07), (0.95, 0.21), (0.31, 0.91)] * 2)
        for i in range(b):
            for j in range(g):
                x0, y0, x1, y1 = gt[i, j]
                tri[i, j, 0] = np.asarray([x0, y0]) + frac * np.asarray([x1 - x0, y1 - y0])
        batch['gt_polygons'] = tri
    return batch


def jax_draws(key, config, b: int, num_anchors: int, g: int) -> dict[str, np.ndarray]:
    """``oadp_tpu``'s uniform draws of one train step under ``key``:
    ``split(key)`` into the RPN's and the RCNN's, ``split`` of each over the
    images, one ``uniform`` an image."""
    k_rpn, k_rcnn = jax.random.split(key)
    return {
        'rpn': np.stack([np.asarray(jax.random.uniform(k, (num_anchors,)))
                         for k in jax.random.split(k_rpn, b)]),
        'rcnn': np.stack([np.asarray(jax.random.uniform(k, (g + config.rpn_train_max,)))
                          for k in jax.random.split(k_rcnn, b)]),
    }


def _torch_batch(batch):
    out = {k: t(v) for k, v in batch.items()}
    out['images'] = tdet.ingest_images(out['images'])
    return out


CASES = {
    'ov_coco': (48, 65, dict(), False),
    # every backbone stage's batch norm in train mode, the frozen ones too,
    # on the batch of seed 2 (seed 1's holds a ReLU tie:
    # test_backbone_bn_train_relu_tie)
    'ov_coco_backbone_bn_train': (48, 65, dict(norm_eval=False, batch_seed=2), False),
    'ov_lvis_masks': (866, 1203, dict(with_mask=True, head_cls_mode='vild',
                                      vild_scaler_train=0.01, vild_scaler_val=0.007,
                                      global_vild_scaler=(0.007, 0.01)), True),
}
KEY_SEED = 3


def _setup(nb, na, kw, masks):
    """A case's configs in both packages, ``oadp_tpu``'s params and
    statistics (numpy) and its batch."""
    kw = dict(kw)
    batch_seed = kw.pop('batch_seed', 1)
    jcfg, tcfg = _mini_config(jdet, nb, na, **kw), _mini_config(tdet, nb, na, **kw)
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((na, EMB_DIM)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    jparams, jstats = jdet.init_detector(jax.random.key(0), jcfg, jnp.asarray(emb))
    jparams, jstats = jax.tree.map(np.asarray, jparams), jax.tree.map(np.asarray, jstats)
    return jcfg, tcfg, jparams, jstats, _train_batch(na, masks=masks, seed=batch_seed)


def _jax_run(jcfg, jparams, jstats, batch, step):
    """``oadp_tpu``'s ``forward_train`` under ``jit``: losses, new stats and
    the gradients of the loss sum, as numpy trees."""
    from oadp_tpu.dp import builder as jbuilder

    janchors = [jnp.asarray(a) for a in jbuilder.canvas_anchors(jcfg, (CANVAS, CANVAS))]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def total(p):
        losses, new_stats = jdet.forward_train(p, jstats, jbatch, jcfg, janchors,
                                               jnp.asarray(step), jax.random.key(KEY_SEED))
        return sum(v for k, v in losses.items() if k.startswith('loss')), (losses, new_stats)

    (_, (jl, js)), jg = jax.jit(jax.value_and_grad(total, has_aux=True))(jparams)
    return tuple(jax.tree.map(np.asarray, x) for x in (jl, js, jg))


def _torch_run(jcfg, tcfg, jparams, jstats, batch, step, dtype=torch.float32):
    """The port's ``forward_train`` from ``oadp_tpu``'s params and draws, in
    ``dtype``: losses, new stats and the gradients of the loss sum."""
    from oadp_torch.dp import builder as tbuilder
    from oadp_torch.models.clip import map_params

    def cast(x):
        return x.to(dtype) if x.is_floating_point() else x

    params, stats = (map_params(tree, cast) for tree in tdet.from_jax_params(jparams, jstats))
    leaves = [p.requires_grad_(True) for p in ttrainer._leaves(params)]
    tanchors = [cast(a) for a in tbuilder.canvas_anchors(tcfg, (CANVAS, CANVAS))]
    draws = {k: t(v) for k, v in jax_draws(jax.random.key(KEY_SEED), jcfg, 2,
                                           sum(len(a) for a in tanchors),
                                           batch['gt_boxes'].shape[1]).items()}
    tbatch = {k: cast(v) for k, v in _torch_batch(batch).items()}
    losses, new_stats = tdet.forward_train(params, stats, tbatch, tcfg, tanchors, step, draws)
    tot = sum(v for k, v in losses.items() if k.startswith('loss'))
    grads = torch.autograd.grad(tot, leaves, allow_unused=True)
    return losses, new_stats, ttrainer._like(params, list(grads))


@functools.lru_cache()
def _forward(case: str, step: int = 300):
    """One ``forward_train`` of both packages from ``oadp_tpu``'s params and
    draws: losses, new stats and the gradients of the loss sum."""
    jcfg, tcfg, jparams, jstats, batch = _setup(*CASES[case])
    want = _jax_run(jcfg, jparams, jstats, batch, step)
    got = _torch_run(jcfg, tcfg, jparams, jstats, batch, step)
    return got, want, (jparams, jstats)


def _check_losses(losses, want, masks: bool):
    assert set(losses) == set(want)
    for k in want:
        if k == 'acc' or k.startswith('recall'):
            # counts, equal but for the fp32 rounding of the macro sum's order
            assert float(losses[k]) == pytest.approx(float(want[k]), rel=1e-6), k
        else:
            rel_close(losses[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert float(losses['loss_cls'].detach()) > 0 and float(losses['loss_rpn_cls'].detach()) > 0
    if masks:
        assert float(losses['loss_mask'].detach()) > 0


def _check_new_stats(new_stats, want, jstats, norm_eval: bool):
    """Every new statistic at atol 1e-5; the backbone's move iff its batch
    norms train."""
    want_t = tdet.from_jax_params(want, want)[1]
    for path, got in _items(new_stats):
        np.testing.assert_allclose(got.detach().numpy(), _at(want_t, path).numpy(), atol=1e-5,
                                   rtol=0, err_msg=str(path))
    before = tdet.from_jax_params(jstats, jstats)[1]['backbone']
    moved = [not torch.equal(got, _at(before, path))
             for path, got in _items(new_stats['backbone'])]
    assert all(moved) if not norm_eval else not any(moved)


def _check_gradients(grads, want, jstats):
    """Per leaf: cosine >= 0.9999 and max abs <= 1e-3 of the leaf's largest;
    the leaves that ``oadp_tpu`` stops (zero gradient) take none here."""
    want_t = tdet.from_jax_params(want, jstats)[0]
    for path, g in _items(grads, keep_none=True):
        w = _at(want_t, path).double()
        scale = float(w.abs().max())
        if g is None or scale == 0:
            assert scale == 0 and (g is None or float(g.abs().max()) == 0), path
            continue
        g = g.double()
        cos = float((g * w).sum() / (g.norm() * w.norm()))
        assert cos >= 0.9999, (path, cos)
        assert float((g - w).abs().max()) <= 1e-3 * scale, path


@pytest.mark.parametrize('case', list(CASES))
def test_forward_train_losses(case):
    (losses, _, _), (want, _, _), _ = _forward(case)
    _check_losses(losses, want, CASES[case][3])


@pytest.mark.parametrize('case', list(CASES))
def test_forward_train_new_stats(case):
    (_, new_stats, _), (_, want, _), (_, jstats) = _forward(case)
    _check_new_stats(new_stats, want, jstats, CASES[case][2].get('norm_eval', True))


@pytest.mark.parametrize('case', list(CASES))
def test_forward_train_gradients(case):
    (_, _, grads), (_, _, want), (_, jstats) = _forward(case)
    _check_gradients(grads, want, jstats)


def test_backbone_bn_train_relu_tie(monkeypatch):
    """Every backbone batch norm training, on seed 1's batch. The heads'
    batch-norm outputs (their pre-ReLU values) of the port and ``oadp_tpu``
    differ in sign at one unit alone, in the bbox head's first conv, and
    that unit is a tie: its value in a run of the port in fp64 lies below
    the port's own fp32 deviation from that run over the tensor, so fp32
    does not settle its sign. The ReLU's choice there moves every gradient
    above it (the FPN's and the backbone's by ~1e-3 of their largest, that
    conv's by ~5e-3). With that one value set to ``oadp_tpu``'s, losses,
    new statistics and every gradient meet the tolerances of the cases
    above."""
    from oadp_torch.models import heads as theads
    from oadp_tpu.models import heads as jheads

    setup = _setup(48, 65, dict(norm_eval=False, batch_seed=1), False)
    jcfg, tcfg, jparams, jstats, batch = setup

    # oadp_tpu: each head batch norm's output, by its place in the trace
    jbn, jout = jheads.batch_norm, {}

    def jax_probe(x, p, s, train, mask=None):
        y, ns = jbn(x, p, s, train, mask=mask)
        jax.debug.callback(functools.partial(jout.__setitem__, len(jout)), y)
        jout[len(jout)] = None
        return y, ns

    monkeypatch.setattr(jheads, 'batch_norm', jax_probe)
    want = _jax_run(jcfg, jparams, jstats, batch, 300)
    monkeypatch.setattr(jheads, 'batch_norm', jbn)
    jx = [np.asarray(jout[i]).transpose(0, 3, 1, 2) for i in range(len(jout))]  # NHWC -> NCHW

    tbn, tout = theads.batch_norm_train, []

    class Stop(Exception):
        pass

    def torch_probe(*a, stop=False, **k):
        y, ns = tbn(*a, **k)
        tout.append(y.detach().double().numpy())
        if stop:
            raise Stop
        return y, ns

    monkeypatch.setattr(theads, 'batch_norm_train', torch_probe)
    _, _, grads = _torch_run(jcfg, tcfg, jparams, jstats, batch, 300)
    t32, tout[:] = list(tout), []
    # fp64, up to the bbox head's first batch norm
    monkeypatch.setattr(theads, 'batch_norm_train', functools.partial(torch_probe, stop=True))
    with pytest.raises(Stop):
        _torch_run(jcfg, tcfg, jparams, jstats, batch, 300, dtype=torch.float64)
    t64 = tout[0]

    assert len(t32) == len(jx) == 8 and all(a.shape == b.shape for a, b in zip(t32, jx))
    flips = [(i, tuple(u)) for i, (a, b) in enumerate(zip(t32, jx))
             for u in np.argwhere(np.sign(a) != np.sign(b))]
    assert len(flips) == 1 and flips[0][0] == 0, flips
    unit = tuple(int(u) for u in flips[0][1])
    v32, vjax, v64 = float(t32[0][unit]), float(jx[0][unit]), float(t64[unit])
    fp32_dev = float(np.abs(t32[0] - t64).max())
    print(f'unit {unit}: port fp32 {v32:.6e}, oadp_tpu fp32 {vjax:.6e}, port fp64 {v64:.6e}; '
          f'port fp32 - fp64 over the tensor: max {fp32_dev:.6e}; tensor max '
          f'{float(np.abs(t64).max()):.6e}')
    assert abs(v64) < fp32_dev and abs(v32) < fp32_dev and abs(vjax) < fp32_dev
    want_g = tdet.from_jax_params(want[2], jstats)[0]
    off = {path: float((g.double() - _at(want_g, path).double()).abs().max()
                       / _at(want_g, path).double().abs().max())
           for path, g in _items(grads) if float(_at(want_g, path).abs().max()) > 0}
    worst = max(off, key=off.get)
    print(f'as the port rounds it: {sum(v > 1e-3 for v in off.values())} of {len(off)} '
          f'gradients off by more than 1e-3 of their largest, at most {off[worst]:.3e} '
          f'({worst})')

    calls = []

    def tie_at_jax(*a, **k):
        y, ns = tbn(*a, **k)
        if not calls:  # the bbox head's first batch norm
            y = y.clone()
            y[unit] = vjax
        calls.append(unit)
        return y, ns

    monkeypatch.setattr(theads, 'batch_norm_train', tie_at_jax)
    losses, new_stats, grads = _torch_run(jcfg, tcfg, jparams, jstats, batch, 300)
    _check_losses(losses, want[0], False)
    _check_new_stats(new_stats, want[1], jstats, False)
    _check_gradients(grads, want[2], jstats)


def _items(tree, path=(), keep_none=False):
    """``(path, leaf)`` of a parameter tree."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _items(v, path + (k,), keep_none)]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _items(v, path + (i,), keep_none)]
    return [(path, tree)] if tree is not None or keep_none else []


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree



def test_masks_and_multipliers_match():
    (_, _, _), _, (jparams, jstats) = _forward('ov_coco')
    jcfg = _mini_config(jdet, 48, 65)
    params, _ = tdet.from_jax_params(jparams, jstats)
    want_mask = jtrainer.trainable_mask_tree(jparams, jcfg)
    want_mult = jtrainer._lr_mult_tree(jparams, {'bbox_head': 0.5})
    got_mask = ttrainer.trainable_mask_tree(params, _mini_config(tdet, 48, 65))
    got_mult = ttrainer._lr_mult_tree(params, {'bbox_head': 0.5})
    assert [p for p, _ in _items(got_mask)] == [p for p, _ in _items(params)]
    for path, flag in _items(got_mask):
        assert flag == bool(_at(want_mask, path)), path
        assert _at(got_mult, path) == float(_at(want_mult, path)), path
    n_frozen = sum(not f for _, f in _items(got_mask))
    assert n_frozen > 10 and not _at(got_mask, ('object_head', 'cls', 'bg'))
    assert _at(got_mask, ('bbox_head', 'cls', 'bg'))


def test_one_full_step_matches():
    """The port's train step (losses, autograd, SGD) from ``oadp_tpu``'s
    params and draws against ``oadp_tpu``'s gradients through its
    ``sgd_update``: params after the step at atol 1e-5."""
    from oadp_torch.dp import builder as tbuilder

    (_, _, _), (_, _, jgrads), (jparams, jstats) = _forward('ov_coco')
    jcfg, tcfg = _mini_config(jdet, 48, 65), _mini_config(tdet, 48, 65)
    lr = jtrainer.lr_at(jnp.asarray(300), 0.02, (30000,))
    want, _ = jtrainer.sgd_update(
        jax.tree.map(jnp.asarray, jparams), jax.tree.map(jnp.asarray, jgrads),
        jax.tree.map(jnp.zeros_like, jparams), lr,
        jtrainer._lr_mult_tree(jparams, {'bbox_head': 0.5}), 0.9, 2.5e-5,
        jtrainer.trainable_mask_tree(jparams, jcfg))
    want_t = tdet.from_jax_params(jax.tree.map(np.asarray, want), jstats)[0]
    params, stats = tdet.from_jax_params(jparams, jstats)
    anchors = tbuilder.canvas_anchors(tcfg, (CANVAS, CANVAS))
    step_fn = ttrainer.build_train_step(
        tcfg, anchors, ttrainer._lr_mult_tree(params, {'bbox_head': 0.5}),
        ttrainer.trainable_mask_tree(params, tcfg), base_lr=0.02, milestones=(30000,))
    batch = _train_batch(65)
    draws = {k: t(v) for k, v in jax_draws(jax.random.key(KEY_SEED), jcfg, 2,
                                           sum(len(a) for a in anchors), 4).items()}
    got, _, _, losses = step_fn(params, stats, ttrainer.sgd_init(params), _torch_batch(batch),
                                300, draws)
    assert losses['lr'] == float(lr)
    for path, g in _items(got):
        np.testing.assert_allclose(g.detach().numpy(), _at(want_t, path).numpy(), atol=1e-5,
                                   rtol=0, err_msg=str(path))
    # dp/synthetic's adapter runs the same step and returns its total
    params, stats = tdet.from_jax_params(jparams, jstats)
    step = make_train_step(tcfg, anchors, ttrainer._lr_mult_tree(params, {'bbox_head': 0.5}),
                           ttrainer.trainable_mask_tree(params, tcfg), base_lr=0.02)
    *_, total = step(params, stats, ttrainer.sgd_init(params), _torch_batch(batch), 300, draws)
    assert torch.equal(total, losses['total'])


