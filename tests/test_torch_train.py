"""The port's DP training path against ``oadp_tpu``'s, fp32 on the CPU:
every loss (values and gradients), ``max_iou_assign`` and ``random_sample``
(identical indices from ``oadp_tpu``'s draw), train-mode batch norm with its
new statistics, ``lr_at`` and ``sgd_update``, and a deterministic resume
(``tests/test_torch_forward_train.py`` holds ``forward_train`` and one full
step)."""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oadp_tpu.base import losses as jlosses
from oadp_tpu.dp import trainer as jtrainer
from oadp_tpu.models import layers as jlayers
from oadp_tpu.ops import assign as jassign
from oadp_torch.base import losses as tlosses
from oadp_torch.dp import trainer as ttrainer
from oadp_torch.models import detector as tdet
from oadp_torch.models import layers as tlayers
from oadp_torch.ops import assign as tassign


def _sibling(name: str):
    """A module of this directory, loaded by path: on a host where an
    installed package is also called ``tests``, ``import tests.x`` finds
    that one (this directory has no ``__init__.py``)."""
    spec = importlib.util.spec_from_file_location(f'_{name}', pathlib.Path(__file__).with_name(
        f'{name}.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_forward_train = _sibling('test_torch_forward_train')
EMB_DIM, _items, _mini_config, _train_batch, rel_close, t = (
    getattr(_forward_train, k) for k in ('EMB_DIM', '_items', '_mini_config', '_train_batch',
                                         'rel_close', 't'))

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# losses: values and gradients
# ---------------------------------------------------------------------------


def _loss_cases():
    rng = np.random.default_rng(0)
    n, k = 9, 7
    logits = rng.standard_normal((n, k)).astype(np.float32) * 3
    probs = 1 / (1 + np.exp(-logits))
    targets = rng.random((n, k)) > 0.6
    mask = np.ones(n, bool)
    mask[[2, 5]] = False
    a = rng.standard_normal((n, 5)).astype(np.float32)
    b = rng.standard_normal((n, 5)).astype(np.float32)
    c = rng.standard_normal((n, 6)).astype(np.float32)
    labels = rng.integers(0, k, n).astype(np.int32)
    w = (rng.random(n) > 0.3).astype(np.float32)
    small = rng.uniform(-2, 2, (n, 4)).astype(np.float32)
    return {
        # name: (fn over (jax|torch module, differentiable input, others), x, others)
        'asymmetric': (lambda L, x, m: L.asymmetric_loss(x, arr_of(L, targets), m),
                       probs, mask),
        'asymmetric_unmasked': (lambda L, x, m: L.asymmetric_loss(x, arr_of(L, targets)),
                                probs, None),
        'asymmetric_pos_gamma': (lambda L, x, m: L.asymmetric_loss(
            x, arr_of(L, targets), m, gamma_neg=2, gamma_pos=1), probs, mask),
        'rkd': (lambda L, x, m: L.rkd_loss(x, arr_of(L, c), m), a, mask),
        'rkd_unmasked': (lambda L, x, m: L.rkd_loss(x, arr_of(L, c)), a, None),
        'l1': (lambda L, x, m: L.l1_loss(x, arr_of(L, b), m), a, mask),
        'mse': (lambda L, x, m: L.mse_loss(x, arr_of(L, b), m), a, mask),
        'mse_sum': (lambda L, x, m: L.mse_loss(x, arr_of(L, b), m, reduction='sum'), a, mask),
        'bce': (lambda L, x, m: L.binary_cross_entropy(x, arr_of(L, targets.astype(np.float32)),
                                                       None, 5.0), logits, None),
        'bce_weighted': (lambda L, x, m: L.binary_cross_entropy(
            x, arr_of(L, targets.astype(np.float32)), arr_of(L, targets.astype(np.float32))),
            logits, None),
        'softmax_ce': (lambda L, x, m: L.softmax_cross_entropy(x, arr_of(L, labels),
                                                               arr_of(L, w), 4.0), logits, None),
        'softmax_ce_mean': (lambda L, x, m: L.softmax_cross_entropy(x, arr_of(L, labels)),
                            logits, None),
        'smooth_l1': (lambda L, x, m: L.smooth_l1_loss(x, arr_of(L, b[:, :4]), 0.5,
                                                       arr_of(L, np.ones((n, 4), np.float32)),
                                                       7.0), small, None),
    }


def arr_of(L, x):
    return jnp.asarray(x) if L is jlosses else t(x)


@pytest.mark.parametrize('name', list(_loss_cases()))
def test_loss_values_and_gradients(name):
    fn, x, mask = _loss_cases()[name]
    jmask = None if mask is None else jnp.asarray(mask)
    want, want_grad = jax.value_and_grad(lambda v: fn(jlosses, v, jmask))(jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    got = fn(tlosses, xt, None if mask is None else t(mask))
    (grad,) = torch.autograd.grad(got, xt)
    rel_close(got, want, err_msg=name)
    rel_close(grad, want_grad, atol=1e-7, err_msg=name)


@pytest.mark.parametrize('masked', [False, True])
def test_topk_recall_and_warmup(masked):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((12, 9)).astype(np.float32)
    logits[3, :4] = logits[3, 4]  # ties at the threshold
    targets = rng.random((12, 9)) > 0.7
    mask = rng.random(12) > 0.3 if masked else None
    for k in (1, 3, 20):
        want = jlosses.multilabel_topk_recall(
            jnp.asarray(logits), jnp.asarray(targets), k,
            None if mask is None else jnp.asarray(mask))
        got = tlosses.multilabel_topk_recall(t(logits), t(targets), k,
                                             None if mask is None else t(mask))
        assert float(got) == float(want), (k, float(got), float(want))
    for step in (0, 1, 7, 199, 200, 5000):
        assert tlosses.warmup_weight(step, 256.0, 200) == float(
            jlosses.warmup_weight(jnp.asarray(step), 256.0, 200))


# ---------------------------------------------------------------------------
# assignment and sampling
# ---------------------------------------------------------------------------


def _boxes(rng, n, lo=0, hi=100, size=(4, 40)):
    xy = rng.uniform(lo, hi, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(*size, (n, 2))], -1).astype(np.float32)


ASSIGN_CASES = {
    'rpn_like': dict(p=300, g=6, pos=0.7, neg=0.3, min_pos=0.3, low=True),
    'rcnn_like': dict(p=120, g=5, pos=0.5, neg=0.5, min_pos=0.5, low=False),
    'no_valid_gt': dict(p=50, g=3, pos=0.7, neg=0.3, min_pos=0.3, low=True, no_gt=True),
    'duplicate_boxes': dict(p=80, g=4, pos=0.7, neg=0.3, min_pos=0.3, low=True, dup=True),
}


@pytest.mark.parametrize('case', list(ASSIGN_CASES))
def test_max_iou_assign_exact(case):
    c = ASSIGN_CASES[case]
    rng = np.random.default_rng(5)
    boxes = _boxes(rng, c['p'])
    gts = _boxes(rng, c['g'])
    if c.get('dup'):  # ties: boxes equal to gts, and repeated boxes
        boxes[:c['g']] = gts
        boxes[c['g']:2 * c['g']] = gts
    box_valid = rng.random(c['p']) > 0.1
    gt_valid = np.ones(c['g'], bool)
    gt_valid[-1] = False
    if c.get('no_gt'):
        gt_valid[:] = False
    args = (c['pos'], c['neg'], c['min_pos'], c['low'])
    want = jassign.max_iou_assign(jnp.asarray(boxes), jnp.asarray(box_valid), jnp.asarray(gts),
                                  jnp.asarray(gt_valid), *args)
    got = tassign.max_iou_assign(t(boxes), t(box_valid), t(gts), t(gt_valid), *args)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


SAMPLE_CASES = {
    # P, num, pos_fraction, share of positives, share of negatives
    'typical': (400, 64, 0.25, 0.1, 0.6),
    'few_positives': (300, 64, 0.5, 0.01, 0.8),
    'few_candidates': (40, 64, 0.25, 0.2, 0.3),
    'fewer_boxes_than_slots': (20, 64, 0.5, 0.3, 0.5),
    'ties_in_draw': (200, 32, 0.5, 0.2, 0.6),
}


@pytest.mark.parametrize('case', list(SAMPLE_CASES))
def test_random_sample_identical_indices(case):
    p, num, frac, pos, neg = SAMPLE_CASES[case]
    rng = np.random.default_rng(7)
    r = rng.random(p)
    assigned = np.where(r < pos, rng.integers(1, 5, p), np.where(r < pos + neg, 0, -1))
    assigned = assigned.astype(np.int32)
    u = np.asarray(jax.random.uniform(jax.random.key(11), (p,)))
    if case == 'ties_in_draw':  # a draw with repeated values
        u = np.round(u * 8) / 8
    want = _jax_sample_with_draw(jnp.asarray(u, jnp.float32), jnp.asarray(assigned), num, frac)
    got = tassign.random_sample(t(u).float(), t(assigned), num, frac)
    for g, w, name in zip(got, want, ('inds', 'valid', 'is_pos')):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert got[1].any()


def _jax_sample_with_draw(u, assigned, num, frac):
    """``oadp_tpu``'s ``random_sample`` with its draw replaced by ``u``."""
    real = jax.random.uniform
    try:
        jax.random.uniform = lambda key, shape: u
        return jassign.random_sample(jax.random.key(0), assigned, num, frac)
    finally:
        jax.random.uniform = real


# ---------------------------------------------------------------------------
# train-mode batch norm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_batch_norm_train(masked, dtype):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((6, 5, 4, 3)) * 2 + 1).astype(np.float32)  # NHWC
    p = {'scale': rng.uniform(0.5, 1.5, 3).astype(np.float32),
         'bias': rng.standard_normal(3).astype(np.float32)}
    s = {'mean': rng.standard_normal(3).astype(np.float32),
         'var': rng.uniform(0.5, 2, 3).astype(np.float32)}
    mask = np.array([1, 0, 1, 1, 0, 1], bool) if masked else None
    jdt = jnp.bfloat16 if dtype == 'bfloat16' else jnp.float32
    tdt = torch.bfloat16 if dtype == 'bfloat16' else torch.float32
    want, want_s = jlayers.batch_norm(jnp.asarray(x, jdt), jax.tree.map(jnp.asarray, p),
                                      jax.tree.map(jnp.asarray, s), True,
                                      mask=None if mask is None else jnp.asarray(mask))
    got, got_s = tlayers.batch_norm_train(
        t(x.transpose(0, 3, 1, 2).copy()).to(tdt), {k: t(v) for k, v in p.items()},
        {k: t(v) for k, v in s.items()}, mask=None if mask is None else t(mask))
    atol = 2e-2 if dtype == 'bfloat16' else 1e-5
    np.testing.assert_allclose(got.float().numpy().transpose(0, 2, 3, 1),
                               np.asarray(want.astype(jnp.float32)), atol=atol, rtol=0)
    for k in ('mean', 'var'):
        np.testing.assert_allclose(got_s[k].numpy(), np.asarray(want_s[k]), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# SGD, the schedule, one full step, resume
# ---------------------------------------------------------------------------


def test_lr_at_matches():
    for step in (0, 1, 250, 499, 500, 501, 29999, 30000, 35000, 40000):
        for milestones in ((), (30000,), (16, 19), (500, 30000)):
            want = float(jtrainer.lr_at(jnp.asarray(step), 0.02, milestones))
            assert ttrainer.lr_at(step, 0.02, milestones) == want, (step, milestones)


def test_sgd_update_matches():
    rng = np.random.default_rng(4)
    shapes = {'a': {'w': (3, 4), 'b': (4,)}, 'bbox_head': {'w': (5,), 'e': (2, 2)}}
    jp = {k: {n: rng.standard_normal(s).astype(np.float32) for n, s in v.items()}
          for k, v in shapes.items()}
    jg = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32), jp)
    jb = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32), jp)
    # key order as jax.tree.map leaves it (sorted): the trees are zipped by leaf
    flags = {'a': {'b': True, 'w': True}, 'bbox_head': {'e': False, 'w': True}}
    mults = jtrainer._lr_mult_tree(jp, {'bbox_head': 0.5})
    want_p, want_b = jtrainer.sgd_update(jax.tree.map(jnp.asarray, jp),
                                         jax.tree.map(jnp.asarray, jg),
                                         jax.tree.map(jnp.asarray, jb), jnp.asarray(0.01), mults,
                                         0.9, 1e-3, flags)
    tp, tb = (jax.tree.map(t, x) for x in (jp, jb))
    got_p, got_b = ttrainer.sgd_update(tp, jax.tree.map(t, jg), tb, 0.01,
                                       ttrainer._lr_mult_tree(tp, {'bbox_head': 0.5}), 0.9,
                                       1e-3, flags)
    for k in shapes:
        for n in shapes[k]:
            np.testing.assert_allclose(got_p[k][n].numpy(), np.asarray(want_p[k][n]), atol=1e-7)
            np.testing.assert_allclose(got_b[k][n].numpy(), np.asarray(want_b[k][n]), atol=1e-7)
    assert np.array_equal(got_p['bbox_head']['e'].numpy(), jp['bbox_head']['e'])


class _Loader:
    """A loader of fixed synthetic batches, ``Loader``'s interface."""

    def __init__(self, n: int):
        self.batches = []
        for i in range(n):
            b = _train_batch(65, seed=10 + i)
            b['images'] = (b['images'] * 40 + 120).clip(0, 255).astype(np.uint8)
            b.update(image_ids=np.arange(2), scale_factor=np.ones((2, 4), np.float32))
            self.batches.append(b)

    def __len__(self):
        return len(self.batches)

    def epoch(self, epoch: int = 0, start: int = 0):
        order = np.random.RandomState(epoch).permutation(len(self.batches))
        for i in order[start:]:
            yield dict(self.batches[i])


def _trainer(work, schedule: dict, evaluator=None, device='cpu'):
    from oadp_torch.dp.builder import DetectorBundle
    from oadp_torch.utils import Config

    cfg = _mini_config(tdet, 48, 65)
    rng = np.random.default_rng(0)
    emb = torch.nn.functional.normalize(t(rng.standard_normal((65, EMB_DIM)).astype(np.float32)),
                                        dim=-1)
    params, stats = tdet.init_detector(torch.Generator().manual_seed(0), cfg, emb)
    trainer_cfg = Config(dict(
        optimizer=dict(lr=0.02, paramwise=dict(bbox_head=dict(lr_mult=0.5))),
        log_config=dict(interval=1), seed=5, **schedule))
    return ttrainer.Trainer(DetectorBundle(cfg, params, stats), trainer_cfg, _Loader(3), work,
                            evaluator=evaluator, device=device)


def _fit(work, max_iters, resume=None):
    trainer = _trainer(work, dict(
        lr_config=dict(by_epoch=False, step=[3], warmup_iters=2),
        runner=dict(type='IterBasedRunner', max_iters=max_iters),
        checkpoint_config=dict(by_epoch=False, interval=2), evaluation=dict(interval=10 ** 9)))
    return trainer.fit(None if resume is None else ttrainer.Trainer.restore(resume))


def test_epoch_based_hooks(tmp_path):
    """An epoch-based run (3 batches an epoch, 2 epochs): a checkpoint at
    each epoch's end, the eval hook every epoch, the lr milestone counted
    in epochs."""
    calls = []

    class Evaluator:
        def run(self, params, stats):
            calls.append(len(calls))
            return {}

    trainer = _trainer(tmp_path, dict(
        lr_config=dict(by_epoch=True, step=[1], warmup_iters=1),
        runner=dict(type='EpochBasedRunner', max_epochs=2),
        checkpoint_config=dict(by_epoch=True, interval=1), evaluation=dict(interval=1)),
        Evaluator())
    assert trainer._milestone_iters(3) == (3,)
    state = trainer.fit()
    assert state.step == 6 and calls == [0, 1]
    assert sorted(p.name for p in tmp_path.glob('ckpt_*.pth')) == ['ckpt_3.pth', 'ckpt_6.pth']
    assert ttrainer.lr_at(2, 0.02, (3,), 1) == pytest.approx(0.02)
    assert ttrainer.lr_at(3, 0.02, (3,), 1) == pytest.approx(0.002)


def test_trainer_defaults_to_the_card(tmp_path):
    """``Trainer`` runs on the card unless asked for the CPU: without one it
    raises rather than train on the CPU; asked for the CPU, it holds the
    bundle there."""
    from oadp_torch.utils import Config

    trainer = _trainer(tmp_path, {})
    assert trainer.device == torch.device('cpu')
    assert all(p.device.type == 'cpu' for _, p in _items(trainer.bundle.params))
    if torch.cuda.is_available():
        trainer = ttrainer.Trainer(trainer.bundle, Config(), None, tmp_path)
        assert trainer.device.type == 'cuda'
        assert all(p.device.type == 'cuda' for _, p in _items(trainer.bundle.params))
    else:
        with pytest.raises(RuntimeError, match='no CUDA device'):
            ttrainer.Trainer(trainer.bundle, Config(), None, tmp_path)


def test_resume_is_bit_exact(tmp_path):
    """Steps 1-2, a checkpoint, then 3-4 from it: the params, statistics,
    momentum, generator state and metric window of a straight 4-step run,
    bit for bit (the loader re-enters its epoch at the checkpoint's batch)."""
    straight = _fit(tmp_path / 'a', 4)
    _fit(tmp_path / 'b', 2)
    resumed = _fit(tmp_path / 'c', 4, resume=tmp_path / 'b' / 'latest.txt')
    assert straight.step == resumed.step == 4
    for name in ('params', 'stats', 'bufs'):
        for (path, a), (_, b) in zip(_items(getattr(straight, name)),
                                     _items(getattr(resumed, name))):
            assert torch.equal(a.detach(), b.detach()), (name, path)
    assert torch.equal(straight.generator_state, resumed.generator_state)
    assert torch.equal(straight.win, resumed.win)


def test_synthetic_copy_equals_oadp_tpu():
    """``dp/synthetic.py``'s numpy fixtures are ``oadp_tpu``'s copy."""
    from oadp_torch.dp import synthetic as tsyn
    from oadp_tpu.dp import synthetic as jsyn

    np.testing.assert_array_equal(tsyn.make_embeddings(65, 32, 3), jsyn.make_embeddings(65, 32, 3))
    for kw in (dict(b=2, canvas=(64, 96)), dict(b=1, canvas=(832, 1344), n_gt_valid=5)):
        want = jsyn.make_train_batch(num_bases=48, num_all=65, emb_dim=16, seed=2, **kw)
        got = tsyn.make_train_batch(num_bases=48, num_all=65, emb_dim=16, seed=2, **kw)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
