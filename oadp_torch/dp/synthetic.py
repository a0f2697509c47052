"""Synthetic training fixtures (port of ``oadp_tpu/dp/synthetic.py``).

The detector's train-batch schema in numpy (a copy of ``oadp_tpu``'s) and
the production train step (:func:`make_train_step`, the trainer's own
recipe: loss sum + torch-SGD update), for dry runs and measurements.
"""

__all__ = ['make_embeddings', 'make_train_batch', 'make_train_step']

from typing import Any

import numpy as np


def make_embeddings(num_all: int, emb_dim: int, seed: int = 0) -> np.ndarray:
    """Row-normalized random classifier embeddings."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((num_all, emb_dim)).astype(np.float32)
    return emb / np.linalg.norm(emb, axis=-1, keepdims=True)


def make_train_batch(
    b: int,
    canvas: tuple,  # (H, W)
    num_bases: int,
    num_all: int,
    emb_dim: int,
    n_gt: int = 32,
    n_blocks: int = 64,
    n_objects: int = 256,
    n_gt_valid: int | None = None,
    seed: int = 0,
    images_dtype=np.float32,
) -> dict[str, Any]:
    """A full OADP training batch (images + GT + the three OAKE feature
    branches) with the exact key schema ``models.detector.forward_train``
    consumes."""
    rng = np.random.default_rng(seed)
    h, w = canvas
    m = min(h, w)
    lim = 0.7 * m

    def boxes(n, lo, hi):
        """In-canvas boxes: sizes scale down with the canvas so tiny
        dry-run geometries (e.g. 64x64) stay valid. The clamp makes the
        invariant hold by construction — the hi2 fallback can otherwise
        exceed the canvas by up to 1px at small geometries."""
        lo2 = min(float(lo), 0.3 * m)
        hi2 = max(lo2 + 1.0, min(float(hi), m - lim))
        xy = rng.uniform(0, lim, (b, n, 2))
        wh = rng.uniform(lo2, hi2, (b, n, 2))
        return np.concatenate(
            [xy, np.minimum(xy + wh, m)], -1
        ).astype(np.float32)

    gt_valid = np.ones((b, n_gt), bool)
    if n_gt_valid is not None:
        gt_valid[:, n_gt_valid:] = False
    return {
        'images': rng.standard_normal(
            (b, h, w, 3)
        ).astype(np.float32).astype(images_dtype),
        'img_hw': np.asarray([[h, w]] * b, np.float32),
        'gt_boxes': boxes(n_gt, 16, 200),
        'gt_labels': rng.integers(0, num_bases, (b, n_gt)).astype(
            np.int32),
        'gt_valid': gt_valid,
        'clip_global': rng.standard_normal((b, emb_dim)).astype(
            np.float32),
        'block_boxes': boxes(n_blocks, 64, 300),
        'block_labels': rng.random((b, n_blocks, num_all)) > 0.9,
        'clip_blocks': rng.standard_normal(
            (b, n_blocks, emb_dim)).astype(np.float32),
        'block_valid': np.ones((b, n_blocks), bool),
        'object_boxes': boxes(n_objects, 16, 200),
        'clip_objects': rng.standard_normal(
            (b, n_objects, emb_dim)).astype(np.float32),
        'object_valid': np.ones((b, n_objects), bool),
    }


def make_train_step(
    config,
    anchors,
    lr_mults,
    trainable,
    base_lr: float = 0.02,
    milestones: tuple = (30000,),
    coll=None,
):
    """Adapter over :func:`dp.trainer.build_train_step`, the trainer's own
    step, returning the total loss instead of the loss dict. ``coll`` (a
    ``utils.dist.Collective``) spans a multi-process step."""
    from ..utils import Collective
    from .trainer import build_train_step

    inner = build_train_step(config, anchors, lr_mults, trainable, base_lr=base_lr,
                             milestones=milestones, coll=coll or Collective())

    def train_step(params, stats, bufs, batch, step, draws):
        params, new_stats, bufs, losses = inner(params, stats, bufs, batch, step, draws)
        return params, new_stats, bufs, losses['total']

    return train_step
