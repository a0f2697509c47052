"""Losses of the DP stage in PyTorch, mask-aware (port of
``oadp_tpu/base/losses.py``).

* :func:`asymmetric_loss`: ASL multi-label focal loss (gamma_neg 4, clip
  0.05, the focal weight detached);
* :func:`rkd_loss`: relational distillation, the MSE between Gram
  matrices;
* :func:`l1_loss` / :func:`mse_loss` with a row mask (padded rows count
  for nothing);
* :func:`warmup_weight`: ``gain * min(step / end, 1)``;
* :func:`binary_cross_entropy` / :func:`softmax_cross_entropy` /
  :func:`smooth_l1_loss`: mmdet's losses with weights and an avg factor;
* :func:`multilabel_topk_recall`: the macro recall of the top-k logits.

Every loss accumulates in fp32 whatever the activation dtype.

Data parallelism: a masked mean takes ``all_sum``, which sums a count over
the processes of a run, so that each process returns its share
``local sum / global count`` and the shares add up to the mean over the
global batch (``oadp_tpu`` takes that mean over its mesh in one program).
Without ``all_sum`` the count is local.
"""

__all__ = [
    'asymmetric_loss',
    'rkd_loss',
    'l1_loss',
    'mse_loss',
    'warmup_weight',
    'binary_cross_entropy',
    'softmax_cross_entropy',
    'smooth_l1_loss',
    'multilabel_topk_recall',
]

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

AllSum = Callable[[torch.Tensor], torch.Tensor] | None


def _total(count: torch.Tensor, all_sum: AllSum) -> torch.Tensor:
    return count if all_sum is None else all_sum(count)


def _masked_mean(x: torch.Tensor, mask: torch.Tensor | None, all_sum: AllSum = None
                 ) -> torch.Tensor:
    if mask is None:
        return x.sum() / _total(x.new_tensor(float(x.numel())), all_sum)
    m = mask.reshape(mask.shape + (1,) * (x.ndim - mask.ndim)).expand(x.shape).to(x.dtype)
    return (x * m).sum() / _total(m.sum(), all_sum).clamp(min=1.0)


def asymmetric_loss(
    probs: torch.Tensor,  # (N, K) probabilities (already sigmoided)
    targets: torch.Tensor,  # (N, K) bool
    mask: torch.Tensor | None = None,  # (N,) valid rows
    gamma_neg: float = 4.0,
    gamma_pos: float = 0.0,
    clip: float = 0.05,
    eps: float = 1e-8,
    all_sum: AllSum = None,
) -> torch.Tensor:
    x = probs.float()
    y = targets.float()
    comp_x = 1.0 - x
    if clip > 0:
        comp_x = (comp_x + clip).clamp(max=1.0)
    loss = y * torch.log(x.clamp(min=eps)) + (1 - y) * torch.log(comp_x.clamp(min=eps))
    if gamma_neg > 0 or gamma_pos > 0:
        pt = (x * y + comp_x * (1 - y)).detach()
        gamma = gamma_pos * y + gamma_neg * (1 - y)
        loss = loss * ((1 - pt) ** gamma).detach()
    return _masked_mean(-loss, mask, all_sum)


def rkd_loss(
    preds: torch.Tensor,  # (N, C)
    targets: torch.Tensor,  # (N, D)
    mask: torch.Tensor | None = None,  # (N,)
) -> torch.Tensor:
    """MSE between Gram matrices; padded rows contribute zero and the mean
    is over valid pairs."""
    p = preds.float()
    t = targets.float()
    if mask is not None:
        m = mask.float()[:, None]
        p = p * m
        t = t * m
    sq = (p @ p.T - t @ t.T).square()
    if mask is None:
        return sq.mean()
    m = mask.float()
    pair = m[:, None] * m[None, :]
    return (sq * pair).sum() / pair.sum().clamp(min=1.0)


def l1_loss(preds: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor | None = None,
            all_sum: AllSum = None) -> torch.Tensor:
    return _masked_mean((preds.float() - targets.float()).abs(), mask, all_sum)


def mse_loss(
    preds: torch.Tensor,
    targets: torch.Tensor,
    mask: torch.Tensor | None = None,
    reduction: str = 'mean',
    all_sum: AllSum = None,
) -> torch.Tensor:
    sq = (preds.float() - targets.float()).square()
    if reduction == 'sum':
        if mask is not None:
            sq = sq * mask.reshape(mask.shape + (1,) * (sq.ndim - mask.ndim)).to(sq.dtype)
        return sq.sum()
    return _masked_mean(sq, mask, all_sum)


def warmup_weight(step: int, gain: float, end: int) -> float:
    """todd ``WarmupScheduler``: ``gain * min(step / end, 1)``, in fp32
    arithmetic as ``oadp_tpu`` computes it."""
    return float(np.float32(gain) * min(np.float32(step) / np.float32(end), np.float32(1.0)))


def _reduce(loss: torch.Tensor, weights, avg_factor) -> torch.Tensor:
    if weights is not None:
        loss = loss * weights.float()
    total = loss.sum()
    if avg_factor is None:
        return total / loss.numel()
    if torch.is_tensor(avg_factor):
        return total / avg_factor.float().clamp(min=1.0)
    return total / max(avg_factor, 1.0)


def binary_cross_entropy(
    logits: torch.Tensor,
    targets: torch.Tensor,  # same shape, float 0/1
    weights: torch.Tensor | None = None,
    avg_factor: torch.Tensor | float | None = None,
) -> torch.Tensor:
    x = logits.float()
    y = targets.float()
    loss = x.clamp(min=0) - x * y + torch.log1p(torch.exp(-x.abs()))
    return _reduce(loss, weights, avg_factor)


def softmax_cross_entropy(
    logits: torch.Tensor,  # (N, K)
    labels: torch.Tensor,  # (N,) int
    weights: torch.Tensor | None = None,  # (N,)
    avg_factor: torch.Tensor | float | None = None,
) -> torch.Tensor:
    logp = F.log_softmax(logits.float(), dim=-1)
    loss = -logp.gather(-1, labels.long()[:, None])[:, 0]
    return _reduce(loss, weights, avg_factor)


def smooth_l1_loss(
    preds: torch.Tensor,
    targets: torch.Tensor,
    beta: float = 1.0,
    weights: torch.Tensor | None = None,
    avg_factor: torch.Tensor | float | None = None,
) -> torch.Tensor:
    diff = (preds.float() - targets.float()).abs()
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)
    return _reduce(loss, weights, avg_factor)


@torch.no_grad()
def multilabel_topk_recall(
    logits: torch.Tensor,  # (N, K)
    targets: torch.Tensor,  # (N, K) bool
    k: int,
    mask: torch.Tensor | None = None,  # (N,)
) -> torch.Tensor:
    """Macro recall over the classes with at least one positive, x100
    (sklearn ``recall_score(average='macro')``, reference
    ``oadp/dp/utils.py:13-44``). A metric: not differentiated."""
    y = targets.bool()
    logits = logits.float()
    if mask is not None:
        y = y & mask[:, None]
        logits = torch.where(mask[:, None], logits, -torch.inf)
    k = min(k, logits.shape[-1])
    thresh = logits.topk(k, dim=-1).values[:, -1:]
    preds = logits >= thresh
    tp = (preds & y).sum(0).float()
    pos = y.sum(0).float()
    present = pos > 0
    recall = torch.where(present, tp / pos.clamp(min=1.0), 0.0)
    return recall.sum() / present.sum().clamp(min=1) * 100.0
