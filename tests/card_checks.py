"""What the ``cuda``-marked tests of ``tests/test_torch_*.py`` share: the
card, or a skip where there is none, and the measures that hold a
kernel's output to its plain version. Test files load it by path: on a
host where an installed package is also called ``tests``, ``import
tests.card_checks`` would find that one."""

import pytest
import torch
import torch.nn.functional as F

#: the most that an output of rows with a large mean may differ from its
#: plain version beyond one bf16 unit in the last place: on random rows
#: the residual deltas of the H100's kernels differ by at most 0.0625,
#: where an MLP or attention delta left out or gone wrong differs by
#: several tenths to units
LARGE_MEAN_EXCESS = 0.125


def card() -> torch.device:
    """The CUDA device; skips the calling test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def compare(got, want) -> tuple[float, float]:
    """The largest absolute difference and the lowest cosine, row by row
    over the leading dimension, of ``got`` against ``want`` (tensors, or
    tuples of them taken pairwise); raises if ``got`` is not finite."""
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    err, cos = 0.0, 1.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        if not torch.isfinite(g).all():
            raise AssertionError('kernel output is not finite')
        err = max(err, float((g - w).abs().max()))
        cos = min(cos, float(F.cosine_similarity(
            g.reshape(g.shape[0], -1), w.reshape(w.shape[0], -1)).min()))
    return err, cos


def bf16_excess(got, want) -> float:
    """The largest ``|got - want|`` beyond one bf16 unit in the last place
    of the larger of the two: what is left of the error once each side's
    rounding of ``x + delta`` to bf16 is taken out. On rows with a large
    mean the residual ``x`` swamps a delta's error in a cosine; in this
    measure the delta's error stands alone."""
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((g - w).abs() - ulp).max())
