"""Hyperparameter search samplers for the calibration sweep (a copy of
``oadp_tpu/utils/search.py``).

The reference drives the post-hoc ensemble calibration with an NNI TPE
experiment (``tools/nni_dp_test.py:17-57``). nni is not a dependency,
so this module provides an in-process equivalent:

* :func:`kronecker_sequence` — a low-discrepancy quasi-random sequence
  (additive recurrence with the generalized golden ratio) used for the
  startup trials;
* :class:`TpeSampler` — univariate Tree-structured Parzen Estimator in
  the ask/tell style: observations are split at the ``gamma`` quantile
  into good/bad sets, Parzen (Gaussian-kernel) densities ``l``/``g`` are
  fit per dimension, and the candidate maximizing ``l/g`` among
  ``n_ei_candidates`` draws from ``l`` is proposed — the same scheme NNI's
  TPE tuner uses for uniform parameters.
"""

__all__ = ['kronecker_sequence', 'TpeSampler']

import numpy as np


def kronecker_sequence(n: int, d: int, seed: int = 0) -> np.ndarray:
    """``(n, d)`` low-discrepancy points in [0, 1) (R_d sequence)."""
    # generalized golden ratio: unique positive root of x^(d+1) = x + 1
    phi = 2.0
    for _ in range(64):
        phi = (1 + phi) ** (1.0 / (d + 1))
    alpha = np.array([(1.0 / phi) ** (k + 1) for k in range(d)])
    shift = np.random.default_rng(seed).random(d)
    idx = np.arange(1, n + 1)[:, None]
    return (shift[None, :] + idx * alpha[None, :]) % 1.0


class TpeSampler:
    """Maximizing ask/tell TPE over a box-constrained space.

    Args:
        space: ``{name: (lo, hi)}`` uniform parameter ranges.
        seed: RNG seed.
        n_startup: quasi-random trials before the TPE model kicks in.
        gamma: top-quantile fraction forming the "good" set.
        n_ei_candidates: draws from ``l`` scored by ``l/g`` per ask.
    """

    def __init__(
        self,
        space: dict[str, tuple],
        seed: int = 0,
        n_startup: int = 10,
        gamma: float = 0.25,
        n_ei_candidates: int = 24,
    ) -> None:
        self.space = {k: (float(lo), float(hi)) for k, (lo, hi) in
                      space.items()}
        self.names = list(self.space)
        self.rng = np.random.default_rng(seed)
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_ei_candidates = n_ei_candidates
        self._startup = kronecker_sequence(
            max(n_startup, 1), len(self.names), seed
        )
        self._asked = 0
        self.history: list[tuple[dict, float]] = []

    # -- ask/tell ---------------------------------------------------------

    def ask(self) -> dict:
        if self._asked < self.n_startup or len(self.history) < 4:
            u = self._startup[self._asked % len(self._startup)]
            self._asked += 1
            return {
                k: lo + (hi - lo) * u[i]
                for i, (k, (lo, hi)) in enumerate(self.space.items())
            }
        self._asked += 1
        return {k: self._ask_dim(k) for k in self.names}

    def tell(self, params: dict, value: float) -> None:
        self.history.append((dict(params), float(value)))

    # -- internals --------------------------------------------------------

    def _split(self) -> tuple[list[dict], list[dict]]:
        ordered = sorted(self.history, key=lambda t: -t[1])
        # hyperopt's split: the good set grows ~ gamma*sqrt(n) (capped),
        # keeping l(x) tight around the best observations as n grows
        n_good = max(
            1, min(
                int(np.ceil(self.gamma * np.sqrt(len(ordered)))), 25
            )
        )
        good = [p for p, _ in ordered[:n_good]]
        bad = [p for p, _ in ordered[n_good:]] or good
        return good, bad

    def _ask_dim(self, name: str) -> float:
        lo, hi = self.space[name]
        good, bad = self._split()
        xg = np.array([p[name] for p in good])
        xb = np.array([p[name] for p in bad])
        width = hi - lo

        def bandwidth(x):
            spread = x.std() if len(x) > 1 else width
            # floor keeps the estimator exploring even once the good
            # set concentrates (hyperopt's prior-weighted mixture)
            return max(float(spread) * len(x) ** -0.2, 0.02 * width)

        bw_g, bw_b = bandwidth(xg), bandwidth(xb)

        def logpdf(x, centers, bw):
            # Parzen mixture of Gaussians, uniform prior smoothing
            z = (x[:, None] - centers[None, :]) / bw
            comp = np.exp(-0.5 * z * z) / (bw * np.sqrt(2 * np.pi))
            return np.log(
                0.95 * comp.mean(1) + 0.05 / width + 1e-300
            )

        # draw candidates from l's prior-weighted mixture: mostly the
        # good kernels, a slice from the uniform prior (exploration)
        n = self.n_ei_candidates
        centers = xg[self.rng.integers(0, len(xg), n)]
        cand = centers + self.rng.normal(0, bw_g, n)
        from_prior = self.rng.random(n) < 0.1
        cand = np.where(
            from_prior, self.rng.uniform(lo, hi, n), cand
        )
        cand = np.clip(cand, lo, hi)
        score = logpdf(cand, xg, bw_g) - logpdf(cand, xb, bw_b)
        return float(cand[int(np.argmax(score))])
