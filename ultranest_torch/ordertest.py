# noqa: D400 D205
"""
U test for uniform insertion ranks
----------------------------------

Online Mann-Whitney-Wilcoxon U test that nested sampling insertion ranks
are uniform — a statistical bias detector (cf. reference
ultranest/ordertest.py; method of Buchner 2023, sec. 4.5.2,
arxiv:2101.09675).

Pure scalar accumulator; negligible cost, stays on host.
"""

import numpy as np

__all__ = ['infinite_U_zscore', 'UniformOrderAccumulator']

# variance of a standard uniform variate
_U_VARIANCE = 1.0 / 12.0


def infinite_U_zscore(sample, B):
    """MWW U-test z-score for integer *sample* uniform on ``0..B``.

    Parameters
    ----------
    sample: array of integers
        observed insertion ranks (0..B inclusive)
    B: int
        maximum rank

    Returns
    -------
    zscore: float
    """
    ranks = (np.asarray(sample) + 0.5) / B
    n = len(ranks)
    return (ranks.sum() - 0.5 * n) / (n * _U_VARIANCE) ** 0.5


class UniformOrderAccumulator:
    """Streaming insertion-rank U-test.

    Keeps only the running sum of normalized ranks — O(1) memory for
    arbitrarily long runs.
    """

    def __init__(self):
        """Start empty."""
        self.reset()

    def reset(self):
        """Drop all accumulated ranks."""
        self._rank_sum = 0.0
        self._n = 0

    def add(self, order, N):
        """Record rank *order* out of maximum rank *N* (inclusive)."""
        if order < 0 or order > N:
            raise ValueError("order %d out of %d invalid" % (order, N))
        self._rank_sum += (order + 0.5) / N
        self._n += 1

    def add_many(self, orders, N):
        """Record an array of ranks sharing the same maximum *N*."""
        orders = np.asarray(orders)
        if (orders < 0).any() or (orders > N).any():
            raise ValueError("ranks out of 0..%d invalid" % N)
        self._rank_sum += float(((orders + 0.5) / N).sum())
        self._n += len(orders)

    def load(self, rank_sum, n):
        """Restore accumulator state (used by vectorized batch feeders)."""
        self._rank_sum = float(rank_sum)
        self._n = int(n)

    @property
    def zscore(self):
        """Deviation from the uniform-rank null hypothesis, in sigmas."""
        if not self._n:
            return 0.0
        expected = 0.5 * self._n
        return (self._rank_sum - expected) / (self._n * _U_VARIANCE) ** 0.5

    @property
    def N(self):
        """Number of ranks accumulated."""
        return self._n

    @property
    def U(self):
        """Running sum of normalized ranks."""
        return self._rank_sum

    def __len__(self):
        """Number of ranks accumulated."""
        return self._n
