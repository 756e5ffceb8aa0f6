"""The eggbox of UltraNest's ``examples/testeggbox.py`` (Buchner 2021,
JOSS 6(60):3001): parameters ``theta = 10 pi u`` on the unit square,
``log L = (2 + cos(theta_1 / 2) cos(theta_2 / 2)) ** 5``.
"""

import numpy as np

from . import exact


def transform(u, r=exact, **args):
    """The unit square to the box [0, 10 pi]^2."""
    return r(r(10.0 * np.pi) * np.asarray(u, dtype=np.float64))


def loglike(theta, r=exact, **args):
    """log L of each row of *theta* (n, 2)."""
    theta = np.asarray(theta, dtype=np.float64)
    c1 = r(np.cos(r(theta[:, 0] * 0.5)))
    c2 = r(np.cos(r(theta[:, 1] * 0.5)))
    base = r(2.0 + r(c1 * c2))
    sq = r(base * base)
    return r(r(sq * sq) * base)


def truth(n=4000, block=250, **args):
    """log Z by the midpoint rule on an *n* x *n* grid of the unit square
    (the prior's density is 1 there), summed in blocks of rows."""
    c = np.cos((np.arange(n) + 0.5) / n * 10.0 * np.pi * 0.5)
    peak = 3.0 ** 5
    total = 0.0
    for i in range(0, n, block):
        logl = (2.0 + np.outer(c[i:i + block], c)) ** 5
        total += np.exp(logl - peak).sum()
    return float(np.log(total / n ** 2) + peak)
