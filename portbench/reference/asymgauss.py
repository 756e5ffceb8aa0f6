"""The asymmetric gaussian of UltraNest's ``examples/testasymgauss.py``
(Buchner 2021, JOSS 6(60):3001) on the unit cube: axis k has width
``sigma_k``, log-spaced from 0.1 down to *sigma_min*, and centre
``c_k = (1 + sin(k / 2) (1 - 5 sigma_k)) / 2``; the likelihood is the
normalised gaussian ``sum_k -((x_k - c_k) / sigma_k)^2 / 2 - log(2 pi
sigma_k^2) / 2``, the transform the identity.
"""

import math

import numpy as np

from . import exact


def constants(ndim=50, sigma_min=0.01):
    """(centres, widths) in float64."""
    k = np.arange(ndim, dtype=np.float64)
    sigma = 10.0 ** np.linspace(-1.0, math.log10(sigma_min), ndim)
    centers = 0.5 * (1.0 + np.sin(0.5 * k) * np.maximum(1.0 - 5.0 * sigma,
                                                        1e-20))
    return centers, sigma


def transform(u, r=exact, **args):
    """The identity."""
    return r(np.asarray(u, dtype=np.float64))


def loglike(theta, r=exact, ndim=50, sigma_min=0.01):
    """log L of each row of *theta* (n, ndim), accumulated axis by axis,
    each operation rounded by *r*."""
    theta = np.asarray(theta, dtype=np.float64)
    centers, sigma = constants(ndim, sigma_min)
    total = np.zeros(theta.shape[0])
    for k in range(ndim):
        z = r(r(theta[:, k] - r(centers[k])) / r(sigma[k]))
        term = r(r(-0.5 * r(z * z)) - r(0.5 * r(math.log(
            2.0 * math.pi * sigma[k] ** 2))))
        total = r(total + term)
    return total


def truth(ndim=50, sigma_min=0.01):
    """log Z: the mass of each axis' gaussian inside [0, 1], multiplied
    (the unit cube's prior density is 1)."""
    centers, sigma = constants(ndim, sigma_min)
    s2 = math.sqrt(2.0)
    return float(sum(math.log(0.5 * (math.erf((1.0 - c) / (s * s2))
                                     - math.erf(-c / (s * s2))))
                     for c, s in zip(centers, sigma)))
