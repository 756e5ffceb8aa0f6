"""Analytic problems with known volume(L) relations for shrinkage tests
(the PyTorch port's own copy of ``evaluate/problems.py``).

Each problem provides (loglike, gradient, volume, warmup): a single-point
log-likelihood, a contour-normal gradient, the enclosed prior volume at a
likelihood threshold (NaN where edge effects make it unknown), and a
warm starting-point generator.

Equivalent of the reference `evaluate/problems.py` problem set.
"""

from math import exp, gamma, pi

import numpy as np


def random_vector(ndim, length=1):
    """Isotropic random vector of given length."""
    v = np.random.normal(size=ndim)
    return v * length / (v**2).sum()**0.5


def random_point_in_sphere(ndim, radius=1):
    """Uniform random point inside an ndim-sphere."""
    return random_vector(ndim, radius * np.random.uniform()**(1.0 / ndim))


def nsphere_volume(radius, ndim):
    """Volume of an ndim-sphere of given radius."""
    return pi**(ndim / 2.0) / gamma(ndim / 2.0 + 1) * radius**ndim


def gradient_to_center(x, ctr=0.5):
    """Unit vector pointing to the center."""
    v = ctr - x
    v /= (v**2).sum()**0.5
    return v


def transform(x):
    """Identity prior transform."""
    return x


def loglike_gauss(x):
    """Gaussian problem (circular contours)."""
    return -0.5 * ((x - 0.5)**2).sum()


gradient_gauss = gradient_to_center


def volume_gauss(loglike, ndim):
    """Volume enclosed at the loglike threshold."""
    sqr_radius = -2 * loglike
    radius = sqr_radius**0.5
    if radius >= 0.5:
        return np.nan
    return nsphere_volume(radius, ndim)


def warmup_gauss(ndim):
    """Warm starting point."""
    return 0.5 + random_point_in_sphere(ndim, radius=0.4)


def generate_asymgauss_problem(ndim):
    """Axis-wise asymmetric gaussian problem."""
    asym_sigma = 0.1 / (1 + 4 * np.arange(ndim))
    asym_sigma_max = asym_sigma.max()

    def loglike_asymgauss(x):
        return -0.5 * (((x - 0.5) / asym_sigma)**2).sum()

    def volume_asymgauss(loglike, ndim):
        sqr_radius = -2 * loglike
        radius = sqr_radius**0.5
        if radius * asym_sigma_max >= 0.5:
            return np.nan
        return nsphere_volume(radius, ndim) \
            * np.prod(asym_sigma / asym_sigma_max)

    def gradient_asymgauss(x):
        v = (0.5 - x) / asym_sigma**2
        return v / (v**2).sum()**0.5

    def warmup_asymgauss(ndim):
        return 0.5 + random_point_in_sphere(ndim, radius=1) * asym_sigma

    return (loglike_asymgauss, gradient_asymgauss, volume_asymgauss,
            warmup_asymgauss)


def loglike_pyramid(x):
    """Hyper-pyramid problem (square contours)."""
    return -np.abs(x - 0.5).max()**0.01


def gradient_pyramid(x):
    """Contour normal of the pyramid."""
    j = np.argmax(np.abs(x - 0.5))
    v = np.zeros(len(x))
    v[j] = -1 if x[j] > 0.5 else 1
    return v


def volume_pyramid(loglike, ndim):
    """Volume enclosed at the loglike threshold."""
    sidelength = (-loglike)**100
    return sidelength**ndim


def warmup_pyramid(ndim):
    """Warm starting point."""
    return np.random.uniform(0.4, 0.6, size=ndim)


def loglike_multigauss(x):
    """Two-peaked gaussian problem."""
    a = -0.5 * (((x - 0.4) / 0.01)**2).sum()
    b = -0.5 * (((x - 0.6) / 0.01)**2).sum()
    return np.logaddexp(a, b)


def gradient_multigauss(x, plot=False):
    """Weighted contour normal of the two-peak problem."""
    va = gradient_to_center(x, ctr=0.4)
    vb = gradient_to_center(x, ctr=0.6)
    logwa = -0.5 * (((x - 0.4) / 0.01)**2).sum()
    logwb = -0.5 * (((x - 0.6) / 0.01)**2).sum()
    logwmax = max(logwa, logwb)
    v = va * exp(logwa - logwmax) + vb * exp(logwb - logwmax)
    return v / (v**2).sum()**0.5


def volume_multigauss(loglike, ndim):
    """Volume enclosed at the loglike threshold (both peaks)."""
    sqr_radius = -2 * loglike
    radius = sqr_radius**0.5 * 0.01
    if radius >= 0.5:
        return np.nan
    if radius >= (0.2**2 * ndim)**0.5:
        # peaks still touching
        return np.nan
    return nsphere_volume(radius, ndim)


def warmup_multigauss(ndim):
    """Warm starting point in one of the two peaks."""
    ctr = 0.4 if np.random.uniform() < 0.5 else 0.6
    return ctr + random_point_in_sphere(ndim, radius=0.04)


def loglike_shell(x):
    """Gaussian shell problem."""
    r = ((x - 0.5)**2).sum()
    return -0.5 * ((r - 0.4**2) / 0.004)**2


def gradient_shell(x):
    """Contour normal of the shell."""
    r = ((x - 0.5)**2).sum()
    v = gradient_to_center(x)
    if r < 0.4:
        v = -v
    return v


def volume_shell(loglike, ndim):
    """Volume enclosed at the loglike threshold (shell annulus)."""
    sqr_deviation = -2 * loglike * (0.004)**2
    deviation = sqr_deviation**0.5
    if deviation >= 0.1:
        return np.nan
    outer_volume = nsphere_volume(0.4 + deviation, ndim)
    if deviation >= 0.4:
        inner_volume = 0
    else:
        inner_volume = nsphere_volume(0.4 - deviation, ndim)
    return outer_volume - inner_volume


def warmup_shell(ndim):
    """Warm starting point inside the shell."""
    length = 0.4 + np.random.uniform(-0.1, 0.1)
    return 0.5 + random_vector(ndim, length=length)


def get_problem(problemname, ndim):
    """Look up a problem by name."""
    if problemname == 'circgauss':
        return loglike_gauss, gradient_gauss, volume_gauss, warmup_gauss
    if problemname == 'asymgauss':
        return generate_asymgauss_problem(ndim)
    if problemname == 'pyramid':
        return (loglike_pyramid, gradient_pyramid, volume_pyramid,
                warmup_pyramid)
    if problemname == 'multigauss':
        return (loglike_multigauss, gradient_multigauss, volume_multigauss,
                warmup_multigauss)
    if problemname == 'shell':
        return loglike_shell, gradient_shell, volume_shell, warmup_shell
    raise Exception("Problem '%s' unknown" % problemname)
