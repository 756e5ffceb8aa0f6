# noqa: D400 D205
"""
Analytic benchmark problems in paired numpy/torch form
------------------------------------------------------

Counterparts of ``ultranest_tpu/models/problems.py:55-163``: each
problem carries a vectorized numpy likelihood (the host path and the
f64 re-check of accepted points) and a torch likelihood that runs on
whatever device its input tensor lies on. Both take the same numpy
constants, so the JAX package's problems and these agree point for
point.
"""

import math

import numpy as np
import torch

__all__ = ['Problem', 'gauss', 'asymgauss', 'corrgauss', 'eggbox']


class Problem:
    """An analytic inference problem.

    Attributes
    ----------
    name: str
    param_names: list of str
    loglike, transform: numpy vectorized functions
    torch_loglike, torch_transform: torch functions (or None)
    logz: float or None
        analytic log-evidence, if known
    """

    def __init__(self, name, param_names, loglike, transform,
                 torch_loglike=None, torch_transform=None, logz=None):
        self.name = name
        self.param_names = param_names
        self.loglike = loglike
        self.transform = transform
        self.torch_loglike = torch_loglike
        self.torch_transform = torch_transform
        self.logz = logz

    @property
    def ndim(self):
        """Dimensionality of the problem."""
        return len(self.param_names)

    def sampler_kwargs(self, use_torch=True, **extra):
        """Keyword arguments for ReactiveNestedSampler."""
        kw = dict(param_names=self.param_names, loglike=self.loglike,
                  transform=self.transform, vectorized=True)
        if use_torch and self.torch_loglike is not None:
            kw['torch_loglike'] = self.torch_loglike
            kw['torch_transform'] = self.torch_transform
        kw.update(extra)
        return kw


def _names(ndim):
    return ['param%d' % (i + 1) for i in range(ndim)]


def gauss(ndim=3, sigma=0.1):
    """Centered isotropic gaussian (cf. upstream docs/gauss.py)."""
    sigma = float(sigma)
    norm = -0.5 * np.log(2 * np.pi * sigma**2) * ndim

    def loglike(theta):
        return -0.5 * (((theta - 0.5) / sigma) ** 2).sum(axis=1) + norm

    def torch_loglike(theta):
        return -0.5 * (((theta - 0.5) / sigma) ** 2).sum(dim=1) + norm

    return Problem('gauss%dd' % ndim, _names(ndim), loglike, None,
                   torch_loglike, None, logz=0.0)


def asymgauss(ndim=50, sigma_min=0.01):
    """Gaussian with log-spaced widths per axis (upstream testasymgauss.py).

    The headline problem of the population slice sampler
    (``bench.py:168-175``): widths from 0.1 down to *sigma_min*, centres
    spread along a sine, analytic logZ 0.
    """
    sigma = np.logspace(-1, np.log10(sigma_min), ndim)
    width = np.clip(1 - 5 * sigma, 1e-20, None)
    centers = (np.sin(np.arange(ndim) / 2.0) * width + 1.0) / 2.0
    norm = -0.5 * np.log(2 * np.pi * sigma**2).sum()

    def loglike(theta):
        return -0.5 * (((theta - centers) / sigma) ** 2).sum(axis=1) + norm

    consts = {}

    def torch_loglike(theta):
        # constants copied to the device once: a copy from host memory
        # on every call would wait for the device
        key = (theta.device, theta.dtype)
        if key not in consts:
            consts[key] = tuple(torch.as_tensor(a, dtype=theta.dtype,
                                                device=theta.device)
                                for a in (centers, sigma))
        c, s = consts[key]
        return -0.5 * (((theta - c) / s) ** 2).sum(dim=1) + norm

    return Problem('asymgauss%dd' % ndim, _names(ndim), loglike, None,
                   torch_loglike, None, logz=0.0)


def corrgauss(ndim=4, rho=0.95, sigma=0.1):
    """Strongly correlated gaussian."""
    cov = np.full((ndim, ndim), rho) + np.eye(ndim) * (1 - rho)
    cov *= sigma**2
    invcov = np.linalg.inv(cov)
    norm = -0.5 * (np.linalg.slogdet(2 * np.pi * cov)[1])

    def loglike(theta):
        d = theta - 0.5
        return -0.5 * (d @ invcov * d).sum(axis=1) + norm

    def torch_loglike(theta):
        d = theta - 0.5
        A = torch.as_tensor(invcov, dtype=theta.dtype, device=theta.device)
        return -0.5 * ((d @ A) * d).sum(dim=1) + norm

    return Problem('corrgauss%dd' % ndim, _names(ndim), loglike, None,
                   torch_loglike, None, logz=0.0)


def _eggbox_logz():
    n = 4000
    x = (np.arange(n) + 0.5) / n * 10 * np.pi
    chi = np.outer(np.cos(x / 2), np.cos(x / 2))
    logl = (2 + chi) ** 5
    m = logl.max()
    return float(np.log(np.exp(logl - m).mean()) + m)


def eggbox():
    """2-d eggbox, 18 modes (upstream examples/testeggbox.py)."""

    def loglike(z):
        chi = np.cos(z[:, 0] / 2) * np.cos(z[:, 1] / 2)
        return (2 + chi) ** 5

    def transform(x):
        return x * 10 * np.pi

    def torch_loglike(z):
        chi = torch.cos(z[:, 0] / 2) * torch.cos(z[:, 1] / 2)
        return (2 + chi) ** 5

    def torch_transform(x):
        return x * 10 * math.pi

    return Problem('eggbox', ['x', 'y'], loglike, transform,
                   torch_loglike, torch_transform, logz=_eggbox_logz())
