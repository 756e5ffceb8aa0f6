# noqa: D400 D205
"""
Analytic benchmark problems in paired numpy/torch form
------------------------------------------------------

Counterparts of ``ultranest_tpu/models/problems.py``: each problem
carries a vectorized numpy likelihood (the host path and the f64
re-check of accepted points) and a torch likelihood that runs on
whatever device its input tensor lies on. Both take the same numpy
constants, so the JAX package's problems and these agree point for
point. Problems with data (``sine``, ``dirichlet``) build it with numpy
from their ``seed``, as the reference does.
"""

import math

import numpy as np
import scipy.special
import scipy.stats
import torch

__all__ = ['Problem', 'gauss', 'multigauss', 'asymgauss', 'corrgauss',
           'eggbox', 'rosenbrock', 'multishell', 'shell', 'loggamma',
           'funnel', 'pyramid', 'sine', 'corrpeak', 'hyperrect',
           'dirichlet', 'slantedeggbox']


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


class _Consts:
    """Numpy constants as tensors, copied to each device once.

    ``consts(x)`` returns them in the dtype and on the device of tensor
    *x*; a copy from host memory on every call would wait for the
    device.
    """

    def __init__(self, *arrays):
        self.arrays = arrays
        self._on = {}

    def __call__(self, like):
        key = (like.device, like.dtype)
        if key not in self._on:
            self._on[key] = tuple(
                torch.as_tensor(np.asarray(a), dtype=like.dtype,
                                device=like.device) for a in self.arrays)
        return self._on[key]


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


def multigauss(ndim=2, sigma=0.05, centers=(0.3, 0.7)):
    """Bimodal gaussian mixture along all axes."""
    c1, c2 = centers
    norm = -0.5 * np.log(2 * np.pi * sigma**2) * ndim - np.log(2.0)

    def loglike(theta):
        a = -0.5 * (((theta - c1) / sigma) ** 2).sum(axis=1)
        b = -0.5 * (((theta - c2) / sigma) ** 2).sum(axis=1)
        return np.logaddexp(a, b) + norm

    def torch_loglike(theta):
        a = -0.5 * (((theta - c1) / sigma) ** 2).sum(dim=1)
        b = -0.5 * (((theta - c2) / sigma) ** 2).sum(dim=1)
        return torch.logaddexp(a, b) + norm

    return Problem('multigauss%dd' % ndim, _names(ndim), loglike, None,
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
    consts = _Consts(centers, sigma)

    def loglike(theta):
        return -0.5 * (((theta - centers) / sigma) ** 2).sum(axis=1) + norm

    def torch_loglike(theta):
        c, s = consts(theta)
        return -0.5 * (((theta - c) / s) ** 2).sum(dim=1) + norm

    return Problem('asymgauss%dd' % ndim, _names(ndim), loglike, None,
                   torch_loglike, None, logz=0.0)


def corrgauss(ndim=4, rho=0.95, sigma=0.1):
    """Strongly correlated gaussian."""
    cov = np.full((ndim, ndim), rho) + np.eye(ndim) * (1 - rho)
    cov *= sigma**2
    invcov = np.linalg.inv(cov)
    norm = -0.5 * (np.linalg.slogdet(2 * np.pi * cov)[1])
    consts = _Consts(invcov)

    def loglike(theta):
        d = theta - 0.5
        return -0.5 * (d @ invcov * d).sum(axis=1) + norm

    def torch_loglike(theta):
        d = theta - 0.5
        A, = consts(theta)
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


def rosenbrock(ndim=2):
    """Rosenbrock valley (upstream examples/testrosenbrock.py)."""

    def loglike(theta):
        a = theta[:, :-1]
        b = theta[:, 1:]
        return -2 * (100 * (b - a**2)**2 + (1 - a)**2).sum(axis=1)

    def transform(u):
        return u * 20 - 10

    def torch_loglike(theta):
        a = theta[:, :-1]
        b = theta[:, 1:]
        return -2 * (100 * (b - a**2)**2 + (1 - a)**2).sum(dim=1)

    def torch_transform(u):
        return u * 20 - 10

    return Problem('rosenbrock%dd' % ndim, _names(ndim), loglike, transform,
                   torch_loglike, torch_transform, logz=None)


def _shell_vol(ndim, r, w):
    mom = scipy.stats.norm.moment(ndim - 1, loc=r, scale=w)
    vol = np.pi**(ndim / 2.0) / scipy.special.gamma(ndim / 2.0 + 1)
    surf = vol * ndim
    return mom * surf


def multishell(ndim=2, r=0.2, w=None):
    """Two overlapping gaussian shells (upstream examples/testmultishell.py).

    The shells are thin (w = 0.001 / ndim by default), so ``(d - r)**2 /
    w**2`` resolves L coarsely in float32 near the shell; the f64
    re-check of accepted points keeps the tree exact.
    """
    if w is None:
        w = 0.001 / ndim
    c1 = np.zeros(ndim) + 0.5
    c2 = np.zeros(ndim) + 0.5
    c1[0] -= r / 2
    c2[0] += r / 2
    N = -0.5 * np.log(2 * np.pi * w**2)
    logz = float(np.log(_shell_vol(ndim, r, w) + _shell_vol(ndim, r, w)))
    consts = _Consts(c1, c2)

    def loglike(theta):
        d1 = ((theta - c1)**2).sum(axis=1)**0.5
        d2 = ((theta - c2)**2).sum(axis=1)**0.5
        L1 = -0.5 * ((d1 - r)**2) / w**2 + N
        L2 = -0.5 * ((d2 - r)**2) / w**2 + N
        return np.logaddexp(L1, L2)

    def torch_loglike(theta):
        t1, t2 = consts(theta)
        d1 = torch.sqrt(((theta - t1)**2).sum(dim=1))
        d2 = torch.sqrt(((theta - t2)**2).sum(dim=1))
        L1 = -0.5 * ((d1 - r)**2) / w**2 + N
        L2 = -0.5 * ((d2 - r)**2) / w**2 + N
        return torch.logaddexp(L1, L2)

    return Problem('multishell%dd' % ndim, _names(ndim), loglike, None,
                   torch_loglike, None, logz=logz)


def shell(ndim=2, r=0.2, w=0.004):
    """Single gaussian shell."""
    c = np.zeros(ndim) + 0.5
    N = -0.5 * np.log(2 * np.pi * w**2)
    logz = float(np.log(_shell_vol(ndim, r, w)))
    consts = _Consts(c)

    def loglike(theta):
        d = ((theta - c)**2).sum(axis=1)**0.5
        return -0.5 * ((d - r)**2) / w**2 + N

    def torch_loglike(theta):
        t, = consts(theta)
        d = torch.sqrt(((theta - t)**2).sum(dim=1))
        return -0.5 * ((d - r)**2) / w**2 + N

    return Problem('shell%dd' % ndim, _names(ndim), loglike, None,
                   torch_loglike, None, logz=logz)


def loggamma(ndim=30, scale=1.0 / 30):
    """Mixture of loggamma and normal components (upstream testloggamma.py).

    Heavy-tailed, multimodal in the first two axes; the standard hard
    problem for step samplers. Analytic logZ ~ 0 (densities normalized,
    negligible truncation).
    """
    rv1a = scipy.stats.loggamma(1, loc=2.0 / 3, scale=scale)
    rv1b = scipy.stats.loggamma(1, loc=1.0 / 3, scale=scale)
    rv2a = scipy.stats.norm(2.0 / 3, scale)
    rv2b = scipy.stats.norm(1.0 / 3, scale)
    rv_rest = []
    for i in range(2, ndim):
        if i <= (ndim + 2) / 2:
            rv_rest.append(scipy.stats.loggamma(1, loc=2.0 / 3.0, scale=scale))
        else:
            rv_rest.append(scipy.stats.norm(2.0 / 3, scale))

    def loglike(theta):
        L1 = np.log(0.5 * rv1a.pdf(theta[:, 0])
                    + 0.5 * rv1b.pdf(theta[:, 0]) + 1e-300)
        L2 = np.log(0.5 * rv2a.pdf(theta[:, 1])
                    + 0.5 * rv2b.pdf(theta[:, 1]) + 1e-300)
        Lrest = np.sum([rv.logpdf(t) for rv, t
                        in zip(rv_rest, theta[:, 2:].transpose())], axis=0)
        return L1 + L2 + Lrest

    # loggamma(1) logpdf(x; loc, scale) = y - exp(y) - log(scale) with
    # y = (x - loc) / scale; every component of the rest sits at 2/3
    locs_rest = np.full(ndim - 2, 2.0 / 3.0)
    is_lg_rest = np.array([i <= (ndim + 2) / 2 for i in range(2, ndim)])
    log_scale = float(np.log(scale))
    # the reference's +1e-300 floor, as a log: -690.78 is a finite
    # float32, so the tails clamp there instead of reaching -inf
    log_tiny = float(np.log(1e-300))
    log_half = float(np.log(0.5))
    consts = _Consts(locs_rest, is_lg_rest)

    def _lg_logpdf(x, loc):
        y = (x - loc) / scale
        return y - torch.exp(y) - log_scale

    def _norm_logpdf(x, loc):
        # jax.scipy.stats.norm.logpdf's arithmetic
        return (math.log(2 * math.pi * scale**2)
                + (x - loc)**2 / scale**2) / -2

    def torch_loglike(theta):
        locs, is_lg = consts(theta)
        tiny = torch.full_like(theta[:, 0], log_tiny)
        L1 = torch.logaddexp(
            torch.logaddexp(_lg_logpdf(theta[:, 0], 2.0 / 3),
                            _lg_logpdf(theta[:, 0], 1.0 / 3)) + log_half,
            tiny)
        L2 = torch.logaddexp(
            torch.logaddexp(_norm_logpdf(theta[:, 1], 2.0 / 3),
                            _norm_logpdf(theta[:, 1], 1.0 / 3)) + log_half,
            tiny)
        rest = theta[:, 2:]
        Lrest = torch.where(is_lg[None, :] > 0, _lg_logpdf(rest, locs),
                            _norm_logpdf(rest, locs)).sum(dim=1)
        return L1 + L2 + Lrest

    return Problem('loggamma%dd' % ndim, _names(ndim), loglike, None,
                   torch_loglike, None, logz=0.0)


def funnel(ndim=2, sigma0=0.2):
    """Neal-style funnel (upstream examples/testfunnel.py flavour)."""

    def loglike(theta):
        sigma = 10 ** (theta[:, 0] * 4 - 2) * sigma0
        like = -0.5 * ((theta[:, 1:] - 0.5)**2 / sigma[:, None]**2).sum(axis=1) \
            - 0.5 * np.log(2 * np.pi * sigma**2) * (theta.shape[1] - 1)
        return like

    def torch_loglike(theta):
        sigma = 10 ** (theta[:, 0] * 4 - 2) * sigma0
        like = -0.5 * ((theta[:, 1:] - 0.5)**2
                       / sigma[:, None]**2).sum(dim=1) \
            - 0.5 * torch.log(2 * math.pi * sigma**2) * (theta.shape[1] - 1)
        return like

    return Problem('funnel%dd' % ndim, _names(ndim), loglike, None,
                   torch_loglike, None, logz=None)


def pyramid(ndim=2):
    """Pyramid: L = -max|theta - 0.5| (shrinkage-test problem)."""

    def loglike(theta):
        return -np.abs(theta - 0.5).max(axis=1)

    def torch_loglike(theta):
        return -torch.abs(theta - 0.5).amax(dim=1)

    return Problem('pyramid%dd' % ndim, _names(ndim), loglike, None,
                   torch_loglike, None, logz=None)


def sine(ndata=40, contrast=100, seed=2):
    """Periodic signal fit with a circular phase parameter.

    Sinusoid amplitude/jitter/phase/period regression on synthetic
    data (upstream examples/testsine.py); the phase axis is circular
    (``wrapped_params=[False, False, True, False]``).
    """
    rng = np.random.RandomState(seed)
    jitter_true = 0.1
    amplitude_true = contrast / ndata * jitter_true
    period_true = 180.0
    x = rng.uniform(0, 360, ndata)
    y = rng.normal(amplitude_true * np.sin(x / period_true * 2 * np.pi),
                   jitter_true)
    consts = _Consts(x.reshape((-1, 1)), y.reshape((-1, 1)))

    def loglike(params):
        amplitude, jitter, phase, period = params.T[:4]
        xcol = x.reshape((-1, 1))
        model = amplitude * np.sin(xcol / period * 2 * np.pi + phase)
        return (-0.5 * np.log(2 * np.pi * jitter**2)
                - 0.5 * ((model - y.reshape((-1, 1))) / jitter)**2).sum(axis=0)

    def torch_loglike(params):
        amplitude, jitter, phase, period = params.T[:4]
        xcol, ycol = consts(params)
        model = amplitude * torch.sin(xcol / period * 2 * math.pi + phase)
        return (-0.5 * torch.log(2 * math.pi * jitter**2)
                - 0.5 * ((model - ycol) / jitter)**2).sum(dim=0)

    def transform(u):
        z = np.empty((len(u), 4))
        z[:, 0] = 10 ** (u[:, 0] * 4 - 2)
        z[:, 1] = 10 ** (u[:, 1] * 1 - 1.5)
        z[:, 2] = 2 * np.pi * u[:, 2]
        z[:, 3] = 10 ** (u[:, 3] * 4 - 1)
        return z

    def torch_transform(u):
        return torch.stack([
            10 ** (u[:, 0] * 4 - 2),
            10 ** (u[:, 1] * 1 - 1.5),
            2 * math.pi * u[:, 2],
            10 ** (u[:, 3] * 4 - 1)], dim=1)

    prob = Problem('sine', ['amplitude', 'jitter', 'phase', 'period'],
                   loglike, transform, torch_loglike, torch_transform,
                   logz=None)
    prob.wrapped_params = [False, False, True, False]
    return prob


def slantedeggbox(ndim=2):
    """Eggbox modulated by a laplace peak at 5*pi per axis.

    Upstream examples/testslantedeggbox.py: the first two axes carry
    the eggbox modes, every axis adds a slanted |z - 5pi| pull, so the
    mode heights differ and the sampler must rank them.
    """
    assert ndim >= 2

    def loglike(z):
        chi = (2.0 + np.cos(z[:, 0] / 2) * np.cos(z[:, 1] / 2)) ** 5
        chi2 = -np.abs((z - 5 * np.pi) / 0.5).sum(axis=1)
        return chi + chi2

    def torch_loglike(z):
        chi = (2.0 + torch.cos(z[:, 0] / 2) * torch.cos(z[:, 1] / 2)) ** 5
        chi2 = -torch.abs((z - 5 * math.pi) / 0.5).sum(dim=1)
        return chi + chi2

    def transform(x):
        return x * 100

    def torch_transform(x):
        return x * 100

    return Problem('slantedeggbox%dd' % ndim, _names(ndim), loglike,
                   transform, torch_loglike, torch_transform, logz=None)


def corrpeak(ndim=6, crosssigma=0.005):
    """Mixed-scale gaussian with a non-linear degeneracy and pair ties.

    Upstream examples/testcorrpeak.py: per-axis sigmas spanning orders
    of magnitude, a product-degeneracy between the first two axes, and
    tight pairwise correlations between neighbours.
    """
    assert ndim >= 5
    sigmas = 10 ** (-2.0 + 2.0 * np.cos(np.arange(ndim) - 2)) \
        / (np.arange(ndim) - 2 + 1e-300)
    sigmas[:2] = 1.0
    # the i==2 axis is unconstrained; 1e30 keeps its term at zero in both
    # f32 and f64 without overflowing a float32 constant
    sigmas = np.minimum(np.abs(sigmas), 1e30)
    centers = np.full(ndim, 0.2)
    degsigma = 0.01
    c01 = float(centers[1] * centers[0])
    consts = _Consts(centers, sigmas)

    def loglike(theta):
        like = -0.5 * (((theta[:, 1:] - centers[1:])
                        / sigmas[1:])**2).sum(axis=1)
        like = like - 0.5 * ((theta[:, 1] * theta[:, 0]
                              - centers[1] * centers[0]) / degsigma)**2
        a = (theta[:, 3:-1] - centers[3:-1]) / sigmas[3:-1]
        b = (theta[:, 4:] - centers[4:]) / sigmas[4:]
        return like - 0.5 * (((a - b) / crosssigma)**2).sum(axis=1)

    def torch_loglike(theta):
        c, s = consts(theta)
        like = -0.5 * (((theta[:, 1:] - c[1:]) / s[1:])**2).sum(dim=1)
        like = like - 0.5 * ((theta[:, 1] * theta[:, 0] - c01)
                             / degsigma)**2
        a = (theta[:, 3:-1] - c[3:-1]) / s[3:-1]
        b = (theta[:, 4:] - c[4:]) / s[4:]
        return like - 0.5 * (((a - b) / crosssigma)**2).sum(dim=1)

    return Problem('corrpeak%dd' % ndim, _names(ndim), loglike, None,
                   torch_loglike, None, logz=None)


def hyperrect(ndim=2):
    """Top-hat likelihood growing towards the center: pure plateaus.

    L = -ndim*log(max|theta-0.5|): every likelihood contour is a
    hyperrectangle surface, the hardest case for plateau handling
    (upstream examples/testhyperrect.py). The evidence is dominated by
    the cap at L = 100 and is not analytic here.
    """

    def loglike(theta):
        delta = np.max(np.abs(theta - 0.5), axis=1)
        return np.minimum(-ndim * np.log(delta * 2 + 1e-15), 100.0)

    def torch_loglike(theta):
        delta = torch.abs(theta - 0.5).amax(dim=1)
        return torch.clamp(-ndim * torch.log(delta * 2 + 1e-15), max=100.0)

    return Problem('hyperrect%dd' % ndim, _names(ndim), loglike, None,
                   torch_loglike, None, logz=None)


def dirichlet(ndim=8, seed=4, ndata=10, nsamples=400):
    """Histogram deconvolution with a simplex (Dirichlet) prior.

    Upstream examples/rundirichlet.py: given noisy measurements, infer
    the fraction of objects per histogram bin; the prior transform maps
    the unit cube to the probability simplex via sorted uniforms.
    """
    rng = np.random.RandomState(seed)
    values = rng.normal(0, 15, size=ndata)
    widths = rng.uniform(3, 15, size=ndata)
    samples = values[:, None] + widths[:, None] * rng.normal(
        size=(ndata, nsamples))
    bins = np.linspace(-80, 80, ndim + 1)
    binned = np.array([np.histogram(row, bins=bins)[0]
                       for row in samples])
    consts = _Consts(binned)

    # the sampled space holds the first ndim-1 simplex coordinates; the
    # last bin fraction is 1 - sum (reconstructed in the likelihood)
    def loglike(params):
        last = 1.0 - params.sum(axis=1, keepdims=True)
        full = np.concatenate([params, last], axis=1)
        frac = np.dot(binned, full.T) / nsamples + 1e-300
        return np.log(frac).sum(axis=0)

    def torch_loglike(params):
        B, = consts(params)
        last = 1.0 - params.sum(dim=1, keepdim=True)
        full = torch.cat([params, last], dim=1)
        frac = (B @ full.T) / nsamples
        return torch.log(frac + 1e-30).sum(dim=0)

    def transform(u):
        # sorted-uniform gaps: uniform on the simplex
        filled = np.column_stack([np.zeros(len(u)), np.sort(u, axis=1),
                                  np.ones(len(u))])
        return np.diff(filled, axis=1)[:, :-1]

    def torch_transform(u):
        n = u.shape[0]
        filled = torch.cat([u.new_zeros((n, 1)), torch.sort(u, dim=1).values,
                            u.new_ones((n, 1))], dim=1)
        return torch.diff(filled, dim=1)[:, :-1]

    return Problem('dirichlet%dd' % ndim, _names(ndim - 1), loglike,
                   transform, torch_loglike, torch_transform, logz=None)
