# noqa: D400 D205
"""
Utility helpers: logging, run directories, statistics
-----------------------------------------------------

Host-side cold-path helpers (capability equivalent of
ultranest/utils.py, same public names).
"""

import logging
import math
import os
import sys

import numpy as np

__all__ = [
    'create_logger', 'make_run_dir', 'vectorize', 'resample_equal',
    'listify', 'quantile', 'vol_prefactor', 'is_affine_transform',
    'normalised_kendall_tau_distance', 'verify_gradient',
    'distributed_work_chunk_size', 'submasks',
]

SQRTEPS = float(np.finfo(float).eps) ** 0.5


def create_logger(module_name, log_dir=None, level=logging.INFO):
    """Set up the logging channel *module_name*.

    Appends DEBUG-level records to ``debug.log`` inside *log_dir* (if given)
    and writes records at *level* or above to stdout. Idempotent: if the
    channel already has handlers, none are added.

    Parameters
    ----------
    module_name: str
        logger channel name
    log_dir: str or None
        directory for the debug.log file
    level: int
        stdout logging threshold

    Returns
    -------
    logger: logging.Logger
    """
    logger = logging.getLogger(str(module_name))
    if logger.handlers:
        return logger
    logger.setLevel(logging.DEBUG)

    handlers = []
    if log_dir is not None:
        to_file = logging.FileHandler(os.path.join(log_dir, 'debug.log'))
        to_file.setLevel(logging.DEBUG)
        to_file.setFormatter(logging.Formatter(
            fmt='%%(asctime)s [%s] [%%(levelname)s] %%(message)s'
                % module_name,
            datefmt='%H:%M:%S'))
        handlers.append(to_file)
    to_stdout = logging.StreamHandler(sys.stdout)
    to_stdout.setLevel(level)
    to_stdout.setFormatter(logging.Formatter('[%s] %%(message)s'
                                             % module_name))
    handlers.append(to_stdout)
    handlers.append(logging.NullHandler())
    for h in handlers:
        logger.addHandler(h)
    return logger


def make_run_dir(log_dir, run_num=None, append_run_num=True,
                 max_run_num=10000):
    """Create a numbered output directory tree for a run.

    Layout mirrors the reference (utils.py:77-130): ``run_dir/{info,results,
    chains,extra,plots}``.

    Parameters
    ----------
    log_dir: str
        base path
    run_num: int or None
        subfolder number; auto-incremented when None
    append_run_num: bool
        whether to nest into ``runN`` subfolder
    max_run_num: int
        maximum number of automatic run subfolders

    Returns
    -------
    folderpath: dict
        keys: run_dir, info, results, chains, extra, plots
    """
    os.makedirs(log_dir, exist_ok=True)
    if run_num in (None, ''):
        taken = {name for name in os.listdir(log_dir)
                 if name.startswith('run')}
        run_num = next(
            (k for k in range(1, max_run_num) if 'run%d' % k not in taken),
            None)
        if run_num is None:
            raise ValueError(
                "log directory '%s' already contains the maximum number "
                "of run subdirectories (%d)" % (log_dir, max_run_num))
    run_dir = log_dir
    if append_run_num:
        run_dir = os.path.join(log_dir, 'run%s' % run_num)
    if not os.path.isdir(run_dir):
        print('Creating directory for new run %s' % run_dir)
    paths = dict(run_dir=run_dir)
    for sub in ('info', 'results', 'chains', 'extra', 'plots'):
        paths[sub] = os.path.join(run_dir, sub)
        os.makedirs(paths[sub], exist_ok=True)
    return paths


def vectorize(function):
    """Wrap a single-point function into one accepting arrays of points."""
    def vectorized(args):
        """Vectorized version of function."""
        return np.asarray([function(arg) for arg in args])

    vectorized.__name__ = getattr(function, '__name__', vectorized.__name__)
    return vectorized


def resample_equal(samples, weights, rstate=None):
    """Systematic resampling to equally weighted samples.

    Each input sample appears ``floor(w*N)`` or ``ceil(w*N)`` times in the
    output (cf. reference utils.py:149-215). Output order is shuffled.

    Parameters
    ----------
    samples: array (N, ...)
        weighted samples
    weights: array (N,)
        sample weights, must sum to 1
    rstate: numpy random state or None

    Returns
    -------
    equal_weight_samples: array, same shape as samples
    """
    weights = np.asarray(weights)
    if abs(weights.sum() - 1.0) > SQRTEPS:
        raise ValueError("weights do not sum to 1 (%g)" % weights.sum())
    if rstate is None:
        rstate = np.random
    N = len(weights)
    # systematic comb positions with a single random offset,
    # inverted through the cdf in one vectorized searchsorted
    positions = (rstate.random() + np.arange(N)) / N
    cdf = np.cumsum(weights)
    cdf[-1] = max(cdf[-1], positions[-1] + np.finfo(float).eps)
    idx = np.searchsorted(cdf, positions, side='right')
    idx = np.clip(idx, 0, N - 1).astype(np.int_)
    rstate.shuffle(idx)
    return samples[idx]


def listify(*args):
    """Concatenate the given iterables into one list."""
    out = []
    for a in args:
        out.extend(a)
    return out


def quantile(x, q, weights=None):
    """Compute (weighted) quantiles of samples *x* at levels *q*."""
    x = np.atleast_1d(x)
    q = np.atleast_1d(q)
    if ((q < 0) | (q > 1)).any():
        raise ValueError("Quantiles must be between 0. and 1.")
    if weights is None:
        return np.percentile(x, list(100.0 * q))
    weights = np.atleast_1d(weights)
    if x.shape != weights.shape:
        raise ValueError("Dimension mismatch: len(weights) != len(x).")
    order = np.argsort(x)
    levels = np.cumsum(weights[order])
    levels = np.concatenate([[0.0], levels[:-1] / levels[-2]]) \
        if len(levels) > 1 else np.zeros(1)
    return np.interp(q, levels, x[order]).tolist()


def vol_prefactor(n):
    """Volume constant of an *n*-dimensional unit sphere.

    ``V_n = pi^(n/2) / Gamma(n/2 + 1)`` (closed form; the reference
    builds the same value by recurrence).
    """
    return math.pi ** (n / 2.0) / math.gamma(n / 2.0 + 1)


def is_affine_transform(a, b):
    """Check whether points *b* are an axis-wise affine image of points *a*.

    Returns False for rotations (per-axis slopes must agree across pairs).
    """
    npts, da = a.shape
    assert len(b) == npts
    assert b.shape[1] >= da
    half = (npts // 2) * 2
    lo, hi = a[0:half:2], a[1:half:2]
    blo, bhi = b[0:half:2, :da], b[1:half:2, :da]
    with np.errstate(divide='ignore', invalid='ignore'):
        slopes = (bhi - blo) / (hi - lo)
    if not np.allclose(slopes, slopes[0]):
        return False
    intercepts = blo - slopes * lo
    return bool(np.allclose(intercepts, intercepts[0]))


def normalised_kendall_tau_distance(values1, values2, i=None, j=None):
    """Normalised Kendall tau distance between two equally sized rankings.

    *i*, *j* may be precomputed ``np.meshgrid(np.arange(N), np.arange(N))``
    index matrices (kept for API compatibility; unused by the vectorized
    implementation).
    """
    N = len(values1)
    if len(values2) != N:
        raise AssertionError("Both lists have to be of equal length")
    if N < 2:
        return 0.0
    a = np.argsort(values1)
    b = np.argsort(values2)
    # pairwise order disagreement, fully vectorized
    sa = np.sign(a[:, None] - a[None, :])
    sb = np.sign(b[:, None] - b[None, :])
    ndisordered = np.count_nonzero(sa * sb < 0)
    return ndisordered / (N * (N - 1))


def verify_gradient(ndim, transform, loglike, gradient, verbose=False,
                    combination=False):
    """Numerically check a user gradient function for plausibility.

    Raises AssertionError on failure. All functions vectorized; *gradient*
    takes a single unit-cube point. If *combination*, gradient returns
    ``(params, loglike, grad)`` directly.
    """
    if combination:
        combined = gradient
    else:
        def combined(u):
            p = transform(u.reshape((1, -1)))
            return p[0], loglike(p)[0], gradient(u)

    eps = 1e-6
    for _ in range(10):
        u = np.random.uniform(2 * eps, 1 - 2 * eps, size=(1, ndim))
        theta = transform(u)
        Lref = loglike(theta)[0]
        p, L, grad = combined(u[0, :])
        assert np.allclose(p, theta), (p, theta)
        assert np.allclose(L, Lref), (L, Lref)
        step = eps * grad / (grad**2).sum()**0.5
        uprime = u + step
        Lprime = loglike(transform(uprime))[0]
        Lexpected = Lref + np.dot(step, grad)
        if verbose:
            print("verify_gradient:", u, L, Lprime, Lexpected)
        assert np.allclose(Lprime, Lexpected, atol=0.1 / ndim), \
            (u, uprime, grad, L, Lprime, Lexpected)


def summarize_posterior(samples):
    """Standard posterior summary block of the results schema."""
    lo, mid, hi = np.percentile(samples, [15.8655, 50, 84.1345], axis=0)
    return dict(
        mean=samples.mean(axis=0).tolist(),
        stdev=samples.std(axis=0).tolist(),
        median=mid.tolist(), errlo=lo.tolist(), errup=hi.tolist(),
    )


def information_gain_bits(upoints, weights, nbins=40):
    """Per-axis KL information gain of the posterior vs the unit cube."""
    edges = np.linspace(0, 1, nbins)
    out = []
    for col in np.asarray(upoints).T:
        dens, _ = np.histogram(col, weights=weights, density=True,
                               bins=edges)
        out.append(float((np.log2(1 / ((dens + 0.001) * nbins))
                          / nbins).sum()))
    return out


def effective_sample_size(weights):
    """Kish-style effective sample size of normalized *weights*."""
    n = len(weights)
    return n / (1.0 + ((n * weights - 1) ** 2).sum() / n)


def distributed_work_chunk_size(num_total_tasks, mpi_rank, mpi_size):
    """Number of tasks assigned to shard *mpi_rank* of *mpi_size* shards."""
    return (num_total_tasks + mpi_size - 1 - mpi_rank) // mpi_size


def submasks(mask, *masks):
    """Indices such that ``a[indices] == a[mask][mask1][mask2]...``."""
    indices = np.flatnonzero(mask)
    for othermask in masks:
        indices = indices[othermask]
    return indices
