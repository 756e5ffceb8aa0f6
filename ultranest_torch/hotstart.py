# noqa: D400 D205
"""
Warm start: accelerate a fresh run with a previous posterior
------------------------------------------------------------

Deforms the unit-cube prior around a known posterior (from an earlier or
similar run) and undoes the deformation with a correction weight carried
as an extra derived parameter — so a fresh run needs far fewer
iterations. Based on Petrosyan & Handley (2022, arxiv:2212.01760).
Counterpart of ``ultranest_tpu/hotstart.py``: the host closures are
copies; the contbox deformation also comes as batched torch functions
(``.torch`` attributes, :func:`_contbox_torch_functions`), so that a
warm-started run keeps the device path, and :func:`reuse_samples` can
evaluate a torch likelihood on a device.
"""

import numpy as np
import torch

from .utils import (effective_sample_size, information_gain_bits,
                    resample_equal, summarize_posterior, vectorize)

__all__ = [
    'get_auxiliary_problem', 'get_extended_auxiliary_problem',
    'get_extended_auxiliary_independent_problem',
    'compute_quantile_intervals', 'compute_quantile_intervals_refined',
    'get_auxiliary_contbox_parameterization', 'reuse_samples',
]


def get_auxiliary_problem(loglike, transform, ctr, invcov,
                          enlargement_factor, df=1):
    """Build an auxiliary problem from a posterior gaussian approximation.

    The prior is deformed into a d-dimensional Student-t centered on the
    posterior; the likelihood divides out the deformation density.

    Parameters
    ----------
    loglike, transform: functions
        original model functions (non-vectorized)
    ctr: array
        posterior center in u-space
    invcov: array
        inverse posterior covariance in u-space
    enlargement_factor: float
        scale inflation (sqrt(ndim) works for gaussian-like posteriors)
    df: float
        Student-t degrees of freedom (>=1)

    Returns
    -------
    aux_loglike, aux_aftertransform: functions
    """
    axes, student = _student_deformation(invcov, enlargement_factor, df)

    def to_cube(u):
        coords = student.ppf(u)
        return ctr + coords @ axes, student.logpdf(coords).sum()

    def aux_loglikelihood(u):
        x, logdens = to_cube(u)
        inside = (x > 0).all() and (x < 1).all()
        return loglike(transform(x)) - logdens if inside else -1e300

    def aux_aftertransform(u):
        return transform(to_cube(u)[0])

    return aux_loglikelihood, aux_aftertransform


def _student_deformation(invcov, enlargement_factor, df):
    """Whitening axes + 1d Student-t for a gaussian posterior proxy."""
    import scipy.stats
    assert df >= 1, ('Degrees of freedom must be above 1', df)
    eigval, eigvec = np.linalg.eigh(invcov)
    axes = eigvec * (enlargement_factor / np.sqrt(eigval))[None, :]
    return axes, scipy.stats.t(df)


def get_extended_auxiliary_problem(loglike, transform, ctr, invcov,
                                   enlargement_factor, df=1):
    """Like :func:`get_auxiliary_problem`, carrying the correction weight.

    The returned transform outputs d+1 parameters: the physical parameters
    plus the log correction weight; the likelihood adds the weight.
    """
    ndim, = ctr.shape
    assert invcov.shape == (ndim, ndim)
    axes, student = _student_deformation(invcov, enlargement_factor, df)
    weight_ref = student.logpdf(0) * ndim

    def aux_transform(u):
        coords = student.ppf(u)
        x = ctr + axes @ coords
        if ((x <= 0) | (x >= 1)).any():
            return np.append(transform(np.full_like(x, 0.5)), -1e101)
        logweight = weight_ref - student.logpdf(coords).sum()
        return np.append(transform(x), logweight)

    return _weighted_aux_loglike(loglike, weight_ref), aux_transform


def _weighted_aux_loglike(loglike, weight_ref):
    """Likelihood adding the deformation's carried log-weight parameter."""
    def aux_loglikelihood(x):
        logweight = x[-1]
        if not -1e100 < logweight < 1e100:
            return -1e300
        return loglike(x[:-1]) + logweight - weight_ref
    return aux_loglikelihood


def get_extended_auxiliary_independent_problem(loglike, transform, ctr, err,
                                               df=1):
    """Axis-independent Student-t deformation with correction weight.

    Parameters as :func:`get_extended_auxiliary_problem` with per-axis
    standard deviations *err* instead of a covariance.
    """
    import scipy.stats
    ndim, = np.shape(ctr)
    assert np.shape(err) == (ndim,)
    assert df >= 1, ('Degrees of freedom must be above 1', df)

    student = scipy.stats.t(df, ctr, err)
    # restrict the per-axis auxiliary distributions to the unit interval
    cdf_lo = student.cdf(0)
    cdf_span = student.cdf(1) - cdf_lo
    weight_ref = student.logpdf(ctr).sum()

    def aux_transform(u):
        x = student.ppf(cdf_lo + cdf_span * u)
        logweight = weight_ref - student.logpdf(x).sum()
        return np.append(transform(x), logweight)

    return _weighted_aux_loglike(loglike, weight_ref), aux_transform


def compute_quantile_intervals(steps, upoints, uweights):
    """Per-axis weighted quantile envelopes at each level in *steps*.

    Returns (ulos, uhis) of shape (len(steps)+1, ndim); the last row is
    the full unit interval.
    """
    nboxes = len(steps)
    # per-axis sorted values + cumulative weights, fully vectorized
    order = np.argsort(upoints, axis=0)
    sorted_u = np.take_along_axis(upoints, order, axis=0)
    cum = np.cumsum(uweights[order], axis=0)          # (nsamples, ndim)
    thresh = np.asarray(steps).reshape((-1, 1, 1))
    inside = (cum[None, :, :] >= thresh) \
        & (cum[None, :, :] <= 1 - thresh)             # (nboxes, n, ndim)
    big = np.where(inside, sorted_u[None, :, :], np.inf)
    small = np.where(inside, sorted_u[None, :, :], -np.inf)
    ulos = np.concatenate([big.min(axis=1),
                           np.zeros((1, upoints.shape[1]))])
    uhis = np.concatenate([small.max(axis=1),
                           np.ones((1, upoints.shape[1]))])
    return ulos, uhis


def compute_quantile_intervals_refined(steps, upoints, uweights,
                                       logsteps_max=20):
    """Quantile envelopes with log-spaced relaxation towards the unit cube.

    Returns (ulos, uhis, uinterpspace): envelopes of shape (M, ndim) and
    the interpolation abscissae (length M).
    """
    nboxes = len(steps)
    ulos_orig, uhis_orig = compute_quantile_intervals(steps, upoints, uweights)

    smallest_axis_width = np.min(uhis_orig[-2, :] - ulos_orig[-2, :])
    logsteps = min(logsteps_max,
                   int(np.ceil(-np.log10(max(1e-100, smallest_axis_width)))))

    weights = np.logspace(-logsteps, 0, logsteps + 1).reshape((-1, 1))
    ulos_new = ulos_orig[nboxes - 1, :].reshape((1, -1)) * (1 - weights)
    uhis_new = uhis_orig[nboxes - 1, :].reshape((1, -1)) * (1 - weights) \
        + 1 * weights

    ulos = np.vstack((ulos_orig[:-1, :], ulos_new))
    uhis = np.vstack((uhis_orig[:-1, :], uhis_new))
    assert (ulos[-1, :] == 0).all()
    assert (uhis[-1, :] == 1).all()

    uinterpspace = np.ones(nboxes + logsteps + 1)
    uinterpspace[:nboxes + 1] = np.linspace(0, 1, nboxes + 1)
    uinterpspace[nboxes:] = np.linspace(uinterpspace[nboxes - 1], 1,
                                        logsteps + 2)[1:]
    return ulos, uhis, uinterpspace


def get_auxiliary_contbox_parameterization(param_names, loglike, transform,
                                           upoints, uweights,
                                           vectorized=False,
                                           torch_loglike=None,
                                           torch_transform=None):
    """Deform the prior with per-axis quantile boxes of a previous posterior.

    Each axis is compressed towards the posterior quantile envelope; an
    extra parameter ``u[-1]`` interpolates between the tightest box and
    the full cube, and its volume correction is returned as the derived
    parameter ``aux_logweight`` (added to the likelihood).

    When *torch_loglike* (and optionally *torch_transform*) are given,
    batched torch model functions as accepted by
    :class:`~ultranest_torch.integrator.ReactiveNestedSampler`, the
    returned aux functions also carry batched torch counterparts as
    ``.torch`` attributes, so a warm-started run keeps the device path::

        names, aux_ll, aux_tr, vec = get_auxiliary_contbox_parameterization(
            ..., torch_loglike=tl, torch_transform=tt)
        sampler = ReactiveNestedSampler(
            names, aux_ll, transform=aux_tr, vectorized=vec,
            torch_loglike=aux_ll.torch, torch_transform=aux_tr.torch)

    Returns
    -------
    aux_param_names, aux_loglike, aux_transform, vectorized
    """
    upoints = np.asarray(upoints)
    assert upoints.ndim == 2, (
        'expected 2d array for upoints, got shape: %s' % str(upoints.shape))
    mask = np.logical_and(upoints > 0, upoints < 1).all(axis=1)
    assert np.all(mask), (
        'upoints must be between 0 and 1, have:', upoints[~mask, :])
    steps = 10.0 ** -(1.0 * np.arange(1, 8, 2))
    nsamples, ndim = upoints.shape
    assert nsamples > 10
    ulos, uhis, uinterpspace = compute_quantile_intervals_refined(
        steps, upoints, uweights)

    aux_param_names = list(param_names) + ['aux_logweight']

    def _deform(u2d):
        """Vectorized box deformation of (n, ndim+1) points."""
        t = u2d[:, -1]
        umod = np.empty((len(u2d), ndim))
        logvol = np.zeros(len(u2d))
        for i in range(ndim):
            ulo_here = np.interp(t, uinterpspace, ulos[:, i])
            uhi_here = np.interp(t, uinterpspace, uhis[:, i])
            umod[:, i] = ulo_here + (uhi_here - ulo_here) * u2d[:, i]
            logvol += np.log(uhi_here - ulo_here)
        return umod, logvol

    def aux_transform(u):
        assert u.shape == (ndim + 1,)
        umod, logvol = _deform(u.reshape((1, -1)))
        return np.append(transform(umod[0]), logvol[0])

    def aux_transform_vectorized(u):
        assert u.shape[1] == ndim + 1
        umod, logvol = _deform(u)
        return np.hstack((transform(umod), logvol.reshape((-1, 1))))

    def aux_loglikelihood(x):
        return loglike(x[:-1]) + x[-1]

    def aux_loglikelihood_vectorized(x):
        return loglike(x[:, :-1]) + x[:, -1]

    if vectorized:
        ret_loglike, ret_transform = (aux_loglikelihood_vectorized,
                                      aux_transform_vectorized)
    else:
        ret_loglike, ret_transform = aux_loglikelihood, aux_transform

    if torch_loglike is not None:
        tll, ttr = _contbox_torch_functions(
            torch_loglike, torch_transform, ulos, uhis, uinterpspace, ndim)
        ret_loglike.torch = tll
        ret_transform.torch = ttr

    return aux_param_names, ret_loglike, ret_transform, vectorized


def interp(x, xp, fp):
    """``jnp.interp(x, xp, fp)`` on torch tensors, for every column of *fp*.

    *x* (n,) are the abscissae, *xp* (m,) the increasing knots and *fp*
    (m,) or (m, k) the values at the knots; returns (n,) or (n, k). As
    ``jnp.interp``: below the first knot the first value, above the last
    the last, and between two knots a straight line from the left one,
    ``fp[i-1] + (x - xp[i-1]) / (xp[i] - xp[i-1]) * (fp[i] - fp[i-1])``
    (the left value where two knots coincide). torch has no ``interp``.
    """
    i = torch.searchsorted(xp, x, right=True).clamp(1, len(xp) - 1)
    x_lo, f_lo = xp[i - 1], fp[i - 1]
    dx = xp[i] - x_lo
    delta = x - x_lo
    if fp.ndim == 2:
        dx, delta = dx[:, None], delta[:, None]
    # jnp.interp's threshold, np.spacing(eps), is eps squared
    dx0 = dx.abs() <= torch.finfo(xp.dtype).eps ** 2
    frac = delta / torch.where(dx0, 1.0, dx)
    f = torch.where(dx0, f_lo, f_lo + frac * (fp[i] - f_lo))
    below = x < xp[0]
    above = x > xp[-1]
    if fp.ndim == 2:
        below, above = below[:, None], above[:, None]
    f = torch.where(below, fp[0], f)
    return torch.where(above, fp[-1], f)


def _contbox_torch_functions(torch_loglike, torch_transform, ulos, uhis,
                             uinterpspace, ndim):
    """Batched torch contbox deformation around device model functions.

    The counterpart of ``_contbox_jax_functions``
    (``ultranest_tpu/hotstart.py:282-318``): the per-axis quantile
    interpolation is :func:`interp` over the envelope columns, and the
    deformation's log-volume correction is appended as the derived
    ``aux_logweight`` column and added to the likelihood, as the host
    closures do. The envelopes are taken in the input's dtype, on its
    device.
    """
    tables = {}

    def envelopes(u2d):
        key = (u2d.dtype, u2d.device)
        if key not in tables:
            tables[key] = tuple(
                torch.as_tensor(np.asarray(a), dtype=u2d.dtype,
                                device=u2d.device)
                for a in (ulos, uhis, uinterpspace))
        return tables[key]

    def deform(u2d):
        lo, hi, knots = envelopes(u2d)
        t = u2d[:, -1].contiguous()
        ulo = interp(t, knots, lo)                      # (n, ndim)
        uhi = interp(t, knots, hi)
        span = uhi - ulo
        umod = ulo + span * u2d[:, :ndim]
        logvol = torch.log(span).sum(dim=1)
        return umod, logvol

    def torch_aux_transform(u2d):
        umod, logvol = deform(u2d)
        v = torch_transform(umod) if torch_transform is not None else umod
        return torch.cat([v, logvol[:, None].to(v.dtype)], dim=1)

    def torch_aux_loglike(x2d):
        return torch_loglike(x2d[:, :-1]) + x2d[:, -1]

    return torch_aux_loglike, torch_aux_transform


def reuse_samples(param_names, loglike, points, logl, logw=None,
                  logz=0.0, logzerr=0.0, upoints=None,
                  batchsize=128, vectorized=False, log_weight_threshold=-10,
                  torch_loglike=None, device='cuda', **kwargs):
    """Importance-reweight a finished run onto a new likelihood.

    Processes points in decreasing weight order and stops early once the
    remaining points cannot contribute above *log_weight_threshold*.
    When *torch_loglike* (batched, on torch tensors) is given, the
    re-evaluations run on *device* ('cuda' by default; 'cpu' on request)
    in float32 instead of through the host function.

    Returns a results dictionary in the standard schema (logz, ess,
    posterior summaries, weighted and equally weighted samples).
    """
    if torch_loglike is not None:
        def loglike(pts, _tll=torch_loglike):
            x = torch.as_tensor(np.asarray(pts), dtype=torch.float32,
                                device=device)
            return _tll(x).double().cpu().numpy()
    elif not vectorized:
        loglike = vectorize(loglike)

    Npoints, ndim = points.shape
    if logw is None:
        logw = np.full(Npoints, -np.log(Npoints))
    assert logl.shape == logw.shape == (Npoints,)
    logl_new = np.full(Npoints, -np.inf)
    logw_new = np.full(Npoints, -np.inf)

    # evaluate in decreasing old-weight order; once an entire batch falls
    # below the contribution threshold, the remainder cannot matter
    by_weight = np.argsort(logl + logw)[::-1]
    ncall = 0
    floor = log_weight_threshold - np.log(Npoints)
    for start in range(0, Npoints, batchsize):
        batch = by_weight[start:start + batchsize]
        logl_new[batch] = loglike(points[batch, :])
        logw_new[batch] = logw[batch] + logl_new[batch]
        ncall += len(batch)
        if (logw_new[batch] < np.nanmax(logw_new) + floor).all():
            break

    logw_peak = logw_new.max()
    w = np.exp(logw_new - logw_peak)
    logz_new = np.log(w.sum()) + logw_peak
    w /= w.sum()

    scatter = (((w - 1.0 / Npoints) ** 2).sum() / (Npoints - 1)) ** 0.5
    logzerr_total = np.hypot(np.log1p(scatter), logzerr)

    samples = resample_equal(points, w)
    posterior = summarize_posterior(samples)
    posterior['information_gain_bits'] = information_gain_bits(points, w)

    best = logl_new.argmax()
    return dict(
        ncall=ncall, niter=Npoints,
        logz=logz_new, logzerr=logzerr_total,
        ess=effective_sample_size(w),
        posterior=posterior,
        weighted_samples=dict(
            upoints=upoints, points=points, weights=w, logw=logw,
            logl=logl_new),
        samples=samples,
        maximum_likelihood=dict(
            logl=logl_new[best],
            point=points[best, :].tolist(),
            point_untransformed=upoints[best, :].tolist()
            if upoints is not None else None,
        ),
        param_names=param_names,
    )
