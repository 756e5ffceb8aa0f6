"""The comparison that decides ``correct``.

Every fit completed in the window is judged, after the window has
closed, by the plain reference (``reference/<problem>.py``) in float64:

* ``logl_gap``: the widest gap between a kept point's log-likelihood
  (every dead and final live point of the fit's weighted samples) and
  the reference's at the point's unit-cube coordinates, over
  ``max(1, |reference|)``;
* ``point_gap``: the same for the point's parameters against the
  reference's transform of its coordinates;
* ``order_gap``: the widest drop from a kept point's log-likelihood to
  the next one's, in the order the fit removed them, over ``max(1,
  |log L|)`` (the device picks the worst live point in float32, so near
  ties may swap by the likelihood's float32 rounding);
* ``foreign_samples``: posterior samples that are no kept point;
* ``logz_gate``: ``|logZ - truth| / max(4 logzerr, floor)``, the largest
  over the fits, against the reference's truth.

:func:`numbers` also reads the control: the reference computed in a
lower precision, put in the program's place (its likelihoods, its
parameters and the logZ that its likelihoods give with the fit's own
weights), at the same points.
"""

import numpy as np

from .reference import ROUNDINGS, exact

NUMBERS = ('logl_gap', 'point_gap', 'order_gap', 'foreign_samples',
           'logz_gate')


def _rel_gap(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    if got.size == 0:
        return 0.0
    gap = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    gap = np.where(np.isfinite(got) & np.isfinite(want), gap, np.inf)
    return float(gap.max())


def _logsumexp(a):
    m = np.max(a)
    return float(m + np.log(np.exp(a - m).sum()))


def _order_gap(logl):
    if logl.size < 2:
        return 0.0
    drop = np.maximum(logl[:-1] - logl[1:], 0.0)
    return float((drop / np.maximum(1.0, np.abs(logl[:-1]))).max())


def _foreign(samples, points):
    rows = {r.tobytes() for r in np.ascontiguousarray(points)}
    return int(sum(r.tobytes() not in rows
                   for r in np.ascontiguousarray(samples)))


def fit_numbers(fit, ref, args, truth, floor, control=None):
    """The five numbers of one fit. With *control* (a rounding name), the
    reference in that precision takes the program's place."""
    u = fit['upoints']
    points_ref = ref.transform(u, exact, **args)
    logl_ref = ref.loglike(points_ref, exact, **args)
    if control is None:
        points, logl, logz = fit['points'], fit['logl'], fit['logz']
        samples = fit['samples']
    else:
        r = ROUNDINGS[control]
        points = ref.transform(u, r, **args)
        logl = ref.loglike(points, r, **args)
        # the fit's own weights, reweighted by the control's likelihoods
        logz = fit['logz'] + _logsumexp(fit['logw'] + logl - fit['logl'])
        samples = points[_sample_rows(fit)]
    return dict(
        logl_gap=_rel_gap(logl, logl_ref),
        point_gap=_rel_gap(points, points_ref),
        order_gap=_order_gap(logl),
        foreign_samples=_foreign(samples, points),
        logz_gate=float(abs(logz - truth) / max(4 * fit['logzerr'], floor))
        if np.isfinite(logz) else float('inf'))


def _sample_rows(fit):
    index = {r.tobytes(): i for i, r in
             enumerate(np.ascontiguousarray(fit['points']))}
    return np.array([index.get(r.tobytes(), 0) for r in
                     np.ascontiguousarray(fit['samples'])], dtype=int)


def numbers(fits, config, ref, truth, control=None):
    """Each number over every fit: the largest, or the sum of the counts.
    No fit gives infinite readings."""
    out = {k: 0 for k in NUMBERS}
    if not fits:
        return {k: float('inf') for k in NUMBERS}
    args = config['problem_args']
    for fit in fits:
        one = fit_numbers(fit, ref, args, truth, config['gate']['floor'],
                          control)
        for k in NUMBERS:
            if k == 'foreign_samples':
                out[k] += one[k]
            else:
                out[k] = max(out[k], one[k])
    return out


def judge(nums, limits):
    """(correct, [(name, value, limit)]): every number at or below its
    limit; a number without a limit fails."""
    rows = [(k, nums[k], limits.get(k)) for k in NUMBERS]
    ok = all(lim is not None and np.isfinite(v) and v <= lim
             for _, v, lim in rows)
    return ok, rows
