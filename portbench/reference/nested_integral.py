"""The nested-sampling integral over a tree whose width varies, in plain
float64 numpy, written from the published formulas: Skilling (2006,
Bayesian Analysis 1(4):833) for the volume's shrinkage and the weights,
and Higson, Handley, Hobson and Lasenby (2019, Statistics and Computing
29:891, section 2) for runs whose number of live points changes.

A run is its points: each point's birth threshold (the log-likelihood
of the point it was drawn above, its parent in the tree; minus infinity
for a point drawn from the whole prior) and its own log-likelihood. The
points die in the order of their log-likelihoods. When point *i* dies,
the live points are those born below its log-likelihood that have not
died before it (Higson et al., section 2):

    n_i = #{j : birth_j < L_i <= L_j}.

A death that is followed by a birth at its threshold shrinks the
enclosed prior volume X by the factor t_i, E[log t_i] = -1 / n_i
(Skilling; Higson et al., section 2), so

    log X_i = log X_(i-1) - 1 / n_i,
    log w_i = log X_(i-1) + log(1 - exp(-1 / n_i)) + L_i,

with X_0 = 1; the weights are then normalised by Z = sum_i w_i.

Departures, each one a convention of UltraNest's ``SingleCounter``
(``ultranest/netiter.py``), which the sampler under test follows:

* A death after which no point is born at its threshold (a leaf of the
  tree: the run narrows there, or it is one of the live points left at
  the end) removes a live point without replacing it. Such a death is
  counted as Skilling counts the live points left at the end, the
  remainder: each takes an equal share of the volume left,

      log w_i = log X_(i-1) - log n_i + L_i,
      log X_i = log X_(i-1) + log(1 - 1 / n_i),

  so the final live points together add X_end times their mean
  likelihood. Higson et al. give every death the shrinkage of the
  first rule; the two differ in where within a narrowing the volume is
  booked.
* The shrinkage is its expectation, not drawn (Skilling's "mean"
  estimate; upstream draws it only for its bootstrap estimates).
* Points of equal log-likelihood die in the order they are given; the
  counts above treat them as distinct (the formula for n_i counts a tie
  as alive).
"""

import numpy as np


def _logsumexp(a):
    a = np.asarray(a, dtype=np.float64)
    finite = a[np.isfinite(a)]
    if finite.size == 0:
        return -np.inf
    m = finite.max()
    return float(m + np.log(np.exp(finite - m).sum()))


def integrate(birth, logl):
    """The integral over the points given by *birth* and *logl* (arrays
    of one length). Returns a dict of arrays in the order of death:
    ``order`` (indices into the input), ``logl``, ``nlive`` (n_i),
    ``children`` (the points born at each one's log-likelihood),
    ``logx`` (log X_i after each death), ``logwidth`` (log w_i - L_i),
    ``logw`` (the normalised log weights), and ``logz``."""
    birth = np.asarray(birth, dtype=np.float64)
    logl = np.asarray(logl, dtype=np.float64)
    assert birth.shape == logl.shape and birth.ndim == 1
    assert np.all(birth < logl), 'a point lies below its birth threshold'
    order = np.argsort(logl, kind='stable')
    L = logl[order]
    births = np.sort(birth)
    # alive at L_i: born below L_i, minus those that died below L_i
    nlive = (np.searchsorted(births, L, side='left')
             - np.searchsorted(L, L, side='left'))
    # the points born at each death's threshold: its children
    children = (np.searchsorted(births, L, side='right')
                - np.searchsorted(births, L, side='left'))
    n = nlive.astype(np.float64)
    logx = np.empty(len(L))
    logwidth = np.empty(len(L))
    x = 0.0
    with np.errstate(divide='ignore'):
        for i in range(len(L)):
            if children[i] > 0:
                logwidth[i] = x + np.log1p(-np.exp(-1.0 / n[i]))
                x = x - 1.0 / n[i]
            else:
                logwidth[i] = x - np.log(n[i])
                x = x + np.log1p(-1.0 / n[i])
            logx[i] = x
    logz = _logsumexp(logwidth + L)
    return dict(order=order, logl=L, nlive=nlive, children=children,
                logx=logx, logwidth=logwidth, logw=logwidth + L - logz,
                logz=logz)
