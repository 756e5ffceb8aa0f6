# noqa: D400 D205
"""
Vectorized population step-sampler state machines (host tier)
-------------------------------------------------------------

Carried over unchanged from ``ultranest_tpu/ops/stepfuncs.py`` (pure
numpy): the slice-sampling stepping-out/shrink state machine over a
whole walker population, batched direction generators, and the
chain-revert logic, covering the reference Cython module
(``ultranest/stepfuncs.pyx``). The per-walker branching of its OpenMP
loops becomes mask arithmetic over the population axis.

This tier serves arbitrary (non-torch) user likelihoods, where the
batched likelihood call is the only device boundary. With a torch
likelihood, :mod:`ultranest_torch.popfused` runs the whole walk on the
device instead.
"""

import numpy as np

__all__ = [
    'within_unit_cube', 'evolve_prepare', 'evolve_update', 'evolve',
    'step_back', 'update_vectorised_slice_sampler',
    'generate_cube_oriented_direction',
    'generate_cube_oriented_direction_scaled', 'generate_random_direction',
    'generate_region_oriented_direction', 'generate_region_random_direction',
    'generate_differential_direction', 'generate_mixture_random_direction',
    'int_dtype',
]

int_dtype = np.int64


def within_unit_cube(u):
    """Whether each row of *u* lies strictly inside the unit cube."""
    return np.logical_and(u > 0.0, u < 1.0).all(axis=1)


def evolve_prepare(searching_left, searching_right):
    """Split walkers into three mutually exclusive slice states.

    Returns (search_right, bisecting): stepping out rightwards (right but
    not left), and bisecting (neither).
    """
    searching_left = np.asarray(searching_left, dtype=bool)
    searching_right = np.asarray(searching_right, dtype=bool)
    search_right = np.logical_and(~searching_left, searching_right)
    bisecting = ~np.logical_or(searching_left, searching_right)
    return search_right, bisecting


def evolve_update(acceptable, Lnew, Lmin, search_right, bisecting, currentt,
                  current_left, current_right, searching_left,
                  searching_right, success):
    """Advance the slice state machine of every walker (in place).

    Robust slice sampling with stepping-out by doubling: stepping-out ends
    double while proposals stay accepted; bisecting walkers shrink their
    interval towards the proposal, and an accepted bisection completes the
    step (currentt reset to NaN).

    Parameters match the reference kernel (`stepfuncs.pyx:99-183`):
    *acceptable* marks walkers whose proposal was evaluated (inside the
    cube), *Lnew* holds likelihoods compacted over acceptable walkers.
    Writes to currentt, current_left, current_right, searching_left,
    searching_right, success.
    """
    acceptable = np.asarray(acceptable, dtype=bool)
    success[acceptable] = (np.asarray(Lnew) > Lmin)

    ok = success.astype(bool)
    sl = searching_left.astype(bool)
    sr = np.asarray(search_right, dtype=bool)
    b = np.asarray(bisecting, dtype=bool)

    # stepping out: double while accepted, stop on first rejection
    current_left[ok & sl] *= 2
    current_right[ok & sr] *= 2
    searching_left[~ok & sl] = False
    searching_right[~ok & sr] = False

    # bisecting: shrink interval towards the proposal
    neg = b & (currentt < 0)
    pos = b & ~(currentt < 0)
    current_left[neg] = currentt[neg]
    current_right[pos] = currentt[pos]
    # accepted bisection: step complete, next call starts a fresh slice
    currentt[b & ok] = np.nan
    # only bisection acceptances count as successful steps
    success[~b] = False


_pnew_empty = np.empty((0, 1))
_Lnew_empty = np.empty(0)


def evolve(transform, loglike, Lmin, currentu, currentL, currentt, currentv,
           current_left, current_right, searching_left, searching_right,
           rng=np.random):
    """Evolve every slice-sampling walker by one batched likelihood call.

    Proposes the next probe position of each walker (stepping-out end or
    bisection draw), evaluates all proposals in one vectorized call, and
    updates the state machines.

    Returns ``((currentt, currentv, current_left, current_right,
    searching_left, searching_right), (success, unew, pnew, Lnew), nc)``
    where the second tuple is compacted over successful walkers. Writes
    in place to the state arrays and currentu.
    """
    search_right, bisecting = evolve_prepare(searching_left, searching_right)

    unew = currentu
    unew[searching_left, :] = currentu[searching_left, :] \
        + currentv[searching_left, :] \
        * current_left[searching_left].reshape((-1, 1))
    unew[search_right, :] = currentu[search_right, :] \
        + currentv[search_right, :] \
        * current_right[search_right].reshape((-1, 1))
    currentt[bisecting] = rng.uniform(current_left[bisecting],
                                      current_right[bisecting])
    unew[bisecting, :] = currentu[bisecting, :] \
        + currentv[bisecting, :] * currentt[bisecting].reshape((-1, 1))

    acceptable = within_unit_cube(unew)

    nc = 0
    if acceptable.any():
        pnew = transform(unew[acceptable, :])
        Lnew = loglike(pnew)
        nc += len(pnew)
    else:
        pnew = _pnew_empty
        Lnew = _Lnew_empty

    success = np.zeros(len(searching_left), dtype=bool)
    evolve_update(acceptable, Lnew, Lmin, search_right, bisecting, currentt,
                  current_left, current_right, searching_left,
                  searching_right, success)

    return (
        (currentt, currentv, current_left, current_right, searching_left,
         searching_right),
        (success, unew[success, :], pnew[success[acceptable], :],
         Lnew[success[acceptable]]),
        nc,
    )


def step_back(Lmin, allL, generation, currentt, log=False):
    """Revert walkers whose chain contains steps below the raised threshold.

    Each walker's generation pointer is moved back to just before its
    first below-threshold step; the invalidated entries become NaN and the
    current slice is reset. In-place; vectorized (the reference reverts one
    generation per pass, `stepfuncs.pyx:285-334`).
    """
    max_width = generation.max() + 1
    with np.errstate(invalid='ignore'):
        below = allL[:, :max_width] < Lmin
    bad = below.any(axis=1)
    if not bad.any():
        return
    first_bad = np.argmax(below, axis=1)
    for i in np.where(bad)[0]:
        allL[i, first_bad[i]:generation[i] + 1] = np.nan
    if log:
        print("stepping back %d walkers" % bad.sum())
    generation[bad] = first_bad[bad] - 1
    currentt[bad] = np.nan


def update_vectorised_slice_sampler(t, tleft, tright, proposed_L, proposed_u,
                                    proposed_p, worker_running, status,
                                    Likelihood_threshold, shrink_factor,
                                    allu, allL, allp, popsize):
    """Shrink slices and harvest acceptances for the simple slice sampler.

    Workers process proposals in order; a proposal that fell outside the
    (meanwhile shrunk) interval of its point is discarded. Finished points
    free their workers for the still-running points (cyclic reassignment).

    Returns (tleft, tright, worker_running, status, allu, allL, allp,
    discarded). Cf. `stepfuncs.pyx:537-630`.

    Dispatches to the C kernel (:mod:`ultranest_torch.native`,
    stepfuncs.c) when available — the per-worker pass is inherently
    sequential (each proposal must see the interval as shrunk by the
    workers before it); the loop below is the reference/fallback.
    """
    from .. import native as _native
    if _native.available() and all(
            a.dtype == np.float64 and a.flags.c_contiguous
            for a in (t, tleft, tright, proposed_L, proposed_u,
                      proposed_p, allu, allL, allp)) and \
            worker_running.dtype == np.int64 and \
            status.dtype == np.int64:
        discarded = _native.slice_update(
            t, tleft, tright, proposed_L, proposed_u, proposed_p,
            worker_running, status, Likelihood_threshold, shrink_factor,
            allu, allL, allp)
        if discarded is not None:
            unfinished = np.where(status == 0)[0]
            if len(unfinished) > 0:
                worker_running[:] = np.resize(unfinished, popsize)
            return (tleft, tright, worker_running, status, allu, allL,
                    allp, discarded)
    discarded = 0
    for worker in range(popsize):
        point = worker_running[worker]
        tw = t[worker]
        if tw > tright[point] or tw < tleft[point]:
            # interval shrank past this proposal since it was scheduled
            if proposed_L[worker] > Likelihood_threshold:
                discarded += 1
            continue
        if 0 < tw < tright[point]:
            tright[point] = tw / shrink_factor
        if 0 > tw > tleft[point]:
            tleft[point] = tw / shrink_factor
        if proposed_L[worker] > Likelihood_threshold and status[point] == 0:
            status[point] = 1
            allu[point, :] = proposed_u[worker, :]
            allL[point] = proposed_L[worker]
            allp[point, :] = proposed_p[worker, :]

    unfinished = np.where(status == 0)[0]
    if len(unfinished) > 0:
        # all workers cycle over the still-running points
        worker_running[:] = np.resize(unfinished, popsize)
    return (tleft, tright, worker_running, status, allu, allL, allp,
            discarded)


def _one_hot_rows(nsamples, ndim, scale):
    """One-hot direction matrix with a random hot axis per row."""
    hot = np.random.randint(ndim, size=nsamples)
    v = np.zeros((nsamples, ndim))
    v[np.arange(nsamples), hot] = scale
    return v, hot


def _unit_rows(nsamples, ndim, scale):
    """Isotropic random rows normalized to length *scale*."""
    v = np.random.normal(size=(nsamples, ndim))
    return v * (scale / np.linalg.norm(v, axis=1)[:, None])


def generate_cube_oriented_direction(ui, region, scale=1):
    """Axis-aligned unit directions, one random axis per walker."""
    v, _ = _one_hot_rows(*ui.shape, scale)
    return v


def generate_cube_oriented_direction_scaled(ui, region, scale=1):
    """Axis-aligned directions scaled by the live-point spread per axis."""
    v, hot = _one_hot_rows(*ui.shape, scale)
    return v * region.u.std(axis=0)[hot][:, None]


def generate_random_direction(ui, region, scale=1):
    """Isotropic unit directions of length *scale* per walker."""
    del region
    return _unit_rows(*ui.shape, scale)


def generate_region_oriented_direction(ui, region, scale=1):
    """One random whitened-space principal axis per walker."""
    nsamples, ndim = ui.shape
    hot = np.random.randint(ndim, size=nsamples)
    return region.transformLayer.axes[hot] * scale


def generate_region_random_direction(ui, region, scale=1):
    """Random directions drawn from the region covariance per walker."""
    sphere = _unit_rows(*ui.shape, scale)
    return sphere @ region.transformLayer.axes.T


def generate_differential_direction(ui, region, scale=1):
    """Differences of random live-point pairs per walker."""
    nsamples = ui.shape[0]
    nlive = region.u.shape[0]
    a = np.random.randint(nlive, size=nsamples)
    b = np.random.randint(nlive - 1, size=nsamples)
    b += b >= a
    return (region.u[a, :] - region.u[b, :]) * scale


def generate_mixture_random_direction(ui, region, scale=1):
    """50/50 per-walker mix of differential and region-axis directions."""
    v_de = generate_differential_direction(ui, region, scale=scale)
    v_axis = generate_region_oriented_direction(ui, region, scale=scale)
    pick_de = np.random.uniform(size=ui.shape[0]) < 0.5
    return np.where(pick_de[:, None], v_de, v_axis)
