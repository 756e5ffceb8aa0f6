# noqa: D400 D205
"""Drop-in replacement for pymultinest.solve.

Example::

    from ultranest_torch.solvecompat import pymultinest_solve_compat as solve

    # is a drop-in replacement for

    from pymultinest.solve import solve

A copy of ``ultranest_tpu/solvecompat.py`` over the port's sampler and
host ``SliceSampler``; ``device=`` names where the regions are built.
"""

import string

import numpy as np

from .integrator import ReactiveNestedSampler
from .stepsampler import SliceSampler, generate_mixture_random_direction

__all__ = ['pymultinest_solve_compat']


def _make_step_sampler(nsteps, adaptive, filtered):
    return SliceSampler(
        nsteps=nsteps,
        generate_direction=generate_mixture_random_direction,
        adaptive_nsteps=adaptive, region_filter=filtered)


def pymultinest_solve_compat(
        LogLikelihood, Prior, n_dims, paramnames=None,
        outputfiles_basename=None, resume=False,
        n_live_points=400, evidence_tolerance=0.5,
        seed=-1, max_iter=0, wrapped_params=None, verbose=True,
        speed="safe", device='cuda', **kwargs):
    """Run a nested sampling analysis with a pymultinest-style interface.

    For full control (resume, plotting, sampler options) use
    :class:`ultranest_torch.ReactiveNestedSampler` directly.

    Parameters
    ----------
    LogLikelihood, Prior: functions
        single-point model functions (pymultinest convention)
    n_dims: int
        dimensionality
    paramnames: list of str or None
        parameter names (defaults to a, b, c, ...)
    outputfiles_basename: str or None
        output directory
    resume: bool
        resume from existing output
    n_live_points: int
        number of live points
    evidence_tolerance: float
        dlogz target
    seed: int
        random seed (>=0 to set)
    max_iter: int
        iteration limit (0: unlimited)
    wrapped_params: list of bools or None
        circular parameter flags
    verbose: bool
        show progress
    speed: 'safe', 'auto' or int
        'safe': region sampling only; 'auto': short run then calibrated
        slice sampling; int: slice sampling with that many steps
    device: str or torch.device
        the sampler's device ('cuda' by default; 'cpu' on request)

    Returns
    -------
    dict with logZ, logZerr, samples, weighted_samples
    """
    if seed >= 0:
        np.random.seed(seed)
    names = paramnames if paramnames is not None \
        else list(string.ascii_lowercase[:n_dims])
    assert len(names) == n_dims, (names, n_dims)

    run_options = dict(
        dlogz=evidence_tolerance,
        max_iters=max_iter if max_iter > 0 else None,
        min_num_live_points=n_live_points,
        min_ess=kwargs.pop('min_ess', 0),
        frac_remain=kwargs.pop('frac_remain', 0.01),
        Lepsilon=kwargs.pop('Lepsilon', 0.001),
    )
    if not verbose:
        run_options.update(viz_callback=False, show_status=False)

    sampler = ReactiveNestedSampler(
        names, LogLikelihood, transform=Prior,
        log_dir=outputfiles_basename,
        resume='resume' if resume else 'overwrite',
        wrapped_params=wrapped_params, draw_multiple=False,
        vectorized=False, device=device)

    if speed == "auto":
        # warm-up run with region sampling, then calibrated slice steps
        sampler.run(max_ncalls=40000, **run_options)
        sampler.stepsampler = _make_step_sampler(
            1000, 'move-distance', kwargs.get('region_filter', True))
    elif speed != "safe":
        sampler.stepsampler = _make_step_sampler(int(speed), False, False)

    sampler.run(**run_options)

    if verbose:
        sampler.print_results()
    if outputfiles_basename is not None:
        sampler.plot()

    out = sampler.results
    return dict(logZ=out['logz'], logZerr=out['logzerr'],
                samples=out['samples'],
                weighted_samples=out['weighted_samples'])
