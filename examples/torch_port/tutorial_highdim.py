"""Tutorial: higher-dimensional fitting with step samplers, on the
PyTorch port.

Counterpart of ``examples/tutorial_highdim.py`` (the reference's
example-sine-highd notebook as a script): several objects share one
global periodic signal but each has its own amplitude and offset, so the
parameter count grows linearly with the number of objects. Region
rejection sampling degrades exponentially with dimension; step samplers
(slice sampling) scale polynomially, and the device-resident population
slice sampler keeps whole walker populations on the card.

Run::

    python examples/torch_port/tutorial_highdim.py [--fast] [--torch] \
        [--n-objects K] [--device cpu]
"""
import argparse

import os
import sys

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.abspath(__file__)), '..', '..'))

import numpy as np

from ultranest_torch import ReactiveNestedSampler
from ultranest_torch.stepsampler import (RegionSliceSampler,
                                         generate_mixture_random_direction)

# --- synthetic monitoring campaign -------------------------------------------
# every object is observed at the same epochs; the period and phase are
# shared, each object has its own amplitude and mean level


def make_data(n_objects, n_epochs=30, seed=17):
    rng = np.random.RandomState(seed)
    t = np.sort(rng.uniform(0, 20, n_epochs))
    period_true, phase_true = 7.0, 1.0
    amp_true = rng.uniform(0.5, 2.0, n_objects)
    mean_true = rng.uniform(-3, 3, n_objects)
    noise = 0.2
    y = (mean_true[:, None] + amp_true[:, None]
         * np.sin(2 * np.pi * t[None, :] / period_true + phase_true))
    y = y + rng.normal(0, noise, y.shape)
    return t, y, noise, dict(period=period_true, phase=phase_true,
                             amp=amp_true, mean=mean_true)


def build_problem(t, y, noise):
    n_objects = y.shape[0]
    names = ['period', 'phase']
    for k in range(n_objects):
        names += ['amp%d' % k, 'mean%d' % k]

    def transform(cube):
        params = cube.copy()
        params[:, 0] = 10 ** (cube[:, 0] * 2)        # period ~ LogU(1, 100)
        params[:, 1] = cube[:, 1] * 2 * np.pi        # phase  ~ U(0, 2pi)
        params[:, 2::2] = 10 ** (cube[:, 2::2] * 2 - 1)  # amps ~ LogU(.1,10)
        params[:, 3::2] = cube[:, 3::2] * 10 - 5     # means ~ U(-5, 5)
        return params

    def loglike(params):
        period, phase = params[:, 0, None, None], params[:, 1, None, None]
        amp = params[:, 2::2, None]
        mean = params[:, 3::2, None]
        pred = mean + amp * np.sin(
            2 * np.pi * t[None, None, :] / period + phase)
        return -0.5 * (((pred - y[None, :, :]) / noise) ** 2).sum(
            axis=(1, 2))

    return names, loglike, transform


def build_torch_problem(t, y, noise):
    """(torch_loglike, torch_transform): the problem's torch twins, on
    whatever device their input lies."""
    import torch
    n_objects = y.shape[0]
    consts = {}

    def data(like):
        key = (like.device, like.dtype)
        if key not in consts:
            consts[key] = (torch.as_tensor(t, dtype=like.dtype,
                                           device=like.device),
                           torch.as_tensor(y, dtype=like.dtype,
                                           device=like.device))
        return consts[key]

    def torch_loglike(params):
        tt, yy = data(params)
        period, phase = params[:, 0, None, None], params[:, 1, None, None]
        amp, mean = params[:, 2::2, None], params[:, 3::2, None]
        pred = mean + amp * torch.sin(
            2 * np.pi * tt[None, None, :] / period + phase)
        return -0.5 * (((pred - yy[None, :, :]) / noise)
                       ** 2).sum(dim=(1, 2))

    def torch_transform(cube):
        cols = [10 ** (cube[:, 0] * 2), cube[:, 1] * 2 * np.pi]
        for k in range(n_objects):
            cols.append(10 ** (cube[:, 2 + 2 * k] * 2 - 1))
            cols.append(cube[:, 3 + 2 * k] * 10 - 5)
        return torch.stack(cols, dim=1)

    return torch_loglike, torch_transform


def main(fast=False, use_torch=False, n_objects=4, device='cuda'):
    t, y, noise, truth = make_data(n_objects)
    names, loglike, transform = build_problem(t, y, noise)
    ndim = len(names)
    print('fitting %d objects -> %d parameters' % (n_objects, ndim))

    sampler = ReactiveNestedSampler(names, loglike, transform=transform,
                                    vectorized=True, seed=4,
                                    wrapped_params=[n == 'phase'
                                                    for n in names],
                                    device=device)
    nsteps = 2 * ndim
    if use_torch:
        # device-resident population slice sampler: entire walker
        # populations advance through all slice steps per dispatch
        from ultranest_torch.popfused import FusedPopulationSliceSampler
        torch_loglike, torch_transform = build_torch_problem(t, y, noise)
        sampler.stepsampler = FusedPopulationSliceSampler(
            popsize=256, nsteps=nsteps, torch_loglike=torch_loglike,
            torch_transform=torch_transform, seed=4, engine='spec',
            device=device)
    else:
        # host path: slice sampler with a mixed differential/region
        # direction proposal — the reference's high-d recommendation
        sampler.stepsampler = RegionSliceSampler(
            nsteps=nsteps,
            generate_direction=generate_mixture_random_direction)

    result = sampler.run(viz_callback=False, show_status=not fast,
                         min_ess=0, max_num_improvement_loops=0,
                         frac_remain=0.5,
                         min_num_live_points=100 if fast else 400,
                         dlogz=2.0 if fast else 0.5)
    sampler.print_results()

    post = result['posterior']
    i_period = result['paramnames'].index('period')
    print()
    print('period: %.2f +- %.2f (true %.2f)'
          % (post['mean'][i_period], post['stdev'][i_period],
             truth['period']))
    print('efficiency: %.2f%% (%d evals for %d iterations)'
          % (100.0 * result['niter'] / result['ncall'], result['ncall'],
             result['niter']))
    print()
    print('scaling notes: region rejection sampling needs exponentially')
    print('more evaluations as d grows; slice sampling needs ~d * nsteps')
    print('per point. For d >~ 20 also switch region_class to')
    print('RobustEllipsoidRegion (cheaper region bookkeeping).')
    return result


if __name__ == '__main__':
    ap = argparse.ArgumentParser()
    ap.add_argument('--fast', action='store_true',
                    help='smaller run for smoke-testing')
    ap.add_argument('--torch', action='store_true',
                    help='use the device-resident population sampler')
    ap.add_argument('--n-objects', type=int, default=4)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args()
    main(fast=args.fast, use_torch=args.torch, n_objects=args.n_objects,
         device=args.device)
