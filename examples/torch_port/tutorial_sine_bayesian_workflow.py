"""Tutorial (PyTorch port): a full Bayesian workflow on a periodic-signal
model.

Counterpart of ``examples/tutorial_sine_bayesian_workflow.py`` (the
reference's example-sine-bayesian-workflow notebook as a script), the
recommended sequence for any new analysis:

1. *Prior predictive checks* — draw model curves from the prior and look
   at them: do the priors generate plausible data?
2. *Inference* — nested sampling posterior + evidence.
3. *Posterior predictive checks* — overlay the data with the posterior
   band of model curves (:class:`ultranest_torch.plot.PredictionBand`).
4. *Sampler calibration* — verify the step sampler chain length by
   doubling nsteps until logZ stabilizes
   (:class:`ultranest_torch.calibrator.ReactiveNestedCalibrator`).

Run::

    python examples/torch_port/tutorial_sine_bayesian_workflow.py \
        [--quick] [--outdir DIR] [--device cpu]

``--quick`` (also ULTRANEST_TUTORIAL_QUICK=1) shrinks live-point counts
for CI; plots land in --outdir (default: skip plotting, and matplotlib
is not imported).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.abspath(__file__)), '..', '..'))

import numpy as np

from ultranest_torch import ReactiveNestedSampler

# --- model ------------------------------------------------------------


def sine_model(t, B, A, P, tphase):
    return B + A * np.sin((t / P + tphase) * 2 * np.pi)


# --- generating data --------------------------------------------------
rng = np.random.RandomState(42)
n_data = 20
t = rng.uniform(0, 5, size=n_data)
yerr = 1.0
y = sine_model(t, B=1.0, A=0.9, P=3.0, tphase=0.0) \
    + rng.normal(0, yerr, size=n_data)

parameters = ['B', 'A1', 'P1', 't1']


def prior_transform(cube):
    params = cube.copy()
    params[:, 0] = cube[:, 0] * 20 - 10        # B ~ U(-10, 10)
    params[:, 1] = 10 ** (cube[:, 1] * 3 - 2)  # A ~ LogU(0.01, 10)
    params[:, 2] = 10 ** (cube[:, 2] * 2)      # P ~ LogU(1, 100)
    params[:, 3] = cube[:, 3]                  # tphase ~ U(0, 1)
    return params


def log_likelihood(params):
    ymodel = sine_model(t[None, :], params[:, 0, None], params[:, 1, None],
                        params[:, 2, None], params[:, 3, None])
    return (-0.5 * ((ymodel - y) / yerr) ** 2
            - np.log(np.sqrt(2 * np.pi) * yerr)).sum(axis=1)


# the prior draws continue the data's stream, as in the original
t_grid = np.linspace(0, 5, 100)
prior_draws = prior_transform(rng.uniform(size=(8, len(parameters))))


def main(quick=False, outdir=None, device='cuda'):
    """Run the four steps; returns {'result', 'calib'}."""
    nlive = 100 if quick else 400
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
    else:
        plt = None

    # --- 1. prior predictive checks ------------------------------------
    # Draw parameter sets from the prior and look at the curves they
    # imply. Pathological priors (curves pinned to zero, or wildly off
    # the data scale) show up here before any fitting happens.
    prior_curves = [sine_model(t_grid, *row) for row in prior_draws]
    spread = np.ptp([c.mean() for c in prior_curves])
    print('prior predictive: 8 draws, mean-level spread %.1f '
          '(data span %.1f..%.1f)' % (spread, y.min(), y.max()))
    if plt:
        plt.figure()
        for c in prior_curves:
            plt.plot(t_grid, c, alpha=0.5)
        plt.errorbar(t, y, yerr=yerr, fmt='ok')
        plt.title('prior predictive check')
        plt.savefig(os.path.join(outdir, 'prior_predictive.png'))
        plt.close()

    # --- 2. inference ---------------------------------------------------
    sampler = ReactiveNestedSampler(
        parameters, log_likelihood, transform=prior_transform,
        vectorized=True, seed=2, wrapped_params=[False, False, False, True],
        device=device)
    result = sampler.run(min_num_live_points=nlive, viz_callback=False,
                         show_status=False)
    sampler.print_results()

    # --- 3. posterior predictive checks ----------------------------------
    from ultranest_torch.plot import PredictionBand

    band = PredictionBand(t_grid)
    for params in result['samples'][:200]:
        band.add(sine_model(t_grid, *params))
    lo = band.get_line(0.025)
    hi = band.get_line(0.975)
    inside = float(np.mean((np.interp(t, t_grid, lo) - 2 * yerr < y)
                           & (y < np.interp(t, t_grid, hi) + 2 * yerr)))
    print('posterior predictive: %.0f%% of data inside the 95%% band '
          '(+- 2 sigma)' % (100 * inside))
    if inside <= 0.5:
        raise RuntimeError('posterior band misses most of the data')
    if plt:
        plt.figure()
        band.line(color='k')
        band.shade(color='k', alpha=0.3)
        band.shade(q=0.49, color='gray', alpha=0.2)
        plt.errorbar(t, y, yerr=yerr, fmt='ok')
        plt.title('posterior predictive check')
        plt.savefig(os.path.join(outdir, 'posterior_predictive.png'))
        plt.close()

        from ultranest_torch.plot import cornerplot
        cornerplot(result)
        plt.savefig(os.path.join(outdir, 'corner.png'))
        plt.close('all')

    # --- 4. sampler calibration ------------------------------------------
    # With step samplers, the one free knob that can silently bias logZ
    # is the chain length. The calibrator doubles nsteps until three
    # consecutive runs agree; use it (or adaptive_nsteps=True) before
    # believing a step-sampler evidence.
    from ultranest_torch.calibrator import ReactiveNestedCalibrator
    from ultranest_torch.stepsampler import (
        SliceSampler, generate_mixture_random_direction)

    print('calibrating step-sampler chain length ...')
    calib = ReactiveNestedCalibrator(
        parameters, log_likelihood, transform=prior_transform,
        vectorized=True, seed=3, wrapped_params=[False, False, False, True],
        device=device)
    calib.stepsampler = SliceSampler(
        nsteps=4, generate_direction=generate_mixture_random_direction)
    calib.run(min_num_live_points=nlive // 2, viz_callback=False,
              show_status=False, max_num_improvement_loops=0)
    for nsteps, res in zip(calib.nsteps, calib.results):
        print('  nsteps=%3d: logZ = %.2f +- %.2f'
              % (nsteps, res['logz'], res['logzerr']))
    print('calibrated nsteps:', calib.nsteps[-1])
    return dict(result=result, calib=calib)


if __name__ == '__main__':
    parser = argparse.ArgumentParser()
    parser.add_argument('--quick', action='store_true',
                        default=bool(os.environ.get(
                            'ULTRANEST_TUTORIAL_QUICK')))
    parser.add_argument('--outdir', default=None)
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args()
    main(quick=args.quick, outdir=args.outdir, device=args.device)
