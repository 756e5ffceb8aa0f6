"""Tutorial (PyTorch port): fitting a distribution in the presence of outliers.

Concept coverage of the reference's example-outliers notebook
(reference docs/example-outliers.ipynb), rebuilt as a script:
measurements of a quantity are contaminated by a few wild points, and we
ask which noise model the evidence prefers —

1. a plain gaussian,
2. a gaussian plus a wide uniform "outlier" mixture component,
3. a heavy-tailed student-t distribution.

Nested sampling gives logZ for each, so the comparison is a direct
Bayes-factor readout. Run::

    python examples/torch_port/tutorial_outliers.py [--fast] [--device cpu]
"""
import argparse

import os
import sys

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.abspath(__file__)), '..', '..'))

import numpy as np
import scipy.stats

from ultranest_torch import ReactiveNestedSampler

# --- synthetic contaminated data -------------------------------------------
rng = np.random.RandomState(11)
n_clean, n_outl = 30, 4
mu_true, sigma_true = 4.0, 0.3
values = np.concatenate([
    rng.normal(mu_true, sigma_true, n_clean),
    rng.uniform(-10, 20, n_outl),          # contamination
])


# Every model shares the location/scale priors; the unit-cube mapping is
# factored out so each transform stays a one-liner.
def _loc_scale(cube01):
    loc = cube01[:, 0] * 20 - 10             # mu    ~ U(-10, 10)
    scale = 10 ** (cube01[:, 1] * 3 - 2)     # sigma ~ LogU(0.01, 10)
    return loc, scale


# --- model 1: plain gaussian ------------------------------------------------

def transform_gauss(cube):
    loc, scale = _loc_scale(cube)
    return np.stack([loc, scale], axis=1)


def loglike_gauss(params):
    mu, sigma = params[:, 0, None], params[:, 1, None]
    return scipy.stats.norm.logpdf(values, mu, sigma).sum(axis=1)


# --- model 2: gaussian + uniform outlier component --------------------------
# each datum comes from the gaussian with probability (1-f) and from a
# wide uniform box with probability f; mixtures are summed in
# probability space per datum, then log-summed over data

OUTLIER_BOX = (-10.0, 20.0)


def transform_mix(cube):
    loc, scale = _loc_scale(cube)
    f_out = cube[:, 2] * 0.5                 # outlier fraction ~ U(0, 0.5)
    return np.stack([loc, scale, f_out], axis=1)


def loglike_mix(params):
    mu, sigma, f = (params[:, 0, None], params[:, 1, None],
                    params[:, 2, None])
    p_gauss = scipy.stats.norm.pdf(values, mu, sigma)
    p_box = 1.0 / (OUTLIER_BOX[1] - OUTLIER_BOX[0])
    per_datum = (1 - f) * p_gauss + f * p_box
    return np.log(per_datum + 1e-300).sum(axis=1)


# --- model 3: heavy-tailed (student-t) ---------------------------------------

def transform_t(cube):
    loc, scale = _loc_scale(cube)
    dof = 10 ** (cube[:, 2] * 2)             # nu ~ LogU(1, 100)
    return np.stack([loc, scale, dof], axis=1)


def loglike_t(params):
    mu, sigma, dof = (params[:, 0, None], params[:, 1, None],
                      params[:, 2, None])
    return scipy.stats.t.logpdf(values, dof, mu, sigma).sum(axis=1)


MODELS = [
    ('gaussian', ['mu', 'sigma'], loglike_gauss, transform_gauss),
    ('gauss+outliers', ['mu', 'sigma', 'f_out'], loglike_mix, transform_mix),
    ('student-t', ['mu', 'sigma', 'dof'], loglike_t, transform_t),
]


def main(fast=False, device='cuda'):
    run_args = dict(viz_callback=False, show_status=not fast, min_ess=0,
                    max_num_improvement_loops=0,
                    min_num_live_points=100 if fast else 400,
                    dlogz=2.0 if fast else 0.5)
    results = {}
    for name, names, loglike, transform in MODELS:
        sampler = ReactiveNestedSampler(names, loglike, transform=transform,
                                        vectorized=True, seed=2,
                                        device=device)
        results[name] = sampler.run(**run_args)

    print()
    print('%-16s %10s %8s' % ('model', 'logZ', '+-'))
    best = max(results, key=lambda k: results[k]['logz'])
    for name, res in results.items():
        print('%-16s %10.2f %8.2f %s'
              % (name, res['logz'], res['logzerr'],
                 '<- preferred' if name == best else ''))
    K = results[best]['logz'] - results['gaussian']['logz']
    print('\nln Bayes factor (%s vs gaussian): %.1f' % (best, K))
    print('with %d/%d contaminated points, a robust noise model should win'
          % (n_outl, len(values)))

    mix = results['gauss+outliers']
    i = mix['paramnames'].index('f_out')
    print('posterior outlier fraction: %.2f (true %.2f)'
          % (mix['posterior']['mean'][i], n_outl / len(values)))
    return results


if __name__ == '__main__':
    ap = argparse.ArgumentParser()
    ap.add_argument('--fast', action='store_true',
                    help='smaller run for smoke-testing')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args()
    main(fast=args.fast, device=args.device)
