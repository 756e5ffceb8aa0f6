"""Tutorial (PyTorch port): inferring an intrinsic distribution from noisy measurements.

Concept coverage of the reference's example-intrinsic-distribution
notebook (reference docs/example-intrinsic-distribution.ipynb),
rebuilt as a script: each object in a sample is measured with its own
(known, heteroscedastic) uncertainty, and the question is the
*population*: what are the intrinsic mean and spread of the underlying
quantity, after deconvolving the measurement noise?

Because the per-object gaussian noise convolved with a gaussian
intrinsic distribution is again gaussian, the per-object likelihood
marginalises analytically — the model has just two parameters however
many objects there are. Run::

    python examples/torch_port/tutorial_intrinsic_distribution.py [--fast] [--device cpu]
"""
import argparse

import os
import sys

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.abspath(__file__)), '..', '..'))

import numpy as np

from ultranest_torch import ReactiveNestedSampler

# --- synthetic survey --------------------------------------------------------
# n objects, each with its own measurement error drawn from a wide range
rng = np.random.RandomState(23)
n_obj = 60
mean_true, spread_true = 2.5, 0.6
intrinsic = rng.normal(mean_true, spread_true, n_obj)
meas_err = 10 ** rng.uniform(-1.0, 0.3, n_obj)        # 0.1 .. 2.0
observed = rng.normal(intrinsic, meas_err)


def transform(cube):
    params = cube.copy()
    params[:, 0] = cube[:, 0] * 10 - 5              # mean   ~ U(-5, 5)
    params[:, 1] = 10 ** (cube[:, 1] * 3 - 2)       # spread ~ LogU(0.01, 10)
    return params


def loglike(params):
    mean, spread = params[:, 0, None], params[:, 1, None]
    # gaussian measurement noise (+) gaussian intrinsic scatter:
    # marginal per-object variance is the sum of both variances
    var = spread ** 2 + meas_err[None, :] ** 2
    return (-0.5 * (np.log(2 * np.pi * var)
                    + (observed[None, :] - mean) ** 2 / var)).sum(axis=1)


def main(fast=False, device='cuda'):
    sampler = ReactiveNestedSampler(['mean', 'spread'], loglike,
                                    transform=transform, vectorized=True,
                                    seed=5, device=device)
    result = sampler.run(viz_callback=False, show_status=not fast,
                         min_ess=0, max_num_improvement_loops=0,
                         min_num_live_points=100 if fast else 400,
                         dlogz=2.0 if fast else 0.5)
    sampler.print_results()

    print()
    naive_std = observed.std()
    post_mean = result['posterior']['mean']
    post_err = result['posterior']['stdev']
    print('naive sample std (noise-broadened): %.2f' % naive_std)
    print('posterior intrinsic mean:   %.2f +- %.2f (true %.2f)'
          % (post_mean[0], post_err[0], mean_true))
    print('posterior intrinsic spread: %.2f +- %.2f (true %.2f)'
          % (post_mean[1], post_err[1], spread_true))
    print('the deconvolved spread should fall well below the naive std')
    return result


if __name__ == '__main__':
    ap = argparse.ArgumentParser()
    ap.add_argument('--fast', action='store_true',
                    help='smaller run for smoke-testing')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args()
    main(fast=args.fast, device=args.device)
