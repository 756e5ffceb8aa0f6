"""Tutorial (PyTorch port): fitting a line to data, with model comparison.

Script form of the reference's example-line / example-sine-modelcomparison
notebook workflow: generate noisy data, define two competing models
(constant vs. line), compute the evidence for each with nested sampling,
and compare via the Bayes factor.

Run::

    python examples/torch_port/tutorial_linefit.py [--device cpu]
"""
import os
import sys

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.abspath(__file__)), '..', '..'))

import numpy as np
import scipy.stats

from ultranest_torch import ReactiveNestedSampler

# --- synthetic data -------------------------------------------------------
rng = np.random.RandomState(6)
n_data = 40
x = np.sort(rng.uniform(0, 10, n_data))
slope_true, offset_true, sigma_true = 0.7, 2.0, 0.5
y = slope_true * x + offset_true + rng.normal(0, sigma_true, n_data)
yerr = np.full(n_data, sigma_true)

# --- model 1: constant ----------------------------------------------------


def transform_const(cube):
    params = cube.copy()
    params[:, 0] = cube[:, 0] * 20 - 10          # offset ~ U(-10, 10)
    params[:, 1] = 10 ** (cube[:, 1] * 3 - 2)    # sigma ~ LogU(0.01, 10)
    return params


def loglike_const(params):
    offset, sigma = params[:, 0, None], params[:, 1, None]
    return scipy.stats.norm.logpdf(y, offset, sigma).sum(axis=1)


# --- model 2: line --------------------------------------------------------


def transform_line(cube):
    params = cube.copy()
    params[:, 0] = cube[:, 0] * 4 - 2            # slope ~ U(-2, 2)
    params[:, 1] = cube[:, 1] * 20 - 10          # offset ~ U(-10, 10)
    params[:, 2] = 10 ** (cube[:, 2] * 3 - 2)    # sigma ~ LogU(0.01, 10)
    return params


def loglike_line(params):
    slope, offset, sigma = (params[:, 0, None], params[:, 1, None],
                            params[:, 2, None])
    return scipy.stats.norm.logpdf(y, slope * x + offset, sigma).sum(axis=1)


def main(device='cuda'):
    run_args = dict(min_num_live_points=400, viz_callback=False,
                    show_status=True, min_ess=0,
                    max_num_improvement_loops=0)

    s_const = ReactiveNestedSampler(
        ['offset', 'sigma'], loglike_const, transform=transform_const,
        vectorized=True, seed=1, device=device)
    r_const = s_const.run(**run_args)

    s_line = ReactiveNestedSampler(
        ['slope', 'offset', 'sigma'], loglike_line, transform=transform_line,
        vectorized=True, seed=1, device=device)
    r_line = s_line.run(**run_args)

    print()
    s_line.print_results()
    print()
    print('logZ(const) = %.2f +- %.2f' % (r_const['logz'],
                                          r_const['logzerr']))
    print('logZ(line)  = %.2f +- %.2f' % (r_line['logz'], r_line['logzerr']))
    K = r_line['logz'] - r_const['logz']
    print('ln Bayes factor (line vs const): %.1f  -> %s' % (
        K, 'line strongly preferred' if K > 5 else
        'line preferred' if K > 1 else 'inconclusive'))

    # posterior check: truth within the 90% credible interval
    post = np.asarray(r_line['weighted_samples']['points'])
    w = np.asarray(r_line['weighted_samples']['weights'])
    for name, truth in [('slope', slope_true), ('offset', offset_true),
                        ('sigma', sigma_true)]:
        i = r_line['paramnames'].index(name)
        order = np.argsort(post[:, i])
        cdf = np.cumsum(w[order])
        lo, hi = np.interp([0.05, 0.95], cdf / cdf[-1], post[order, i])
        print('%-7s truth %.3f in 90%% CI [%.3f, %.3f]: %s'
              % (name, truth, lo, hi, lo <= truth <= hi))
    return r_const, r_line


if __name__ == '__main__':
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument('--device', default='cuda')
    main(device=ap.parse_args().device)
