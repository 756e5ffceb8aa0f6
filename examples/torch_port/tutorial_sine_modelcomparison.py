"""Tutorial (PyTorch port): Bayesian model comparison on periodic signals.

Counterpart of ``examples/tutorial_sine_modelcomparison.py`` (the
reference's example-sine-modelcomparison notebook as a script): generate
noisy data from a sinusoid, fit a no-signal model and a one-sine model,
compare their evidences via the Bayes factor K, then *calibrate* the K
decision threshold by re-running the analysis on simulated no-signal
datasets — the false-alarm distribution of K tells you how big K must be
before you believe the detection.

The null model runs through the pymultinest-compatible ``solve``
interface (``ultranest_torch.solvecompat``), the signal model through the
vectorized :class:`ReactiveNestedSampler` — the two entry points a user
migrating from MultiNest will touch first.

Run::

    python examples/torch_port/tutorial_sine_modelcomparison.py [--quick] \
        [--outdir DIR] [--device cpu]

``--quick`` (also set by ULTRANEST_TUTORIAL_QUICK=1) shrinks the live
point counts and the calibration ensemble so the script finishes in CI
time; the workflow is identical.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.abspath(__file__)), '..', '..'))

import numpy as np

from ultranest_torch import ReactiveNestedSampler
from ultranest_torch.solvecompat import pymultinest_solve_compat as solve

# --- model ------------------------------------------------------------
# y(t) = B + A * sin((t / P + tphase) * 2 pi), gaussian noise yerr


def sine_model(t, B, A, P, tphase):
    return B + A * np.sin((t / P + tphase) * 2 * np.pi)


# --- generating data --------------------------------------------------
rng = np.random.RandomState(42)
n_data = 20
t = rng.uniform(0, 5, size=n_data)
yerr = 1.0
y_true = sine_model(t, B=1.0, A=0.9, P=3.0, tphase=0.0)
y = y_true + rng.normal(0, yerr, size=n_data)

# --- model 1: one sine (vectorized ReactiveNestedSampler) --------------
parameters1 = ['B', 'A1', 'P1', 't1']


def prior_transform1(cube):
    params = cube.copy()
    params[:, 0] = cube[:, 0] * 20 - 10        # B ~ U(-10, 10)
    params[:, 1] = 10 ** (cube[:, 1] * 3 - 2)  # A ~ LogU(0.01, 10)
    params[:, 2] = 10 ** (cube[:, 2] * 2)      # P ~ LogU(1, 100)
    params[:, 3] = cube[:, 3]                  # tphase ~ U(0, 1)
    return params


def make_loglike1(ydata):
    def log_likelihood1(params):
        ymodel = sine_model(t[None, :], params[:, 0, None],
                            params[:, 1, None], params[:, 2, None],
                            params[:, 3, None])
        return (-0.5 * ((ymodel - ydata) / yerr) ** 2
                - np.log(np.sqrt(2 * np.pi) * yerr)).sum(axis=1)
    return log_likelihood1


def run_sine_model(ydata, nlive, seed=1, device='cuda'):
    sampler = ReactiveNestedSampler(
        parameters1, make_loglike1(ydata), transform=prior_transform1,
        vectorized=True, seed=seed,
        wrapped_params=[False, False, False, True], device=device)
    return sampler.run(min_num_live_points=nlive, viz_callback=False,
                       show_status=False)


# --- model 0: no signal, through the pymultinest-style interface -------


def prior_transform0(cube):
    params = cube.copy()
    params[0] = cube[0] * 20 - 10
    return params


def make_loglike0(ydata):
    def log_likelihood0(params):
        return float(
            (-0.5 * ((params[0] - ydata) / yerr) ** 2
             - np.log(np.sqrt(2 * np.pi) * yerr)).sum())
    return log_likelihood0


def run_null_model(ydata, nlive, seed=1, device='cuda'):
    return solve(make_loglike0(ydata), prior_transform0, 1,
                 paramnames=['B'], n_live_points=nlive, seed=seed,
                 verbose=False, device=device)


def main(quick=False, outdir=None, device='cuda'):
    """Run the comparison and its calibration; returns {'result1',
    'result0', 'K_simulated'}."""
    nlive = 100 if quick else 400
    nsim = 4 if quick else 20
    print('fitting 1-sine model ...')
    result1 = run_sine_model(y, nlive, device=device)
    print('  logZ(sine)  = %.2f +- %.2f' % (result1['logz'],
                                            result1['logzerr']))
    print('fitting no-signal model (via solvecompat.solve) ...')
    result0 = run_null_model(y, nlive, device=device)
    # pymultinest convention: logZ / logZerr keys
    print('  logZ(null)  = %.2f +- %.2f' % (result0['logZ'],
                                            result0['logZerr']))

    # --- Bayesian model comparison -------------------------------------
    logK = result1['logz'] - result0['logZ']
    K = np.exp(logK)
    print('Bayes factor: K = exp(%.2f) = %.1f' % (logK, K))
    if K > 100:
        print('  -> strong preference for the sine model')
    elif K > 10:
        print('  -> moderate preference for the sine model')
    else:
        print('  -> data do not strongly prefer the sine model')

    # --- calibrating the Bayes factor threshold ------------------------
    # How often does noise alone produce a K this large? Simulate
    # datasets from the *null* model and redo the comparison. The upper
    # quantile of this false-alarm distribution is the detection
    # threshold.
    print('calibrating K on %d simulated no-signal datasets ...' % nsim)
    K_simulated = []
    for i in range(nsim):
        rng_i = np.random.RandomState(100 + i)
        y_sim = 1.0 + rng_i.normal(0, yerr, size=n_data)
        r1 = run_sine_model(y_sim, nlive, seed=100 + i, device=device)
        r0 = run_null_model(y_sim, nlive, seed=100 + i, device=device)
        K_simulated.append(r1['logz'] - r0['logZ'])
        print('  sim %2d: logK = %+.2f' % (i, K_simulated[-1]))

    K_simulated = np.asarray(K_simulated)
    thresh = np.quantile(np.exp(K_simulated), 0.95)
    print('simulated false-alarm K: max %.2f, 95%% quantile %.2f'
          % (np.exp(K_simulated).max(), thresh))
    print('observed K = %.1f -> %s' % (
        K, 'above the simulated false-alarm range: detection is safe'
        if K > np.exp(K_simulated).max() else
        'within the noise-only range: not a confident detection'))

    if outdir:
        os.makedirs(outdir, exist_ok=True)
        try:
            import matplotlib
            matplotlib.use('Agg')
            import matplotlib.pyplot as plt
            plt.figure()
            plt.hist(np.exp(K_simulated), histtype='step', bins=10,
                     label='K from simulated noise-only data')
            plt.axvline(K, color='r', label='observed K')
            plt.xlabel('Bayes factor K')
            plt.legend()
            plt.savefig(os.path.join(outdir,
                                     'bayes_factor_calibration.png'))
            plt.close()
            print('wrote', os.path.join(outdir,
                                        'bayes_factor_calibration.png'))
        except ImportError:
            pass
    return dict(result1=result1, result0=result0, K_simulated=K_simulated)


if __name__ == '__main__':
    parser = argparse.ArgumentParser()
    parser.add_argument('--quick', action='store_true',
                        default=bool(os.environ.get(
                            'ULTRANEST_TUTORIAL_QUICK')))
    parser.add_argument('--outdir', default=None)
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args()
    main(quick=args.quick, outdir=args.outdir, device=args.device)
