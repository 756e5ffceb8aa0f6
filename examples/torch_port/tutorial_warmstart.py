"""Tutorial (PyTorch port): warm starting a fit after the model or data changed.

Concept coverage of the reference's example-warmstart notebook
(reference docs/example-warmstart.ipynb), rebuilt as a script.
Scenario: the first few bins of a spectrum are fit with a
black-body-like model; then the rest of the observing campaign arrives
and the fit must be redone. Instead of paying the full nested-sampling
cost again, ``warmstart_from_similar_file`` deforms the prior around
the previous posterior so the new run starts nearly converged — exact
(the deformation is corrected by a derived weight), and effective
whenever the new posterior lies inside the old one (more data,
tightened constraints).

Run::

    python examples/torch_port/tutorial_warmstart.py [--fast] \
        [--storage-backend csv] [--device cpu]

``--storage-backend`` is the cold run's point store ('hdf5' as in the
original; 'csv' where h5py is not installed).
"""
import argparse

import os
import sys

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.abspath(__file__)), '..', '..'))

import shutil
import time

import numpy as np

from ultranest_torch import ReactiveNestedSampler, warmstart_from_similar_file

# --- a black-body-ish model ---------------------------------------------------
rng = np.random.RandomState(31)
wavelength = np.linspace(1.0, 10.0, 50)          # arbitrary units
temp_true, norm_true = 3.0, 5.0


def model_flux(temp, norm, lam):
    """Planck-like curve: norm * lam^-3 / (exp(1/(lam T)) - 1)."""
    return norm * lam ** -3.0 / np.expm1(1.0 / (lam * temp))


flux_err = 0.02
flux = model_flux(temp_true, norm_true, wavelength) \
    + rng.normal(0, flux_err, wavelength.size)

PARAM_NAMES = ['temperature', 'normalisation']


def transform(cube):
    params = cube.copy()
    params[:, 0] = 10 ** (cube[:, 0] * 2 - 1)    # T ~ LogU(0.1, 10)
    params[:, 1] = 10 ** (cube[:, 1] * 4 - 2)    # N ~ LogU(0.01, 100)
    return params


def make_loglike(n_points):
    """Likelihood over the first *n_points* spectral bins."""
    lam, observed = wavelength[:n_points], flux[:n_points]

    def loglike(params):
        pred = model_flux(params[:, 0, None], params[:, 1, None],
                          lam[None, :])
        return -0.5 * (((pred - observed[None, :]) / flux_err) ** 2
                       ).sum(axis=1)
    return loglike


def main(fast=False, storage_backend='hdf5', device='cuda'):
    log_dir = 'logs/tutorial_warmstart'
    shutil.rmtree(log_dir, ignore_errors=True)
    run_args = dict(viz_callback=False, show_status=False, min_ess=0,
                    max_num_improvement_loops=0, frac_remain=0.5,
                    min_num_live_points=100 if fast else 400,
                    dlogz=2.0 if fast else 0.5)

    # ---- cold run on the early data (first 10 spectral bins) ---------------
    t0 = time.time()
    sampler = ReactiveNestedSampler(
        PARAM_NAMES, make_loglike(10), transform=transform,
        vectorized=True, seed=1, log_dir=log_dir, resume='overwrite',
        storage_backend=storage_backend, device=device)
    res_cold = sampler.run(**run_args)
    t_cold = time.time() - t0
    print('cold run:  logZ=%.2f +- %.2f  (%d evals, %.1fs)'
          % (res_cold['logz'], res_cold['logzerr'], res_cold['ncall'],
             t_cold))

    # ---- the rest of the observing campaign arrives -------------------------
    # the full-data posterior nests inside the early-data posterior, the
    # regime where warm starting pays off

    # warm start: deform the prior around the stored posterior of the
    # previous run (chains/weighted_post_untransformed.txt)
    usample_file = os.path.join(log_dir, 'chains',
                                'weighted_post_untransformed.txt')
    aux_names, aux_loglike, aux_transform, vectorized = \
        warmstart_from_similar_file(usample_file, PARAM_NAMES,
                                    loglike=make_loglike(len(wavelength)),
                                    transform=transform, vectorized=True)

    t0 = time.time()
    warm_sampler = ReactiveNestedSampler(
        aux_names, aux_loglike, transform=aux_transform,
        vectorized=vectorized, seed=2, device=device)
    res_warm = warm_sampler.run(**run_args)
    t_warm = time.time() - t0
    print('warm run:  logZ=%.2f +- %.2f  (%d evals, %.1fs)'
          % (res_warm['logz'], res_warm['logzerr'], res_warm['ncall'],
             t_warm))

    # ---- and the honest comparison: a cold rerun on the new data ----------
    t0 = time.time()
    sampler2 = ReactiveNestedSampler(
        PARAM_NAMES, make_loglike(len(wavelength)), transform=transform,
        vectorized=True, seed=2, device=device)
    res_cold2 = sampler2.run(**run_args)
    t_cold2 = time.time() - t0
    print('cold rerun: logZ=%.2f +- %.2f  (%d evals, %.1fs)'
          % (res_cold2['logz'], res_cold2['logzerr'], res_cold2['ncall'],
             t_cold2))

    print()
    print('evals saved by warm start: %.1fx (%d -> %d)'
          % (res_cold2['ncall'] / max(res_warm['ncall'], 1),
             res_cold2['ncall'], res_warm['ncall']))
    dz = abs(res_warm['logz'] - res_cold2['logz'])
    tol = 3 * (res_warm['logzerr'] + res_cold2['logzerr'])
    print('logZ agreement warm vs cold: |dz|=%.2f (tolerance %.2f) -> %s'
          % (dz, tol, 'OK' if dz < tol else 'MISMATCH'))
    print()
    print('notes: the auxiliary run samples an extended space (one extra')
    print('column, the deformation weight); posteriors of the original')
    print('parameters are unchanged. Warm starting only helps when the')
    print('new posterior lies within the old one; if the model changed')
    print("so much that they no longer overlap, fall back to a cold run")
    print("or resume='resume-similar'.")
    return res_cold, res_warm, res_cold2


if __name__ == '__main__':
    ap = argparse.ArgumentParser()
    ap.add_argument('--fast', action='store_true',
                    help='smaller run for smoke-testing')
    ap.add_argument('--storage-backend', default='hdf5',
                    choices=['hdf5', 'csv', 'tsv'])
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args()
    main(fast=args.fast, storage_backend=args.storage_backend,
         device=args.device)
