"""Measure the MWW insertion-rank signal on the gauss100_hard anchor, on
the PyTorch port.

Counterpart of ``evaluate/mww_signal_study.py``. Question: when chains
are too short (nsteps=200 on the 100-d sigma=0.01 gaussian), how strong
is the insertion-rank non-uniformity — per 2048-rank window and
cumulatively? Run the same problem at nsteps=400 for the null
distribution.

Usage::

    python -m ultranest_torch.evaluate.mww_signal_study [--device cpu] \
        [nsteps ...]

Prints one JSON line per nsteps value.
"""
import json
import sys
import time

import numpy as np


def run(nsteps, seed=3, ndim=100, popsize=2048, device='cuda'):
    """One spec-walk run of ``gauss(ndim, 0.01)`` at *nsteps* with the
    insertion ranks recorded; returns the study's row (and prints it)."""
    from ultranest_torch import ReactiveNestedSampler, models
    from ultranest_torch.mlfriends import ScalingLayer, SimpleRegion
    from ultranest_torch.popfused import FusedPopulationSliceSampler

    prob = models.gauss(ndim=ndim, sigma=0.01)
    sampler = ReactiveNestedSampler(seed=seed, device=device,
                                    **prob.sampler_kwargs(use_torch=False))
    sampler.transform_layer_class = ScalingLayer
    ss = FusedPopulationSliceSampler(
        popsize=popsize, nsteps=nsteps, torch_loglike=prob.torch_loglike,
        seed=seed, engine='spec', device=device)
    sampler.stepsampler = ss

    feed = dict(ncalls=0, nranks=0)
    window_z = []
    cum = dict(s=0.0, n=0)

    def observe(ranks, nlive, rec_nsteps=None):
        feed['ncalls'] += 1
        ranks = np.asarray(ranks, float)
        feed['nranks'] += len(ranks)
        norm = (ranks + 0.5) / nlive
        cum['s'] += norm.sum()
        cum['n'] += len(norm)
        acc = ss._mww_acc
        acc.add_many(ranks, nlive)
        if acc.N >= 2048:
            window_z.append(acc.zscore)
            acc.reset()

    ss.observe_insertion_ranks = observe
    t0 = time.time()
    res = sampler.run(
        min_num_live_points=400, viz_callback=False, show_status=False,
        max_num_improvement_loops=0, min_ess=0, dlogz=2.0,
        frac_remain=0.1, region_class=SimpleRegion,
        cluster_num_live_points=0)
    wz = np.array(window_z)
    cum_z = (cum['s'] - 0.5 * cum['n']) / np.sqrt(cum['n'] / 12.0) \
        if cum['n'] else 0.0
    out = dict(
        nsteps=nsteps, seed=seed, wall_s=round(time.time() - t0, 1),
        logz=round(float(res['logz']), 3),
        logzerr=round(float(res['logzerr']), 3),
        feed_calls=feed['ncalls'], nranks=feed['nranks'],
        cumulative_z=round(float(cum_z), 2),
        window_z_mean=round(float(wz.mean()), 3) if len(wz) else None,
        window_z_max=round(float(np.abs(wz).max()), 2) if len(wz) else None,
        window_z=[round(float(z), 2) for z in wz])
    print(json.dumps(out), flush=True)
    return out


def main(argv=None, device='cuda'):
    """``[--device D] [nsteps ...]``; returns the rows."""
    args = list(sys.argv[1:] if argv is None else argv)
    if '--device' in args:
        i = args.index('--device')
        device = args[i + 1]
        del args[i:i + 2]
    return [run(n, device=device) for n in [int(a) for a in args]
            or [200, 400]]


if __name__ == '__main__':
    main()
