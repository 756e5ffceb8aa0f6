"""Which per-dispatch diagnostic separates too-short from long-enough
chains on the 100-d sigma=0.01 gaussian, on the PyTorch port?

Counterpart of ``evaluate/governor_signal_study.py``: records the
jump-distance diagnostics the engines already compute (far-enough
fraction, geometric-mean relative jump) across nsteps, to locate a
threshold that separates too-short chains from long-enough ones.

Usage::

    python -m ultranest_torch.evaluate.governor_signal_study \
        [--sigma S] [--device cpu] [nsteps ...]

Prints one JSON line per nsteps value.
"""
import json
import sys
import time

import numpy as np


def run(nsteps, seed=3, sigma=0.01, ndim=100, popsize=2048, device='cuda'):
    """One spec-walk run of ``gauss(ndim, sigma)`` at *nsteps*; returns
    the study's row (and prints it)."""
    from ultranest_torch import ReactiveNestedSampler, models
    from ultranest_torch.mlfriends import ScalingLayer, SimpleRegion
    from ultranest_torch.popfused import FusedPopulationSliceSampler

    prob = models.gauss(ndim=ndim, sigma=sigma)
    sampler = ReactiveNestedSampler(seed=seed, device=device,
                                    **prob.sampler_kwargs(use_torch=False))
    sampler.transform_layer_class = ScalingLayer
    ss = FusedPopulationSliceSampler(
        popsize=popsize, nsteps=nsteps, torch_loglike=prob.torch_loglike,
        seed=seed, engine='spec', device=device)
    sampler.stepsampler = ss
    t0 = time.time()
    res = sampler.run(
        min_num_live_points=400, viz_callback=False, show_status=False,
        max_num_improvement_loops=0, min_ess=0, dlogz=2.0,
        frac_remain=0.1, region_class=SimpleRegion,
        cluster_num_live_points=0)
    arr = np.asarray(ss.logstat, float)
    lab = ss.logstat_labels
    far = arr[:, lab.index('far_enough')]
    rj = arr[:, lab.index('mean_rel_jump')]
    out = dict(
        nsteps=nsteps, sigma=sigma, seed=seed,
        wall_s=round(time.time() - t0, 1),
        logz=round(float(res['logz']), 3),
        logzerr=round(float(res['logzerr']), 3),
        far_mean=round(float(np.nanmean(far)), 3),
        far_q10=round(float(np.nanquantile(far, 0.1)), 3),
        far_min=round(float(np.nanmin(far)), 3),
        reljump_gm=round(float(np.nanmean(rj)), 3),
        reljump_q10=round(float(np.nanquantile(rj, 0.1)), 3),
        reljump_min=round(float(np.nanmin(rj)), 3),
        far_seq=[round(float(v), 2) for v in far[::max(1, len(far) // 40)]],
        rj_seq=[round(float(v), 2) for v in rj[::max(1, len(rj) // 40)]])
    print(json.dumps(out), flush=True)
    return out


def main(argv=None, device='cuda'):
    """``[--sigma S] [--device D] [nsteps ...]``; returns the rows."""
    args = list(sys.argv[1:] if argv is None else argv)
    sigma = 0.01
    if args and args[0] == '--sigma':
        sigma = float(args[1])
        args = args[2:]
    if '--device' in args:
        i = args.index('--device')
        device = args[i + 1]
        del args[i:i + 2]
    return [run(n, sigma=sigma, device=device)
            for n in [int(a) for a in args] or [100, 200, 400]]


if __name__ == '__main__':
    main()
