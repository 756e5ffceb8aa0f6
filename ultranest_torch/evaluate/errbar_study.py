"""Error-bar study of the population spec walk, on the PyTorch port.

Counterpart of ``evaluate/errbar_study.py``: why is the high-d logzerr
wider than the reference anchor? Suspects:

1. batch correlation: a segment dispatch consumes ``popsize`` rows
   against ``nlive`` live points; at popsize >> nlive, late rows come
   from chains whose starts predate several live-set turnovers ->
   bootstrap ensemble spreads. Measured here by sweeping popsize at
   fixed nsteps.
2. chain length: nsteps-limited decorrelation widens the spread for
   every popsize. Measured by sweeping nsteps.
3. seed noise: logzerr_bs is a MAX over ~30 bootstrap counters — a
   noisy statistic. Measured by repeating seeds.

Usage::

    python -m ultranest_torch.evaluate.errbar_study \
        [--problem gauss100|asymgauss50] [--popsizes 2048,512] \
        [--nsteps 400] [--seeds 3,4,5] [--adaptive] [--classic] \
        [--device cpu]

Writes one JSON line per run to stdout (prefix ``ROW``).
"""
import argparse
import json
import time


def run_popfused(prob, seed, popsize, nsteps, min_live=400, dlogz=2.0,
                 device='cuda', **sampler_kw):
    """One spec-walk run as ``bench.py:_run_popfused``: ``ScalingLayer``,
    ``SimpleRegion``, spec depth 8; returns its row (wall_s, ncall,
    niter, logz, logzerr, evals_per_s, ncall_useful, useful_evals_per_s,
    phases and, where the governor moved it, nsteps_final)."""
    from ultranest_torch import ReactiveNestedSampler
    from ultranest_torch.mlfriends import ScalingLayer, SimpleRegion
    from ultranest_torch.popfused import FusedPopulationSliceSampler

    sampler = ReactiveNestedSampler(seed=seed, device=device,
                                    **prob.sampler_kwargs(use_torch=False))
    sampler.transform_layer_class = ScalingLayer
    sampler.stepsampler = FusedPopulationSliceSampler(
        popsize=popsize, nsteps=nsteps, torch_loglike=prob.torch_loglike,
        torch_transform=getattr(prob, 'torch_transform', None),
        seed=seed, engine='spec', spec_depth=8, device=device, **sampler_kw)
    t0 = time.time()
    results = sampler.run(
        min_num_live_points=min_live, viz_callback=False, show_status=False,
        max_num_improvement_loops=0, min_ess=0, dlogz=dlogz, frac_remain=0.1,
        region_class=SimpleRegion, cluster_num_live_points=0)
    wall = time.time() - t0
    row = dict(wall_s=wall, ncall=int(results['ncall']),
               niter=int(results['niter']), logz=float(results['logz']),
               logzerr=float(results['logzerr']),
               evals_per_s=results['ncall'] / wall)
    ss = sampler.stepsampler
    if getattr(ss, 'ncalls_useful', 0) and getattr(ss, 'ncalls', 0):
        # useful counts only the evaluations a sequential sampler would
        # have needed for the same accepted chains
        waste = ss.ncalls - ss.ncalls_useful
        row['ncall_useful'] = int(results['ncall']) - int(waste)
        row['useful_evals_per_s'] = row['ncall_useful'] / row['wall_s']
    phases = getattr(sampler, '_segment_phase_s', None)
    if phases:
        row['phases'] = {k: round(v, 3) for k, v in phases.items()}
    nsteps_final = getattr(sampler.stepsampler, 'nsteps', None)
    if nsteps_final is not None and nsteps_final != nsteps:
        row['nsteps_final'] = int(nsteps_final)
    return row


def run(prob, problem, seed, popsize, nsteps, adaptive=False, classic=False,
        sigma=None, device='cuda'):
    """One study row: :func:`run_popfused`, with the segment path off
    if *classic*, and the study's settings."""
    from ultranest_torch.popfused import FusedPopulationSliceSampler
    t0 = time.time()
    old = FusedPopulationSliceSampler.segment_ok
    if classic:
        # same sampler, segment fast path disabled -> classic loop
        FusedPopulationSliceSampler.segment_ok = lambda self: False
    try:
        row = run_popfused(prob, seed, popsize=popsize, nsteps=nsteps,
                           adaptive_nsteps=adaptive, device=device)
    finally:
        FusedPopulationSliceSampler.segment_ok = old
    row.update(problem=problem, popsize=popsize, nsteps=nsteps, seed=seed,
               adaptive=bool(adaptive), classic=bool(classic), sigma=sigma,
               wall_total=time.time() - t0)
    return row


def main(argv=None, device='cuda'):
    """Parse *argv* (default ``sys.argv[1:]``) and run the sweep; returns
    the rows. ``--device`` overrides *device*."""
    ap = argparse.ArgumentParser()
    ap.add_argument('--problem', default='gauss100')
    ap.add_argument('--popsizes', default='2048')
    ap.add_argument('--nsteps', default='400')
    ap.add_argument('--seeds', default='3')
    ap.add_argument('--adaptive', action='store_true')
    ap.add_argument('--sigma', type=float, default=None)
    ap.add_argument('--classic', action='store_true',
                    help='disable the segment fast path (classic loop)')
    ap.add_argument('--device', default=device)
    args = ap.parse_args(argv)

    from ultranest_torch import models
    if args.problem == 'gauss100':
        prob = models.gauss(ndim=100, sigma=args.sigma or 0.01)
    elif args.problem == 'asymgauss50':
        prob = models.asymgauss(ndim=50, sigma_min=args.sigma or 0.01)
    else:
        raise SystemExit('unknown problem %s' % args.problem)

    rows = []
    for popsize in [int(x) for x in args.popsizes.split(',')]:
        for nsteps in [int(x) for x in args.nsteps.split(',')]:
            for seed in [int(x) for x in args.seeds.split(',')]:
                row = run(prob, args.problem, seed, popsize, nsteps,
                          adaptive=args.adaptive, classic=args.classic,
                          sigma=args.sigma, device=args.device)
                rows.append(row)
                print('ROW ' + json.dumps(
                    {k: (round(v, 4) if isinstance(v, float) else v)
                     for k, v in row.items()}), flush=True)
    return rows


if __name__ == '__main__':
    main()
