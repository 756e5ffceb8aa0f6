"""Measure ncall-vs-dimension scaling of the sampler families, on the
PyTorch port.

Counterpart of ``examples/evaluate_scaling.py``: runs a standard
gaussian across dimensions with (a) MLFriends region rejection
sampling, (b) the region slice sampler, (c) the fused device population
slice sampler (its torch likelihood on ``--device``), and reports
likelihood evaluations to reach dlogz.

Usage::

    python examples/torch_port/evaluate_scaling.py [--dims 2,4,8,16] \
        [--methods mlfriends,slice,popslice] [--plot scaling.pdf] \
        [--json scaling.json] [--device cpu]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.abspath(__file__)), '..', '..'))


def run_one(method, ndim, seed=1, device='cuda'):
    from ultranest_torch import ReactiveNestedSampler
    from ultranest_torch import stepsampler as ss
    from ultranest_torch.models import gauss
    from ultranest_torch.popfused import FusedPopulationSliceSampler

    prob = gauss(ndim=ndim, sigma=0.1)
    sampler = ReactiveNestedSampler(seed=seed, device=device,
                                    **prob.sampler_kwargs(use_torch=False))
    if method == 'slice':
        sampler.stepsampler = ss.RegionSliceSampler(nsteps=2 * ndim)
    elif method == 'popslice':
        sampler.stepsampler = FusedPopulationSliceSampler(
            popsize=64, nsteps=2 * ndim, torch_loglike=prob.torch_loglike,
            torch_transform=getattr(prob, 'torch_transform', None),
            seed=seed, device=device)
    elif method != 'mlfriends':
        raise ValueError('unknown method %r' % method)
    t0 = time.time()
    results = sampler.run(min_num_live_points=200, viz_callback=False,
                          show_status=False, max_num_improvement_loops=0,
                          min_ess=0, dlogz=1.0, frac_remain=0.5,
                          max_ncalls=20_000_000)
    return dict(ndim=ndim, method=method, ncall=int(results['ncall']),
                niter=int(results['niter']), logz=float(results['logz']),
                logzerr=float(results['logzerr']),
                wall_s=round(time.time() - t0, 2))


def main(argv=None, device='cuda'):
    """Parse *argv* (default ``sys.argv[1:]``), run, and return the
    measurement rows. ``--device`` overrides *device*."""
    parser = argparse.ArgumentParser()
    parser.add_argument('--dims', default='2,4,8,16')
    parser.add_argument('--methods', default='mlfriends,slice,popslice')
    parser.add_argument('--plot', default=None,
                        help='write a ncall-vs-ndim figure to this path')
    parser.add_argument('--json', default=None,
                        help='write the measurement rows to this path')
    parser.add_argument('--seed', type=int, default=1)
    parser.add_argument('--device', default=device)
    args = parser.parse_args(argv)

    dims = [int(d) for d in args.dims.split(',')]
    methods = args.methods.split(',')
    rows = []
    print('%-10s %5s %12s %8s %8s %8s' %
          ('method', 'ndim', 'ncall', 'niter', 'logz', 'wall_s'))
    for method in methods:
        for ndim in dims:
            row = run_one(method, ndim, seed=args.seed, device=args.device)
            rows.append(row)
            print('%-10s %5d %12d %8d %8.2f %8.1f' %
                  (method, ndim, row['ncall'], row['niter'], row['logz'],
                   row['wall_s']))

    if args.json:
        with open(args.json, 'w') as f:
            json.dump(rows, f, indent=1)
    if args.plot:
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        for method in methods:
            data = [(r['ndim'], r['ncall']) for r in rows
                    if r['method'] == method]
            x, y = np.transpose(sorted(data))
            plt.plot(x, y, marker='o', mfc='w', label=method)
        plt.xlabel('dimensionality')
        plt.ylabel('likelihood evaluations')
        plt.yscale('log')
        plt.legend()
        plt.savefig(args.plot, bbox_inches='tight')
        print('wrote', args.plot)
    return rows


if __name__ == '__main__':
    main()
