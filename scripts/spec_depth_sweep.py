#!/usr/bin/env python3
"""The spec-walk problems at fixed speculation depths, beside what the
depth probe would choose.

For each problem of ``chip_smoke.py``'s spec path (asymgauss50,
rosenbrock8, multishell8, loggamma30, gauss100, at the JAX package's
bench settings) it prints, on one CUDA card:

* A at the problem's shape: one round without the likelihood
  (``popfused.measure_round_overhead``, device time of a captured chunk
  of rounds);
* the likelihood as the walk pays it: a CUDA graph's replay of the
  transform and likelihood on P and on P x 8 rows
  (``popfused.graph_call_seconds``), and what the depth probe makes of
  them: the cost of a further popsize batch (t_row) and the call's
  fixed cost;
* the depth ``optimal_spec_depth`` picks from 8 with this shape's A,
  from the rows of one round over the depth and from the probe's split;
* one run at each depth of ``--depths`` with the probe off: wall, ncall,
  niter, rounds, logZ.

Each problem ends in one JSON line (``--out`` appends them to a file).
Run from the repository root on a CUDA machine::

    python3 scripts/spec_depth_sweep.py [--problem NAME ...] \\
        [--depths 8,1,2,3,4,8] [--out FILE]
"""

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from ultranest_torch import popfused  # noqa: E402
from ultranest_torch.models import problems  # noqa: E402

SPEC_PROBLEMS = ('asymgauss50', 'rosenbrock8', 'multishell8', 'loggamma30',
                 'gauss100')


def likelihood_costs(name, depth=8):
    """A, the likelihood's graph seconds on P and P x *depth* rows, and
    the probe's t_row, at *name*'s shape."""
    (factory, kw), popsize, nsteps = chip_smoke.POPULATION_PROBLEMS[name][:3]
    prob = getattr(problems, factory)(**kw)
    tr = prob.torch_transform or (lambda x: x)
    out = dict(round_overhead_s=popfused.measure_round_overhead(
        popsize, depth, prob.ndim, nsteps))
    for rows in (popsize, popsize * depth):
        u = torch.full((rows, prob.ndim), 0.5, device='cuda')
        out['graph_s_%d_rows' % rows] = popfused.graph_call_seconds(
            lambda: prob.torch_loglike(tr(u)), 'cuda')
    s = popfused.FusedPopulationSliceSampler(
        popsize=popsize, nsteps=nsteps, torch_loglike=prob.torch_loglike,
        torch_transform=prob.torch_transform, spec_depth=depth, device='cuda')
    out.update(s._probe_likelihood_cost(prob.ndim))
    # the rows of one round over the depth, weighed against A alone; then
    # the probe's split: the cost of a further batch, weighed against A
    # and the likelihood's fixed cost a call
    out['depth_rows_over_depth'] = popfused.optimal_spec_depth(
        out['graph_s_%d_rows' % (popsize * depth)] / depth, depth,
        out['round_overhead_s'])
    out['depth_probe'] = popfused.optimal_spec_depth(
        out['t_row_s'], depth, out['round_overhead_s'] + out['fixed_s'])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--problem', action='append', dest='problems',
                    choices=SPEC_PROBLEMS)
    ap.add_argument('--depths', default='8,1,2,3,4,8')
    ap.add_argument('--out')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('spec_depth_sweep: no CUDA device', file=sys.stderr)
        return 1
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print('ROUND_OVERHEAD_S %.4f ms' % (1e3 * popfused.ROUND_OVERHEAD_S))
    depths = [int(x) for x in args.depths.split(',')]
    for name in args.problems or SPEC_PROBLEMS:
        line = dict(problem=name, card=card, **likelihood_costs(name))
        print('%s: A %.4f ms, likelihood graph %s ms, t_row %.4f ms, fixed '
              '%.4f ms (%s); depth from 8: %d from the rows of one round '
              'over the depth against A, %d from the probe' % (
                  name, 1e3 * line['round_overhead_s'], ', '.join(
                      '%s %.4f' % (k[8:], 1e3 * v) for k, v in line.items()
                      if k.startswith('graph_s_')),
                  1e3 * line['t_row_s'], 1e3 * line['fixed_s'],
                  line['how'], line['depth_rows_over_depth'],
                  line['depth_probe']), flush=True)
        line['runs'] = []
        for depth in depths:
            run = chip_smoke.run_population_problem(
                name, spec_depth=depth, spec_depth_auto=False)
            keep = {k: run[k] for k in ('spec_depth', 'wall_s', 'ncall',
                                        'niter', 'rounds', 'dispatches',
                                        'logz', 'logzerr')}
            keep['walk_s'] = run['phases_s'].get('launch', 0.0) + \
                run['phases_s'].get('fetch', 0.0)
            line['runs'].append(keep)
            print('%s depth %d: wall %.3f s, walk %.3f s, ncall %d, niter %d, '
                  '%d rounds, %d dispatches, logZ %.4f +- %.4f' % (
                      name, depth, run['wall_s'], keep['walk_s'],
                      run['ncall'], run['niter'], run['rounds'],
                      run['dispatches'], run['logz'], run['logzerr']),
                  flush=True)
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, 'a') as f:
                f.write(json.dumps(line) + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
