"""Profile a warm run of the PyTorch port with cProfile.

Counterpart of ``evaluate/profile_headline.py`` (asymgauss50, the
population spec walk at the bench's full width: ``bench.py:126-175``)
and ``evaluate/profile_eggbox.py`` (the eggbox, the region-rejection
path at the bench configuration: ``bench.py:104-115``). Runs the
problem once to absorb start-up costs (kernel builds, first launches),
then profiles a second run. Prints the run's row, its
``_segment_phase_s``, the top cumulative and tottime entries, and for
the spec walk the host split of one round: the time each callee of the
round body took, per round, and the round body's own Python time
(``round_split_ms``).

Usage::

    python -m ultranest_torch.evaluate.profile_run [--problem asymgauss50|eggbox]
        [--device cpu] [--seed 1] [--top 25] [--out FILE] [--stats FILE]

cProfile adds cost to every Python call and none to work inside native
code, so its split shifts the proportions; the unprofiled wall is in
the warm-up row.
"""

import argparse
import cProfile
import io
import json
import pstats
import time


def run_asymgauss50(seed=1, device='cuda', ndim=50, popsize=4096,
                    nsteps=100):
    """asymgauss50 on the spec walk as ``bench.py:_run_popfused`` runs it
    (``ScalingLayer``, ``SimpleRegion``, spec depth 8, 400 live points,
    dlogz 2, frac_remain 0.1). Returns (row, sampler)."""
    from ultranest_torch import ReactiveNestedSampler
    from ultranest_torch.mlfriends import ScalingLayer, SimpleRegion
    from ultranest_torch.models import asymgauss
    from ultranest_torch.popfused import FusedPopulationSliceSampler
    prob = asymgauss(ndim=ndim, sigma_min=0.01)
    sampler = ReactiveNestedSampler(seed=seed, device=device,
                                    **prob.sampler_kwargs(use_torch=False))
    sampler.transform_layer_class = ScalingLayer
    sampler.stepsampler = FusedPopulationSliceSampler(
        popsize=popsize, nsteps=nsteps, torch_loglike=prob.torch_loglike,
        torch_transform=prob.torch_transform, seed=seed, engine='spec',
        spec_depth=8, device=device)
    return _timed(sampler, prob, device, dict(
        min_num_live_points=400, viz_callback=False, show_status=False,
        max_num_improvement_loops=0, min_ess=0, dlogz=2.0, frac_remain=0.1,
        region_class=SimpleRegion, cluster_num_live_points=0))


def run_eggbox(seed=42, device='cuda'):
    """The eggbox at the bench configuration (400 live points, ndraw 4096
    to 32768, dlogz 0.5, max_ncalls 400000) on the region-rejection
    path. Returns (row, sampler)."""
    from ultranest_torch import ReactiveNestedSampler
    from ultranest_torch.models import eggbox
    prob = eggbox()
    sampler = ReactiveNestedSampler(
        seed=seed, device=device, ndraw_min=4096, ndraw_max=32768,
        **prob.sampler_kwargs(use_torch=True))
    return _timed(sampler, prob, device, dict(
        min_num_live_points=400, viz_callback=False, show_status=False,
        max_num_improvement_loops=0, min_ess=0, dlogz=0.5, frac_remain=0.1,
        Lepsilon=0.001, max_ncalls=400000))


def _timed(sampler, prob, device, options):
    import torch
    t0 = time.perf_counter()
    res = sampler.run(**options)
    if str(device).startswith('cuda'):
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    row = dict(problem=prob.name, wall_s=wall, ncall=int(res['ncall']),
               niter=int(res['niter']), logz=float(res['logz']),
               logzerr=float(res['logzerr']), logz_expected=prob.logz,
               phases_s={k: float(v) for k, v in getattr(
                   sampler, '_segment_phase_s', {}).items()})
    walks = getattr(sampler.stepsampler, 'walk_log', None)
    if walks:
        row['dispatches'] = len(walks)
        row['rounds'] = int(sum(w['rounds'] for w in walks))
    return row, sampler


RUNS = dict(asymgauss50=(run_asymgauss50, 1), eggbox=(run_eggbox, 42))


def round_split(stats, rounds):
    """Host ms per round of the spec walk's round body: each callee's
    cumulative time when called from ``round_body``, over *rounds*, and
    the body's own time (``round_body (own)``), largest first."""
    body = [k for k in stats.stats if k[2] == 'round_body'
            and k[0].endswith('popfused.py')]
    if not body or not rounds:
        return {}
    split = {}
    for key in body:
        split['round_body (own)'] = split.get('round_body (own)', 0.0) + \
            1e3 * stats.stats[key][2] / rounds
    for func, (_, _, _, _, callers) in stats.stats.items():
        for key in body:
            if key in callers:
                name = '%s:%d(%s)' % (func[0].rsplit('/', 1)[-1], func[1],
                                      func[2]) if func[0] != '~' else func[2]
                split[name] = split.get(name, 0.0) + \
                    1e3 * callers[key][3] / rounds
    return dict(sorted(split.items(), key=lambda kv: -kv[1]))


def top_entries(profile, sort, n):
    """The first *n* rows of *profile*'s ``pstats`` output sorted by
    *sort*."""
    s = io.StringIO()
    pstats.Stats(profile, stream=s).sort_stats(sort).print_stats(n)
    return s.getvalue()


def main(argv=None, device='cuda'):
    """Parse *argv* (default ``sys.argv[1:]``), warm up, profile; returns
    the summary dict. ``--device`` overrides *device*."""
    ap = argparse.ArgumentParser()
    ap.add_argument('--problem', choices=sorted(RUNS), default='asymgauss50')
    ap.add_argument('--device', default=device)
    ap.add_argument('--seed', type=int, default=None)
    ap.add_argument('--top', type=int, default=25)
    ap.add_argument('--out', default=None,
                    help='write the summary JSON to this path')
    ap.add_argument('--stats', default=None,
                    help='dump the cProfile stats to this path')
    args = ap.parse_args(argv)
    run, seed0 = RUNS[args.problem]
    seed = seed0 if args.seed is None else args.seed
    if str(args.device).startswith('cuda'):
        import subprocess
        print(subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip())
    print('device:', args.device)

    warm, _ = run(seed=seed, device=args.device)
    print('warm-up run:', json.dumps(warm))
    pr = cProfile.Profile()
    t0 = time.time()
    pr.enable()
    row, sampler = run(seed=seed, device=args.device)
    pr.disable()
    print('profiled wall: %.3f s' % (time.time() - t0))
    print('row:', json.dumps({k: v for k, v in row.items()
                              if k != 'phases_s'}))
    print('phases:', json.dumps(row['phases_s']))
    stats = pstats.Stats(pr)
    for sort in ('cumulative', 'tottime'):
        print('==== sorted by', sort, '====')
        print(top_entries(pr, sort, args.top))
    split = round_split(stats, row.get('rounds', 0))
    if split:
        print('host ms per spec-walk round (%d rounds):' % row['rounds'])
        for name, ms in list(split.items())[:args.top]:
            print('  %10.4f  %s' % (ms, name))
    summary = dict(warm=warm, profiled=row, round_split_ms=split,
                   round_split_total_ms=sum(split.values()) if split
                   else None)
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(summary, f, indent=1)
    if args.stats:
        pr.dump_stats(args.stats)
    return summary


if __name__ == '__main__':
    main()
