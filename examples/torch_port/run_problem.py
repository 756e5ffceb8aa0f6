"""Run nested sampling on any of the built-in benchmark problems, on the
PyTorch port.

Counterpart of ``examples/run_problem.py``. Usage::

    python examples/torch_port/run_problem.py --problem eggbox --torch
    python examples/torch_port/run_problem.py --problem asymgauss \
        --x_dim 50 --sampler popslice --num_live_points 400
    python examples/torch_port/run_problem.py --problem gauss --x_dim 3 \
        --torch --log_dir logs/gauss --device cpu

``--torch`` passes the problem's torch likelihood (the device proposal
path); ``--device`` names the torch device ('cuda' by default).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.abspath(__file__)), '..', '..'))


def main(argv=None, device='cuda'):
    """Parse *argv* (default ``sys.argv[1:]``), run, and return the
    results dict. ``--device`` overrides *device*."""
    parser = argparse.ArgumentParser()
    parser.add_argument('--problem', default='gauss',
                        help='gauss|multigauss|asymgauss|corrgauss|eggbox|'
                             'rosenbrock|multishell|shell|loggamma|funnel|'
                             'pyramid|sine|corrpeak|hyperrect|dirichlet|'
                             'slantedeggbox')
    parser.add_argument('--x_dim', type=int, default=2)
    parser.add_argument('--num_live_points', type=int, default=400)
    parser.add_argument('--sampler', default='region',
                        help='region|slice|popslice|poprw|harm|simpleslice|'
                             'fusedslice|fusedrw')
    parser.add_argument('--nsteps', type=int, default=0,
                        help='step sampler steps (default 2*ndim)')
    parser.add_argument('--popsize', type=int, default=64)
    parser.add_argument('--torch', action='store_true',
                        help='use the fused device proposal path')
    parser.add_argument('--device', default=device)
    parser.add_argument('--log_dir', default=None)
    parser.add_argument('--seed', type=int, default=1)
    parser.add_argument('--dlogz', type=float, default=0.5)
    parser.add_argument('--frac_remain', type=float, default=0.01)
    parser.add_argument('--max_ncalls', type=int, default=None)
    args = parser.parse_args(argv)

    from ultranest_torch import ReactiveNestedSampler
    from ultranest_torch.models import problems as models

    factory = getattr(models, args.problem)
    try:
        prob = factory(ndim=args.x_dim)
    except TypeError:
        prob = factory()

    kwargs = prob.sampler_kwargs(use_torch=args.torch)
    if getattr(prob, 'wrapped_params', None) is not None:
        kwargs['wrapped_params'] = prob.wrapped_params
    sampler = ReactiveNestedSampler(log_dir=args.log_dir, seed=args.seed,
                                    resume='overwrite', device=args.device,
                                    **kwargs)

    nsteps = args.nsteps or 2 * prob.ndim
    if args.sampler == 'slice':
        from ultranest_torch.stepsampler import SliceSampler, \
            generate_mixture_random_direction
        sampler.stepsampler = SliceSampler(
            nsteps=nsteps,
            generate_direction=generate_mixture_random_direction)
    elif args.sampler == 'harm':
        from ultranest_torch.stepsampler import RegionBallSliceSampler
        sampler.stepsampler = RegionBallSliceSampler(nsteps=nsteps)
    elif args.sampler == 'popslice':
        from ultranest_torch.ops.stepfuncs import \
            generate_mixture_random_direction as gen_mix
        from ultranest_torch.popstepsampler import PopulationSliceSampler
        sampler.stepsampler = PopulationSliceSampler(
            popsize=args.popsize, nsteps=nsteps, generate_direction=gen_mix)
    elif args.sampler == 'simpleslice':
        from ultranest_torch.ops.stepfuncs import \
            generate_mixture_random_direction as gen_mix
        from ultranest_torch.popstepsampler import \
            PopulationSimpleSliceSampler
        sampler.stepsampler = PopulationSimpleSliceSampler(
            popsize=args.popsize, nsteps=nsteps, generate_direction=gen_mix)
    elif args.sampler == 'poprw':
        from ultranest_torch.ops.stepfuncs import \
            generate_region_random_direction
        from ultranest_torch.popstepsampler import \
            PopulationRandomWalkSampler
        sampler.stepsampler = PopulationRandomWalkSampler(
            popsize=args.popsize, nsteps=nsteps,
            generate_direction=generate_region_random_direction, scale=0.1)
    elif args.sampler == 'fusedslice':
        from ultranest_torch.popfused import FusedPopulationSliceSampler
        sampler.stepsampler = FusedPopulationSliceSampler(
            popsize=args.popsize, nsteps=nsteps,
            torch_loglike=prob.torch_loglike,
            torch_transform=prob.torch_transform, seed=args.seed,
            device=args.device)
    elif args.sampler == 'fusedrw':
        from ultranest_torch.popfused import FusedPopulationRandomWalkSampler
        sampler.stepsampler = FusedPopulationRandomWalkSampler(
            popsize=args.popsize, nsteps=nsteps,
            torch_loglike=prob.torch_loglike,
            torch_transform=prob.torch_transform, seed=args.seed, scale=0.1,
            device=args.device)
    elif args.sampler != 'region':
        sys.exit('unknown sampler %r' % args.sampler)

    results = sampler.run(min_num_live_points=args.num_live_points,
                          dlogz=args.dlogz, frac_remain=args.frac_remain,
                          max_ncalls=args.max_ncalls,
                          max_num_improvement_loops=0, min_ess=0)
    sampler.print_results()
    if prob.logz is not None:
        print('analytic logZ = %.3f  (measured %.3f +- %.3f)' % (
            prob.logz, results['logz'], results['logzerr']))
    if args.log_dir:
        sampler.plot()
    return results


if __name__ == '__main__':
    main()
