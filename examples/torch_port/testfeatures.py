"""Randomized settings fuzzer, on the PyTorch port.

Counterpart of ``examples/testfeatures.py``: builds a random combination
of problem / dimensionality / sampler / resume settings from a seed,
runs nested sampling end-to-end through :mod:`ultranest_torch`, and
stores failing configurations as replayable JSON files in
``testfeatures/``. :func:`generate_runargs` is the original's, key for
key (``use_jax`` included), so one ``random.seed`` draws the same
configuration in both fuzzers; here ``use_jax`` selects the torch
likelihood (``torch_loglike=``).

``mesh_devices`` builds a mesh only when the process runs under at least
that many ranks (the ``torch.distributed`` world size, e.g. under
``torchrun``); a single process, as under pytest, gets no mesh. The JAX
package's CPU tests run its fuzzer on 8 virtual devices, so there its
``mesh_devices=4`` configurations do shard.

Usage::

    python examples/torch_port/testfeatures.py --random --seed 42 --nrounds 5
    python examples/torch_port/testfeatures.py --device cpu \\
        testfeatures/runsettings-xxxx-error.json
"""

import hashlib
import json
import os
import random
import shutil
import signal
import string
import sys
import traceback

import numpy as np

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.abspath(__file__)), '..', '..'))


def get_arg_hash(runargs):
    """Stable short id of a configuration."""
    return hashlib.md5(str(sorted(runargs.items())).encode()).hexdigest()[:10]


class AttrDict(dict):
    """Dict with attribute access."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.__dict__ = self


def build_problem(args, ndim):
    """Return (paramnames, loglike, transform, true_Z, torch_loglike,
    torch_transform) for the config."""
    import torch
    paramnames = list(string.ascii_lowercase)[:ndim]
    if args.problem == 'powergauss':
        # NON-AFFINE transform: exercises the p-space WrappingEllipsoid
        # (tregion) filter, fused on the device in the torch path
        sigma = 0.05

        def transform(x):
            return 10.0 * x ** 2

        def torch_transform(x):
            return 10.0 * x ** 2

        def loglike(p):
            return -0.5 * (((p - 2.0) / sigma) ** 2).sum(axis=1)

        def torch_loglike(p):
            return -0.5 * (((p - 2.0) / sigma) ** 2).sum(dim=1)

        # per-axis quadrature truth: int_0^1 exp(-((10x^2-2)/sig)^2/2) dx
        x = (np.arange(200000) + 0.5) / 200000
        li = -0.5 * ((10.0 * x ** 2 - 2.0) / sigma) ** 2
        m = li.max()
        true_Z = ndim * float(np.log(np.exp(li - m).mean()) + m)
        return paramnames, loglike, transform, true_Z, torch_loglike, \
            torch_transform

    if args.problem == 'gauss':
        sigma = 0.01
        if args.wrapped_dims:
            centers = (np.sin(np.arange(ndim) / 2.0) + 1.0) / 2.0
        else:
            centers = (np.sin(np.arange(ndim) / 2.0) / 2.0 + 1.0) / 2.0

        def loglike(theta):
            return -0.5 * (((theta - centers) / sigma) ** 2).sum(axis=1) \
                - 0.5 * np.log(2 * np.pi * sigma**2) * ndim

        def torch_loglike(theta):
            c = torch.as_tensor(centers, dtype=theta.dtype,
                                device=theta.device)
            return -0.5 * (((theta - c) / sigma) ** 2).sum(dim=1) \
                - 0.5 * np.log(2 * np.pi * sigma**2) * ndim

        return paramnames, loglike, (lambda x: x), 0.0, torch_loglike, \
            None

    if args.problem == 'multigauss':
        sigma = 0.05

        def loglike(theta):
            a = -0.5 * (((theta - 0.3) / sigma) ** 2).sum(axis=1)
            b = -0.5 * (((theta - 0.7) / sigma) ** 2).sum(axis=1)
            return np.logaddexp(a, b) \
                - 0.5 * np.log(2 * np.pi * sigma**2) * ndim - np.log(2.0)

        def torch_loglike(theta):
            a = -0.5 * (((theta - 0.3) / sigma) ** 2).sum(dim=1)
            b = -0.5 * (((theta - 0.7) / sigma) ** 2).sum(dim=1)
            return torch.logaddexp(a, b) \
                - 0.5 * np.log(2 * np.pi * sigma**2) * ndim - np.log(2.0)

        return paramnames, loglike, (lambda x: x), 0.0, torch_loglike, \
            None

    if args.problem == 'slantedeggbox':
        def loglike(z):
            chi = (2.0 + (np.cos(z[:, :2] / 2.0)).prod(axis=1)) ** 5
            chi2 = -np.abs((z - 5 * np.pi) / 0.5).sum(axis=1)
            return chi + chi2

        def transform(x):
            return x * 100

        return paramnames, loglike, transform, None, None, None

    if args.problem == 'funnel':
        sigma = 0.01
        centers = np.sin(np.arange(ndim) / 2.0)
        data = np.random.normal(centers, sigma).reshape((1, -1))

        def loglike(theta):
            s = 10 ** theta[:, 0]
            return -0.5 * (((theta[:, 1:] - data)
                            / s.reshape((-1, 1))) ** 2).sum(axis=1) \
                - 0.5 * np.log(2 * np.pi * s**2) * ndim

        def transform(x):
            z = x * 20 - 10
            z[:, 0] = x[:, 0] * 6 - 3
            return z

        return ['sigma'] + paramnames, loglike, transform, None, None, \
            None

    raise ValueError(args.problem)


def world_size():
    """Ranks of the initialised ``torch.distributed`` group (1 without
    one)."""
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def main(args, device='cuda', storage_backend='hdf5'):
    """Run one fuzzed configuration end-to-end on *device*.

    *storage_backend* is the run directory's point store for
    configurations with a ``log_dir`` ('hdf5' as in the original; 'csv'
    where h5py is not installed).
    """
    ndim = args.x_dim
    np.random.seed(args.seed)
    wrapped_params = [True] * ndim if args.wrapped_dims else None

    if args.problem == 'funnel' and (args.wrapped_dims
                                     or not args.pass_transform):
        return
    if args.problem in ('slantedeggbox', 'powergauss') \
            and not args.pass_transform:
        return

    if args.log_dir is None:
        if args.delete_dir:
            return
        log_dir = None
    else:
        log_dir = args.log_dir + '-%s-%dd' % (args.problem, ndim)
        if args.wrapped_dims:
            log_dir += '-wrapped'
        if args.delete_dir:
            shutil.rmtree(log_dir, ignore_errors=True)

    if ndim >= 20 and args.num_live_points >= 1000:
        print("skipping, probably too slow to run")
        return

    paramnames, loglike, transform, true_Z, torch_loglike, torch_transform \
        = build_problem(args, ndim)
    if args.problem == 'funnel':
        ndim_sampling = ndim + 1
    else:
        ndim_sampling = ndim
    del ndim

    from ultranest_torch import ReactiveNestedSampler
    from ultranest_torch.mlfriends import (MLFriends, RobustEllipsoidRegion,
                                           ScalingLayer, SimpleRegion)
    # torch path dimensions: fused device proposals (non-identity
    # transforms need a torch twin — powergauss fuzzes the non-affine
    # tregion-filtered path), mesh sharding, segment engine forced
    # on/off vs the default
    use_torch = bool(getattr(args, 'use_jax', False)) \
        and torch_loglike is not None \
        and (not args.pass_transform or torch_transform is not None)
    use_torch_transform = use_torch and args.pass_transform \
        and torch_transform is not None
    mesh = None
    if use_torch and getattr(args, 'mesh_devices', 0):
        from ultranest_torch.parallel import make_mesh
        n = int(args.mesh_devices)
        if world_size() >= n:
            mesh = make_mesh(n)
    sampler = ReactiveNestedSampler(
        paramnames, loglike,
        transform=transform if args.pass_transform else None,
        log_dir=log_dir, vectorized=True,
        resume='resume' if args.resume else 'overwrite',
        wrapped_params=wrapped_params,
        torch_loglike=torch_loglike if use_torch else None,
        torch_transform=torch_transform if use_torch_transform else None,
        mesh=mesh, device=device, storage_backend=storage_backend)
    if use_torch and getattr(args, 'segment', None) is not None \
            and sampler.fused_sampler is not None:
        sampler.fused_sampler.segment_enabled = bool(args.segment)
    if getattr(args, 'axis_aligned', False):
        sampler.transform_layer_class = ScalingLayer
        region_class = SimpleRegion
    elif getattr(args, 'ellipsoidal', False):
        region_class = RobustEllipsoidRegion
    else:
        region_class = MLFriends

    if getattr(args, 'stepsampler', None) == 'popfused' \
            and torch_loglike is not None \
            and (not args.pass_transform or torch_transform is not None):
        engine = getattr(args, 'engine', 'spec')
        if engine == 'rwalk':
            from ultranest_torch.popfused import \
                FusedPopulationRandomWalkSampler
            sampler.stepsampler = FusedPopulationRandomWalkSampler(
                popsize=32, nsteps=16, torch_loglike=torch_loglike,
                torch_transform=torch_transform if use_torch_transform
                else None, seed=args.seed, mesh=mesh, device=device)
        else:
            from ultranest_torch.popfused import FusedPopulationSliceSampler
            sampler.stepsampler = FusedPopulationSliceSampler(
                popsize=32, nsteps=8, torch_loglike=torch_loglike,
                torch_transform=torch_transform if use_torch_transform
                else None, seed=args.seed, engine=engine, mesh=mesh,
                device=device)
    elif getattr(args, 'stepsampler', None) == 'popslice':
        from ultranest_torch.ops.stepfuncs import \
            generate_region_oriented_direction
        from ultranest_torch.popstepsampler import PopulationSliceSampler
        sampler.stepsampler = PopulationSliceSampler(
            popsize=16, nsteps=10,
            generate_direction=generate_region_oriented_direction)
    elif getattr(args, 'stepsampler', None) == 'slice':
        from ultranest_torch.stepsampler import RegionSliceSampler
        sampler.stepsampler = RegionSliceSampler(nsteps=2 * ndim_sampling)

    for _result in sampler.run_iter(
            update_interval_volume_fraction=args.update_interval_iter_fraction,
            dlogz=args.dlogz,
            dKL=args.dKL,
            frac_remain=args.frac_remain,
            min_ess=args.min_ess,
            max_iters=args.max_iters,
            cluster_num_live_points=args.cluster_num_live_points,
            min_num_live_points=args.num_live_points,
            max_ncalls=int(args.max_ncalls),
            region_class=region_class,
            viz_callback=False, show_status=False):
        sampler.print_results(use_unicode=False)

    results = sampler.results
    if log_dir is not None:
        try:
            sampler.plot()
        except Exception:
            pass
    sampler.pointstore.close()
    if results['logzerr_tail'] < 0.5 and results['logzerr'] < 1.0 \
            and true_Z is not None and args.num_live_points > 50:
        assert results['logz'] - results['logzerr'] * 3 < true_Z \
            < results['logz'] + results['logzerr'] * 3, (
            results['logz'], results['logzerr'], true_Z)
    return results


def generate_runargs(choose):
    """Draw one random configuration."""
    return dict(
        problem=choose(['gauss', 'multigauss', 'slantedeggbox', 'funnel',
                        'powergauss']),
        x_dim=choose([2, 1, 6, 20]),
        seed=choose([1, 2, 3]),
        wrapped_dims=choose([False, True]),
        log_dir=choose(['logs/features', None]),
        delete_dir=choose([False, False, False, True]),
        pass_transform=choose([True, False]),
        num_live_points=choose([100, 50, 400]),
        resume=choose([False, True]),
        cluster_num_live_points=choose([50, 0]),
        update_interval_iter_fraction=choose([0.2, 1.0]),
        dlogz=choose([2.0, 0.5]),
        dKL=choose([1.0, 0.1]),
        frac_remain=choose([0.5, 0.001]),
        min_ess=choose([0, 400]),
        max_iters=choose([None, 10000]),
        max_ncalls=choose([100000.0, 10000.0]),
        axis_aligned=choose([False, True]),
        ellipsoidal=choose([False, True]),
        stepsampler=choose([None, 'slice', 'popslice', 'popfused']),
        engine=choose(['spec', 'spec', 'async', 'sync', 'rwalk']),
        use_jax=choose([False, True]),
        mesh_devices=choose([0, 0, 4]),
        segment=choose([None, None, True, False]),
    )


def run_safely(runargs, timeout_scale=60, device='cuda',
               storage_backend='hdf5'):
    """Run a configuration with timeout; store failures as JSON."""
    os.makedirs('testfeatures', exist_ok=True)
    argid = get_arg_hash(runargs)
    if os.path.exists('testfeatures/%s.done' % argid):
        print("not rerunning %s" % argid)
        return
    print("Running %s with options:" % argid, runargs)

    def timeout_handler(signum, frame):
        raise Exception("Timeout")

    signal.signal(signal.SIGALRM, timeout_handler)
    signal.alarm(timeout_scale * (1 + runargs['x_dim']))
    try:
        main(AttrDict(runargs), device=device,
             storage_backend=storage_backend)
    except Exception:
        traceback.print_exc()
        filename = 'testfeatures/runsettings-%s-error.json' % argid
        print("Storing configuration as '%s'." % filename)
        with open(filename, 'w') as f:
            json.dump(runargs, f, indent=2)
        sys.exit(1)
    signal.alarm(0)
    with open('testfeatures/%s.done' % argid, 'w'):
        pass


if __name__ == '__main__':
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument('--random', action='store_true')
    parser.add_argument('--seed', type=int, default=1)
    parser.add_argument('--timeout', action='store_true')
    parser.add_argument('--nrounds', type=int, default=1)
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--storage-backend', default='hdf5',
                        choices=['hdf5', 'csv', 'tsv'])
    parser.add_argument('conf', nargs='*', help='config files to replay')
    progargs = parser.parse_args()
    opts = dict(device=progargs.device,
                storage_backend=progargs.storage_backend)

    if len(progargs.conf) > 0:
        for filename in progargs.conf:
            print("loading configuration from file '%s'..." % filename)
            with open(filename) as f:
                runargs = json.load(f)
            if progargs.timeout:
                run_safely(runargs, **opts)
            else:
                main(AttrDict(runargs), **opts)
        sys.exit(0)

    random.seed(progargs.seed)

    def choose(myargs):
        # pick the first (default) option most of the time
        if random.random() < 0.25:
            return myargs[0]
        return random.choice(myargs)

    for _ in range(progargs.nrounds):
        runargs = generate_runargs(choose)
        run_safely(runargs, **opts)
