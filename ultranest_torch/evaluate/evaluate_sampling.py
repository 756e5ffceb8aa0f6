"""Step-sampler shrinkage-correctness harness, on the PyTorch port.

For analytic problems with known volume-from-likelihood relations, runs a
fixed-live-point loop with a given step sampler and compares the measured
per-step volume shrinkage distribution against the theoretical
Beta(1, nlive) expectation. A correctly mixing sampler shows a uniform
shrinkage CDF; a stuck sampler shrinks too fast.

Counterpart of ``evaluate/evaluate_sampling.py``; the regions are built
(and their radii bootstrapped) on ``--device``. Usage::

    python -m ultranest_torch.evaluate.evaluate_sampling \
        --problem circgauss --x_dim 10 --nlive 200 --nsteps 1000 \
        --sampler regionslice [--device cpu]
"""

import argparse

import numpy as np

from .problems import get_problem, transform


def quantify_step(a, b):
    """Step size, angular step and radial step between points a, b."""
    stepsize = np.linalg.norm(a - b)
    da = a - 0.5
    db = b - 0.5
    ra = np.linalg.norm(da)
    rb = np.linalg.norm(db)
    angular_step = np.arccos(np.clip(np.dot(da, db) / (ra * rb), -1, 1))
    radial_step = np.abs(ra - rb)
    return [stepsize, angular_step, radial_step]


def evaluate_warmed_sampler(problemname, ndim, nlive, nsteps, sampler,
                            seed=1, region_class=None, device='cuda'):
    """Run *sampler* on *problemname*; returns (Lsequence, ncalls, steps)."""
    from ultranest_torch.mlfriends import (AffineLayer, RobustEllipsoidRegion,
                                           ScalingLayer)
    if region_class is None:
        region_class = RobustEllipsoidRegion
    loglike, grad, volume, warmup = get_problem(problemname, ndim=ndim)
    if hasattr(sampler, 'set_gradient'):
        sampler.set_gradient(grad)
    np.random.seed(seed)

    def multi_loglike(xs):
        return np.asarray([loglike(x) for x in xs])

    us = np.array([warmup(ndim) for _ in range(nlive)])
    Ls = np.array([loglike(u) for u in us])
    vol0 = volume(Ls.min(), ndim)
    nwarmup = 3 * nlive

    transformLayer = AffineLayer() if ndim > 1 else ScalingLayer()
    transformLayer.optimize(us, us)
    region = region_class(us, transformLayer, device=device)
    region.maxradiussq, region.enlarge = region.compute_enlargement(
        nbootstraps=30)
    region.create_ellipsoid(minvol=vol0)
    sampler.region_changed(Ls, region)

    Lsequence = []
    stepsequence = []
    ncalls = 0
    chunk = []
    for i in range(nsteps + nwarmup):
        if i % int(nlive * 0.2) == 0:
            minvol = (1 - 1.0 / nlive) ** i * vol0
            try:
                nextTransformLayer = transformLayer.create_new(
                    us, region.maxradiussq, minvol=minvol, device=device)
                nextregion = region_class(us, nextTransformLayer,
                                          device=device)
                nextregion.maxradiussq, nextregion.enlarge = \
                    nextregion.compute_enlargement(nbootstraps=30)
                if isinstance(nextregion, RobustEllipsoidRegion) or \
                        nextregion.estimate_volume() <= region.estimate_volume():
                    nextregion.create_ellipsoid(minvol=minvol)
                    region = nextregion
                    transformLayer = region.transformLayer
                    sampler.region_changed(Ls, region)
            except (Warning, FloatingPointError, np.linalg.LinAlgError) as e:
                print("not updating region because: %s" % e)

        j = np.argmin(Ls)
        Lmin = float(Ls[j])
        ustart = us[j].copy()
        while True:
            # consume buffered rows from a previous chunked handoff
            # first, re-checking against the risen threshold (exactly
            # what the integrator's sample buffer does)
            while chunk:
                u, v, logl = chunk.pop(0)
                if logl > Lmin:
                    break
            else:
                u, v, logl, nc = sampler.__next__(
                    region, Lmin, us, Ls, transform, multi_loglike)
                if i > nwarmup:
                    ncalls += nc
                if logl is None:
                    continue
                if np.ndim(logl) == 1:
                    # chunked handoff (fused samplers): queue the rows
                    chunk.extend(zip(u, v, logl))
                    continue
                break
            break
        if i >= nwarmup:
            Lsequence.append(Lmin)
            stepsequence.append(quantify_step(ustart, u))
        us[j] = u
        Ls[j] = logl
        region.u[j] = u
        region.unormed[j] = region.transformLayer.transform(u)

    return np.asarray(Lsequence), ncalls, np.array(stepsequence)


def shrinkage_diagnostic(Lsequence, volume, ndim, nlive):
    """Measured shrinkage CDF values; should be Uniform(0,1)."""
    vol = np.asarray([volume(L, ndim) for L in Lsequence])
    finite = np.isfinite(vol)
    vol = vol[finite]
    shrinkage = 1 - (vol[1:] / vol[:-1]) ** (1.0 / ndim)
    shrinkage = shrinkage[shrinkage >= 0]
    cdf_expected = 1 - (1 - shrinkage) ** (ndim * nlive)
    return shrinkage, cdf_expected


def make_sampler(name, ndim, nsteps):
    """Instantiate a step sampler by short name."""
    from ultranest_torch import popstepsampler, stepsampler
    from ultranest_torch.ops import stepfuncs
    if name == 'mh':
        return stepsampler.CubeMHSampler(nsteps=nsteps, check_nsteps=False)
    if name == 'regionmh':
        return stepsampler.RegionMHSampler(nsteps=nsteps, check_nsteps=False)
    if name == 'cubeslice':
        return stepsampler.CubeSliceSampler(nsteps=nsteps, check_nsteps=False)
    if name == 'regionslice':
        return stepsampler.RegionSliceSampler(nsteps=nsteps,
                                              check_nsteps=False)
    if name == 'regionball':
        return stepsampler.RegionBallSliceSampler(nsteps=nsteps,
                                                  check_nsteps=False)
    if name == 'seqregionslice':
        return stepsampler.RegionSequentialSliceSampler(nsteps=nsteps,
                                                        check_nsteps=False)
    if name == 'popslice':
        return popstepsampler.PopulationSliceSampler(
            popsize=16, nsteps=nsteps,
            generate_direction=stepfuncs.generate_region_oriented_direction)
    if name == 'poprw':
        return popstepsampler.PopulationRandomWalkSampler(
            popsize=32, nsteps=nsteps,
            generate_direction=stepfuncs.generate_region_random_direction,
            scale=0.1)
    raise ValueError(name)


def main(argv=None, device='cuda'):
    """Parse *argv* (default ``sys.argv[1:]``) and run the harness;
    returns (mean shrinkage CDF, KS distance). ``--device`` overrides
    *device*."""
    parser = argparse.ArgumentParser()
    parser.add_argument('--problem', default='circgauss')
    parser.add_argument('--x_dim', type=int, default=2)
    parser.add_argument('--nlive', type=int, default=200)
    parser.add_argument('--nsteps', type=int, default=1000)
    parser.add_argument('--sampler', default='regionslice')
    parser.add_argument('--sampler_nsteps', type=int, default=None)
    parser.add_argument('--seed', type=int, default=1)
    parser.add_argument('--device', default=device)
    args = parser.parse_args(argv)

    ndim = args.x_dim
    sampler_nsteps = args.sampler_nsteps or 2 * ndim
    sampler = make_sampler(args.sampler, ndim, sampler_nsteps)
    loglike, grad, volume, warmup = get_problem(args.problem, ndim=ndim)

    Lsequence, ncalls, steps = evaluate_warmed_sampler(
        args.problem, ndim, args.nlive, args.nsteps, sampler, seed=args.seed,
        device=args.device)
    shrinkage, cdf = shrinkage_diagnostic(Lsequence, volume, ndim, args.nlive)

    print("%s on %s-%dd: ncalls=%d  mean shrinkage-CDF=%.4f "
          "(0.5 expected; <0.5: too slow, >0.5: overshrinking)" % (
              sampler, args.problem, ndim, ncalls, cdf.mean()))
    # Kolmogorov-Smirnov distance against uniformity
    cdf_sorted = np.sort(cdf)
    ks = np.abs(cdf_sorted - np.linspace(0, 1, len(cdf_sorted))).max()
    print("KS distance vs uniform: %.4f (n=%d)" % (ks, len(cdf)))
    return float(cdf.mean()), float(ks)


if __name__ == '__main__':
    main()
