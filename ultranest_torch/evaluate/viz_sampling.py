"""Visualize step-sampler trajectories on 2-d analytic problems, on the
PyTorch port.

Counterpart of ``evaluate/viz_sampling.py``: warm up a
region as in the shrinkage harness, then record and plot the chains each
step sampler produces while replacing the lowest-likelihood live point.
Produces ``viz_sampling_<problem>_<sampler>.pdf`` with the live points,
the region ellipsoid, and a handful of recorded chains over
iso-likelihood contours.

matplotlib is imported only by :func:`plot`. Usage::

    python -m ultranest_torch.evaluate.viz_sampling --problem circgauss \
        --sampler regionslice [--device cpu]
"""
import argparse

import numpy as np

from ..mlfriends import AffineLayer, MLFriends
from .evaluate_sampling import make_sampler
from .problems import get_problem, transform


def prepare(problemname, ndim, nlive, seed=1, device='cuda'):
    loglike, grad, volume, warmup = get_problem(problemname, ndim=ndim)
    np.random.seed(seed)
    us = np.array([warmup(ndim) for _ in range(nlive)])
    Ls = np.array([loglike(u) for u in us])
    layer = AffineLayer()
    layer.optimize(us, us)
    region = MLFriends(us, layer, device=device)
    region.maxradiussq, region.enlarge = region.compute_enlargement(
        nbootstraps=30)
    region.create_ellipsoid(minvol=1.0)
    return loglike, grad, us, Ls, region


def record_chains(sampler, loglike, grad, us, Ls, region, nchains=6):
    """Advance the sampler through *nchains* replacements, keeping chains."""
    if hasattr(sampler, 'set_gradient'):
        sampler.set_gradient(grad)
    sampler.region_changed(Ls, region)

    def multi_loglike(xs):
        return np.asarray([loglike(x) for x in xs])

    chains = []
    for _ in range(nchains):
        j = np.argmin(Ls)
        Lmin = float(Ls[j])
        chain = [us[j].copy()]
        while True:
            u, v, logl, nc = sampler.__next__(
                region, Lmin, us, Ls, transform, multi_loglike)
            if getattr(sampler, 'history', None):
                chain = [us[j].copy()] + [h[0] for h in sampler.history]
            if logl is not None:
                break
        chain.append(u.copy())
        chains.append(np.asarray(chain))
        us[j] = u
        Ls[j] = logl
        region.u[j] = u
        region.unormed[j] = region.transformLayer.transform(u)
    return chains


def plot(problemname, samplername, loglike, us, region, chains, filename):
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(6, 6))
    g = np.linspace(0, 1, 200)
    X, Y = np.meshgrid(g, g)
    Z = np.asarray([loglike(np.array([x, y]))
                    for x, y in zip(X.ravel(), Y.ravel())])
    ax.contour(X, Y, Z.reshape(X.shape), levels=12, cmap='Greys',
               linewidths=0.5)
    ax.plot(us[:, 0], us[:, 1], 'o', ms=2, color='navy', alpha=0.5,
            label='live points')
    for k, chain in enumerate(chains):
        ax.plot(chain[:, 0], chain[:, 1], '.-', lw=1, ms=3,
                label='chain %d (%d steps)' % (k, len(chain) - 1))
    ax.set(xlim=(0, 1), ylim=(0, 1), title='%s / %s'
           % (problemname, samplername))
    ax.legend(loc='best', fontsize=6)
    fig.savefig(filename, bbox_inches='tight')
    plt.close(fig)


def main(argv=None, device='cuda'):
    """Parse *argv* (default ``sys.argv[1:]``), record and plot the
    chains; returns the PDF's name. ``--device`` overrides *device*."""
    parser = argparse.ArgumentParser()
    parser.add_argument('--problem', default='circgauss')
    parser.add_argument('--sampler', default='regionslice')
    parser.add_argument('--nlive', type=int, default=200)
    parser.add_argument('--nsteps', type=int, default=16)
    parser.add_argument('--nchains', type=int, default=6)
    parser.add_argument('--seed', type=int, default=1)
    parser.add_argument('--device', default=device)
    args = parser.parse_args(argv)

    loglike, grad, us, Ls, region = prepare(args.problem, 2, args.nlive,
                                            args.seed, device=args.device)
    sampler = make_sampler(args.sampler, 2, args.nsteps)
    chains = record_chains(sampler, loglike, grad, us, Ls, region,
                           args.nchains)
    filename = 'viz_sampling_%s_%s.pdf' % (args.problem, args.sampler)
    plot(args.problem, args.sampler, loglike, us, region, chains, filename)
    print('wrote %s (%d chains, mean length %.1f)' % (
        filename, len(chains), np.mean([len(c) for c in chains])))
    return filename


if __name__ == '__main__':
    main()
