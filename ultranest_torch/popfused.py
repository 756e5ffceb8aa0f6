# noqa: D400 D205
"""
Device-resident population samplers
-----------------------------------

Counterpart of ``ultranest_tpu/popfused.py``. A whole walker
population advances through all its steps in one dispatch, with the
batched likelihood called once per round on every walker's rows; one
dispatch yields ``popsize`` independent samples. Four walks:

* ``engine='spec'`` (:func:`spec_walk`): each round evaluates a
  depth-``spec_depth`` precomputed shrink chain per walker;
* ``engine='async'``: the same walk at depth 1, one candidate per
  walker per round, walkers at independent steps;
* ``engine='sync'`` (:func:`sync_walk`): all walkers in lockstep per
  step, a shrink loop per step;
* :class:`FusedPopulationRandomWalkSampler` (:func:`rwalk_walk`):
  Gaussian Metropolis steps in region-axes space.

The reference runs its shrink loops as ``lax.while_loop`` with the
condition on the device. Eager torch has no device-side loop, so here
the rounds are a host loop of torch ops (:func:`_drive`). The spec and
async walks read the loop's "done" flag once every
:data:`SPEC_CHECK_EVERY` rounds, through a pinned copy and a CUDA event,
one check behind the rounds already queued (the card never waits for
that read); a sync step reads its flag once every
:data:`SYNC_CHECK_EVERY` shrink iterations with no lag. Extra rounds
after the flag turned true are exact no-ops: every state update and
every billed count is masked by it. So the results are the reference's, bit
for bit in the integer outputs, and no round past the cap ever runs.

All randomness of a dispatch is drawn up front (``draw_*_banks``) from a
``torch.Generator`` on the sampler's device, seeded per dispatch from
the host PCG64 stream the reference draws its per-dispatch keys from.
The walks take those banks as inputs, so a test can feed them the
reference's own draws.

Each dispatch's billed and useful evaluation counts travel home as an
int64 pair beside the float32 result, so they stay exact past 2**24
(the reference rounds them to float32).

With ``mesh=`` (:mod:`ultranest_torch.parallel`) the population is
split over the mesh's shards (``popfused.py:473-498``, ``:1243-1292``):
each shard walks ``popsize / nshards`` walkers from its own stream, with
no collective inside the walk, so the done-flag reads stay on the shard;
the walkers' results are gathered, the counts summed and the width and
done fraction averaged over the shards. In segment mode every shard then
runs the consume scan (kernel K3) on the whole gathered batch, so the
live state stays the same on every rank.

The doubled-nsteps prewarm thread and the fingerprint-keyed kernel cache
have no counterpart: eager torch does not compile per shape.
"""

import logging
import math
import time

import numpy as np
import torch

from .fused import _as_f32, _f32, _inside_ellipsoid, tregion_geometry
from .ops.pairwise import pad_rows, round_up
from .ordertest import UniformOrderAccumulator
from .parallel import (all_gather_rows, check_mesh, pmean, psum,
                       shard_count, shard_index, shard_seed)
from .parallel.launch import finish_fetch, start_fetch
from .popstepsampler import (GenericPopulationSampler,
                             decorrelation_gm_target,
                             diagnose_move_distances,
                             reference_sqdistance_info)
from .segmentops import (consume_scan, pack_segment, whitened_cloud_var,
                         whitened_jump2)

__all__ = ['FusedPopulationSliceSampler', 'FusedPopulationRandomWalkSampler',
           'draw_spec_banks', 'draw_sync_banks', 'draw_rwalk_banks',
           'spec_walk', 'sync_walk', 'rwalk_walk', 'spec_max_rounds',
           'optimal_spec_depth', 'SPEC_CHECK_EVERY', 'SYNC_CHECK_EVERY',
           'ROUND_OVERHEAD_S']

# rounds between two host reads of a walk's "done" flag
SPEC_CHECK_EVERY = 8
# shrink iterations between two host reads of a sync step's flag, read
# with no lag: each step ends in a read anyway. On an NVIDIA H100 80GB
# HBM3 at a 700 W power limit, sync at d 8 (popsize 128, nsteps 16, 200
# live points) took 2.09-2.20 s at 2, 2.00-2.52 s at 4, 2.31-2.33 s at
# 1 and 3.70-4.15 s read every 8 one check behind, with equal results.
SYNC_CHECK_EVERY = 2
# Fixed cost of one spec-walk round on the card, the A of
# optimal_spec_depth: the host enqueue of the round's ~115 torch ops,
# which the device (idle ~90% of the time) never hides. Measured as the
# segment launch phase summed over the spec-walk bench problems
# (asymgauss50, rosenbrock8, multishell8, loggamma30, gauss100, as
# chip_smoke.py runs them) over their rounds: 97.43 s over 51 616
# rounds, 1.888 ms per round (1.68-2.36 ms per problem) on an NVIDIA
# H100 80GB HBM3 at a 700 W power limit. The reference's 350 us was
# taken on a TPU.
ROUND_OVERHEAD_S = 1.888e-3

_LOG = logging.getLogger('ultranest_torch.popfused')
# likelihood-cost probe results: (loglike, transform, popsize, x_dim,
# device) -> seconds per popsize-row batch
_PROBE_CACHE = {}


def optimal_spec_depth(t_row_s, dmax, round_overhead_s=ROUND_OVERHEAD_S,
                       p_accept=0.35, min_win=0.8):
    """Speculation depth minimizing device time per accepted slice step.

    The reference's model (``popfused.py:43-76``): one round costs
    ``A + D * t_row`` and completes a walker's step with probability
    ``1 - (1 - p)**D``, so the cost per completed step is::

        cost(D) = (A + D * t_row) / (1 - (1 - p)**D)

    A smaller depth than *dmax* is returned only when its modeled cost
    beats *dmax*'s by at least ``1/min_win``: near-ties keep the user's
    configuration. The default ``A`` is the port's measured round cost
    (:data:`ROUND_OVERHEAD_S`), not the reference's TPU figure.
    """
    q = 1.0 - p_accept
    cost = {d: (round_overhead_s + d * t_row_s) / (1.0 - q ** d)
            for d in range(1, int(dmax) + 1)}
    best = min(cost, key=cost.get)
    if best < dmax and cost[best] < min_win * cost[dmax]:
        return best
    return int(dmax)


def spec_max_rounds(nsteps, max_it, depth):
    """Round cap of one spec dispatch (``popfused.py:535``).

    Generous on purpose: walkers still unfinished at the cap are
    discarded, which wastes their chains and selects survivors by shrink
    speed.
    """
    return nsteps * max(4, (max_it + depth - 1) // depth)


def _step_draws(g, dev, nsteps, P, nlive, x_dim):
    """The direction draws of every step (``popfused.py:548-555``)."""
    return dict(
        i1=torch.randint(0, nlive, (nsteps, P), generator=g, device=dev),
        i2=torch.randint(0, max(nlive - 1, 1), (nsteps, P), generator=g,
                         device=dev),
        jx=torch.randint(0, x_dim, (nsteps, P), generator=g, device=dev),
        pick=torch.rand((nsteps, P), generator=g, device=dev))


def draw_spec_banks(generator, P, D, nsteps, max_rounds, nlive, x_dim):
    """All random draws of one spec (or async) dispatch.

    Returns a dict of raw draws on the generator's device, as the
    reference makes them (``popfused.py:547-558``, ``:736-747``) before
    any use:

    * ``xibank`` (max_rounds, P, D) float32 uniforms: the D speculative
      slice positions of every walker in each round (the async engine's
      ``tbank`` is the D = 1 case);
    * ``i1`` (nsteps, P) in [0, nlive) and ``i2`` (nsteps, P) in
      [0, nlive - 1): the differential-evolution pair of each step
      (the walk shifts ``i2 >= i1`` up by one);
    * ``jx`` (nsteps, P) in [0, x_dim): the region axis of each step;
    * ``pick`` (nsteps, P) float32 uniforms: below 0.5 picks the pair;
    * ``idx0`` (P,) in [0, nlive): each walker's start.
    """
    g, dev = generator, generator.device
    banks = dict(xibank=torch.rand((max_rounds, P, D), generator=g,
                                   device=dev))
    banks.update(_step_draws(g, dev, nsteps, P, nlive, x_dim))
    banks['idx0'] = torch.randint(0, nlive, (P,), generator=g, device=dev)
    return banks


def draw_sync_banks(generator, P, nsteps, max_it, nlive, x_dim):
    """All random draws of one sync dispatch (``popfused.py:821-863``).

    The step draws ``i1``, ``i2``, ``jx``, ``pick`` and ``idx0`` as in
    :func:`draw_spec_banks`, and ``tbank`` (nsteps, max_it, P) float32
    uniforms: the slice position of every walker in each shrink
    iteration of each step (the reference splits a key per iteration
    inside its loop).
    """
    g, dev = generator, generator.device
    banks = dict(tbank=torch.rand((nsteps, max_it, P), generator=g,
                                  device=dev))
    banks.update(_step_draws(g, dev, nsteps, P, nlive, x_dim))
    banks['idx0'] = torch.randint(0, nlive, (P,), generator=g, device=dev)
    return banks


def draw_rwalk_banks(generator, P, nsteps, nlive, x_dim):
    """All random draws of one random-walk dispatch (``popfused.py:1603-1608``).

    ``eps`` (nsteps, P, x_dim) standard normal proposal noise and
    ``idx0`` (P,) in [0, nlive), each walker's start.
    """
    g, dev = generator, generator.device
    return dict(
        eps=torch.randn((nsteps, P, x_dim), generator=g, device=dev),
        idx0=torch.randint(0, nlive, (P,), generator=g, device=dev))


def _direction_bank(banks, live_u, axes, scale):
    """(nsteps, P, d) direction of every walker's every step.

    A 50/50 mix of differential-evolution pairs and region axes, scaled
    (``popfused.py:549-556``).
    """
    i1 = banks['i1']
    i2 = torch.where(banks['i2'] >= i1, banks['i2'] + 1, banks['i2'])
    dirbank = torch.where((banks['pick'] < 0.5)[..., None],
                          live_u[i1] - live_u[i2], axes[banks['jx']])
    return dirbank.mul_(scale)


def _cube_intersection(u, v):
    """Line coordinates where rays u + t*v cross the unit cube faces.

    Where ``v == 0`` the divisions give inf or nan; both are masked to
    -inf / +inf before the reductions, so none reaches ``max``/``min``.
    """
    nz = v != 0
    a = torch.where(nz, (0.0 - u) / v, -math.inf)
    b = torch.where(nz, (1.0 - u) / v, math.inf)
    return torch.minimum(a, b).amax(dim=1), torch.maximum(a, b).amin(dim=1)


def _finish_flag(handle):
    """Wait for a :func:`~ultranest_torch.parallel.launch.start_fetch` of
    a 0-d bool tensor; returns a Python bool.

    The wait carries the dispatch deadline (raises
    :class:`~ultranest_torch.parallel.launch.DeviceLostError`): the walk
    blocks here before it reaches any result fetch.
    """
    return bool(finish_fetch(handle))


def _median(x):
    """``jnp.median`` of a 1-d tensor: the midpoint of the middle pair."""
    s = torch.sort(x).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def _drive(body, state, max_rounds, finished, every=1, lagged=False):
    """Host loop standing in for the reference's ``lax.while_loop``.

    Runs ``state = body(it, *state)`` for ``it = 0, 1, ...`` until the
    0-d bool tensor ``finished(state)`` reads True, or *max_rounds*
    rounds ran. The flag is read once every *every* rounds; with
    *lagged*, on a card, one check behind the rounds already queued, so
    the card never waits for the read. Unless *every* is 1 and *lagged*
    is false, rounds run past the flag and must be exact no-ops.

    Returns ``(state, reads, rounds)``: the blocking host reads made and
    the rounds run, no-op rounds included.
    """
    lag = 1 if lagged and state[0].device.type == 'cuda' else 0
    flags = []
    reads = 0
    it = 0
    while it < max_rounds:
        for _ in range(min(every, max_rounds - it)):
            state = body(it, *state)
            it += 1
        flags.append(start_fetch(finished(state)))
        if len(flags) > lag:
            reads += 1
            if _finish_flag(flags.pop(0)):
                break
    return state, reads, it


def spec_walk(banks, live_u, live_L, nlive, axes, Lmin, scale, evaluate,
              nsteps, target_done=None, stats=None):
    """Speculative-shrink population walk (``popfused.py:538-650``).

    A slice-shrink rejection updates the bracket without a likelihood
    value, so the next D candidate positions of every walker's shrink
    chain are known in advance and evaluated in ONE batched likelihood
    call per round; the first candidate above *Lmin* wins, and the
    accepted chain is exactly the sequential sampler's. At D = 1 this is
    the async engine's walk (``popfused.py:697-812``): one row per
    walker per round, shrinking on rejection.

    Parameters
    ----------
    banks: dict
        the raw draws of :func:`draw_spec_banks`; their shapes fix P, D
        and the round cap
    live_u, live_L: (npad, d), (npad,) float32
        live points (padded; indices in *banks* stay below *nlive*)
    nlive: int
    axes: (d, d) float32
        region principal axes, one per row
    Lmin: float or 0-d float32 tensor
        likelihood threshold
    scale: float
        slice length factor
    evaluate: function
        ``(rows) -> (L float32, billed bool or None)``: transform,
        optional p-space filter and likelihood of (n, d) rows
    nsteps: int
        slice steps per walker
    target_done: int or None
        walkers to finish before stopping (None: all). Below P every
        round's condition is read before the next round runs; otherwise
        once every :data:`SPEC_CHECK_EVERY` rounds.
    stats: dict or None
        if given, receives ``reads`` (blocking host reads of the flag)
        and ``rounds`` (rounds run, no-op rounds included)

    Returns
    -------
    uf, Lf, done, idx0, nc, nuseful, width: final points (P, d), their
    likelihoods, completion flags, start indices, billed and useful
    evaluation counts (0-d int64) and the mean slice width (0-d
    float32)
    """
    xibank = banks['xibank']
    max_rounds, P, D = xibank.shape
    dev = live_u.device
    if target_done is None:
        target_done = P
    dirbank = _direction_bank(banks, live_u, axes, scale)
    idx0 = banks['idx0']
    u = live_u[idx0]
    L = live_L[idx0]
    v = dirbank[0]
    tl, tr = _cube_intersection(u, v)
    step = torch.zeros(P, dtype=torch.int64, device=dev)
    done = torch.zeros(P, dtype=torch.bool, device=dev)
    widths = torch.zeros((), dtype=torch.float32, device=dev)
    nw = torch.zeros((), dtype=torch.int64, device=dev)
    ncr = torch.zeros((), dtype=torch.int64, device=dev)
    nur = torch.zeros((), dtype=torch.int64, device=dev)
    arD = torch.arange(D, device=dev)
    arP = torch.arange(P, device=dev)

    def round_body(it, u, L, v, tl, tr, step, done, widths, nw, ncr, nur):
        xi = xibank[it]
        # the speculative shrink chain: candidate j is drawn as if all
        # earlier ones were rejected
        tlc, trc = tl, tr
        ts = []
        for j in range(D):
            t = tlc + xi[:, j] * (trc - tlc)
            ts.append(t)
            tlc = torch.where(t < 0, t, tlc)
            trc = torch.where(t >= 0, t, trc)
        ts = torch.stack(ts, dim=1)                            # (P, D)
        up = u[:, None, :] + ts[..., None] * v[:, None, :]
        Lp, tin = evaluate(up.reshape(P * D, -1))
        Lp = Lp.reshape(P, D)
        active = ~done
        # billing: the walkers still working this round, rows the
        # p-space filter let through
        billed = active[:, None].expand(P, D) if tin is None \
            else tin.reshape(P, D) & active[:, None]
        ncr = ncr + billed.sum()
        hit = Lp > Lmin
        anyhit0 = hit.any(dim=1)
        anyhit = anyhit0 & active
        # first hit in chain order (D where there is none, then clamped;
        # rows without a hit do not use it)
        jstar = torch.where(hit, arD, D).amin(dim=1).clamp(max=D - 1)
        # useful work: a sequential sampler evaluates candidates
        # 0..jstar, or all D on a round without a hit
        kneed = torch.where(anyhit0, jstar + 1, D)
        nur = nur + ((arD[None, :] < kneed[:, None]) & billed).sum()
        tstar = ts.gather(1, jstar[:, None])[:, 0]
        Lstar = Lp.gather(1, jstar[:, None])[:, 0]
        u = torch.where(anyhit[:, None], u + tstar[:, None] * v, u)
        L = torch.where(anyhit, Lstar, L)
        step = step + anyhit
        widths = widths + torch.where(anyhit, tr - tl, 0.0).sum()
        nw = nw + anyhit.sum()
        done = done | (anyhit & (step >= nsteps))
        # no acceptance: keep the fully shrunk bracket
        rej = ~anyhit & ~done
        tl = torch.where(rej, tlc, tl)
        tr = torch.where(rej, trc, tr)
        # accepted and not done: the next pre-drawn direction and a
        # fresh full chord
        renew = anyhit & ~done
        vn = dirbank[step.clamp(0, nsteps - 1), arP]
        v = torch.where(renew[:, None], vn, v)
        tln, trn = _cube_intersection(u, v)
        tl = torch.where(renew, tln, tl)
        tr = torch.where(renew, trn, tr)
        return u, L, v, tl, tr, step, done, widths, nw, ncr, nur

    # Only with every walker required to finish are extra rounds no-ops
    # (every update is masked by ~done or anyhit)
    exact = target_done < P
    state, reads, rounds = _drive(
        round_body, (u, L, v, tl, tr, step, done, widths, nw, ncr, nur),
        max_rounds, lambda st: st[6].sum() >= target_done,
        every=1 if exact else SPEC_CHECK_EVERY, lagged=not exact)
    if stats is not None:
        stats.update(reads=reads, rounds=rounds)
    uf, Lf, _, tl, tr, step, done, widths, nw, ncr, nur = state
    width = widths / torch.clamp(nw, min=1)
    return uf, Lf, done, idx0, ncr, nur, width


def sync_walk(banks, live_u, live_L, axes, Lmin, scale, evaluate,
              stats=None):
    """Lockstep population walk (``popfused.py:814-877``).

    Every walker takes its step s before any takes step s + 1: per step,
    a direction and a full chord through the cube, then a shrink loop
    that evaluates one row per walker per iteration until every walker
    accepted or ``max_it`` iterations ran. Walkers that never accept
    keep their point. Every iteration bills all P rows the p-space
    filter lets through, finished walkers included, as the reference
    does. The host reads a step's flag once every
    :data:`SYNC_CHECK_EVERY` iterations, waiting for them: ``reads ==
    rounds // SYNC_CHECK_EVERY`` while that divides ``max_it``.

    *banks* are the draws of :func:`draw_sync_banks`; the other
    arguments are as for :func:`spec_walk`. Returns ``uf, Lf, done,
    idx0, nc, nuseful, width, acc_rate``: ``done`` all True,
    ``nuseful == nc`` (0-d int64; lockstep rounds evaluate no
    speculative rows), ``width`` the mean over steps of each step's
    median final bracket and ``acc_rate`` the mean over steps of the
    accepting fraction.
    """
    tbank = banks['tbank']
    nsteps, max_it, P = tbank.shape
    dev = live_u.device
    dirbank = _direction_bank(banks, live_u, axes, scale)
    idx0 = banks['idx0']
    u = live_u[idx0]
    L = live_L[idx0]
    nc = torch.zeros((), dtype=torch.int64, device=dev)
    acc_rates, widths = [], []
    reads = rounds = 0
    for s in range(nsteps):
        v = dirbank[s]
        tl, tr = _cube_intersection(u, v)

        def shrink(it, tlc, trc, unew, Lnew, done, nc, t0=tbank[s], u=u,
                   v=v):
            # the reference's loop ends once every walker accepted; the
            # rounds past that point bill nothing and change nothing
            running = ~done.all()
            t = tlc + t0[it] * (trc - tlc)
            up = u + t[:, None] * v
            Lp, tin = evaluate(up)
            billed = P if tin is None else tin.sum()
            nc = nc + running * billed
            acc = (Lp > Lmin) & ~done
            unew = torch.where(acc[:, None], up, unew)
            Lnew = torch.where(acc, Lp, Lnew)
            done = done | acc
            rej = ~done
            tlc = torch.where(rej & (t < 0), t, tlc)
            trc = torch.where(rej & (t >= 0), t, trc)
            return tlc, trc, unew, Lnew, done, nc

        done = torch.zeros(P, dtype=torch.bool, device=dev)
        (tlf, trf, u, L, done, nc), r, n = _drive(
            shrink, (tl, tr, u, L, done, nc), max_it,
            lambda st: st[4].all(), every=SYNC_CHECK_EVERY)
        reads += r
        rounds += n
        acc_rates.append(done.to(torch.float32).mean())
        widths.append(_median(trf - tlf))
    if stats is not None:
        stats.update(reads=reads, rounds=rounds)
    done = torch.ones(P, dtype=torch.bool, device=dev)
    return (u, L, done, idx0, nc, nc, torch.stack(widths).mean(),
            torch.stack(acc_rates).mean())


def rwalk_walk(banks, live_u, live_L, axes, Lmin, scale, evaluate,
               stats=None):
    """Population Metropolis random walk (``popfused.py:1602-1631``).

    Each of the ``nsteps`` steps proposes ``u + scale * eps @ axes.T``
    for every walker (``eps`` from :func:`draw_rwalk_banks`) and accepts
    proposals inside the unit cube above *Lmin*. The loop has a fixed
    trip count, so the host reads nothing. The matmul runs in full
    float32 (TF32 stays off).

    Returns ``uf, Lf, done, idx0, nc, nuseful, acc_rate``: ``done`` all
    True, ``nuseful == nc`` (0-d int64; proposals outside the cube are
    not billed) and the acceptance rate (0-d float32).
    """
    eps = banks['eps']
    nsteps, P, _ = eps.shape
    dev = live_u.device
    idx0 = banks['idx0']
    u = live_u[idx0]
    L = live_L[idx0]
    nacc = torch.zeros((), dtype=torch.int64, device=dev)
    nc = torch.zeros((), dtype=torch.int64, device=dev)
    axes_t = axes.T
    for s in range(nsteps):
        up = u + scale * (eps[s] @ axes_t)
        inside = ((up > 0) & (up < 1)).all(dim=1)
        Lev, tin = evaluate(up)
        Lp = torch.where(inside, Lev, -math.inf)
        acc = inside & (Lp > Lmin)
        u = torch.where(acc[:, None], up, u)
        L = torch.where(acc, Lp, L)
        nacc = nacc + acc.sum()
        nc = nc + (inside if tin is None else inside & tin).sum()
    if stats is not None:
        stats.update(reads=0, rounds=nsteps)
    acc_rate = nacc.to(torch.float32) / float(P * nsteps)
    done = torch.ones(P, dtype=torch.bool, device=dev)
    return u, L, done, idx0, nc, nc, acc_rate


class FusedPopulationSliceSampler(GenericPopulationSampler):
    """Vectorized slice sampler running on one device.

    Per step, each walker draws a direction (50/50 mix of
    differential-evolution pairs and region principal axes), intersects
    it with the unit cube, and shrink-samples its slice until it finds a
    point above the threshold. All walkers and all steps run in one
    dispatch.

    Parameters
    ----------
    popsize: int
        number of walkers (= samples harvested per dispatch)
    nsteps: int
        steps per walker until a point counts as independent
    torch_loglike: function
        batched log-likelihood on torch tensors, (n, params) -> (n,)
    torch_transform: function or None
        batched prior transform on torch tensors
    scale: float
        slice length factor (1.0 with cube clipping is rigorous)
    max_it: int
        maximum shrink iterations per step (sets the round cap)
    scale_adapt_factor: float
        scale adaptation (1 disables); adapts towards
        final-interval ~ scale / adapt_slice_scale_target
    adapt_slice_scale_target: float
        targeted final interval ratio
    seed: int
        seed of the host stream the per-dispatch generator seeds come from
    engine: str
        'spec' (default, :func:`spec_walk`): each round evaluates a
        depth-``spec_depth`` precomputed shrink chain per walker in one
        batched call, fewest rounds;
        'async': walkers advance at independent steps, one likelihood
        row per walker per round, fewest evaluations (the spec walk at
        depth 1);
        'sync' (:func:`sync_walk`): all walkers in lockstep per step.
    harvest_frac: float
        spec and async engines: end the dispatch when this fraction of
        walkers completed their chains. Values below 1.0 bias logZ (the
        reference's warning) and exclude segment mode.
    spec_depth: int
        candidates per walker per round of the spec engine
    adaptive_nsteps: bool
        govern the chain length online from the jump-distance and
        insertion-rank diagnostics (see :meth:`_adapt_nsteps`,
        :meth:`observe_insertion_ranks`)
    max_nsteps: int
        adaptation ceiling
    spec_depth_auto: None or bool
        the likelihood-cost probe (:meth:`_resolve_spec_depth`) that may
        lower ``spec_depth`` once, before the first dispatch, when the
        likelihood is expensive enough; None runs it on a CUDA device
        only, True and False force it on or off
    mesh: DeviceMesh or None
        split the walkers over this mesh's shards (see the module
        docstring); *popsize* must be a multiple of the shard count
    axis_name: str, tuple or None
        shard over these mesh dimensions only (default: all of them)
    device: str or torch.device
        where the walk and the live set of segment mode live
    """

    ENGINES = ('spec', 'async', 'sync')
    # rows handed to the integrator per __next__ call
    HANDOFF_CHUNK = 64
    # GM relative jump must reach this fraction of the decorrelated
    # target before the governor stops growing (reference
    # popfused.py:1031-1041, calibrated there on TPU runs)
    RELJUMP_MARGIN = 0.96

    segment_capable = True
    # the p-space WrappingEllipsoid filter is fused into the walk, so
    # non-affine transforms keep the segment fast path
    segment_tregion_ok = True

    def __init__(self, popsize, nsteps, torch_loglike, torch_transform=None,
                 scale=1.0, max_it=64, scale_adapt_factor=1.0,
                 adapt_slice_scale_target=2.0, seed=0, logfile=None,
                 engine='spec', harvest_frac=1.0, spec_depth=8, mesh=None,
                 axis_name=None, adaptive_nsteps=False, max_nsteps=1000,
                 spec_depth_auto=None, device='cuda'):
        if engine not in self.ENGINES:
            raise ValueError('engine must be one of %s, not %r'
                             % (self.ENGINES, engine))
        check_mesh(mesh, axis_name)
        self.nshards = shard_count(mesh, axis_name)
        if popsize % self.nshards:
            raise ValueError('popsize %d must divide evenly over the %d '
                             'mesh shards' % (popsize, self.nshards))
        self._shard = shard_index(mesh, axis_name)
        # walkers of this shard
        self._local_popsize = popsize // self.nshards
        self.popsize = popsize
        self.nsteps = nsteps
        self.nsteps_min = nsteps
        self.adaptive_nsteps = adaptive_nsteps
        self.max_nsteps = max_nsteps
        self._nsteps_grew = False
        self._gm_low_streak = 0
        self._gm_grace = 0
        # second growth signal: insertion-rank uniformity, fed by the
        # integrator (observe_insertion_ranks)
        self._mww_acc = UniformOrderAccumulator()
        self._mww_window = max(1024, popsize)
        self._mww_zthreshold = 4.0
        self.engine = engine
        self.harvest_frac = harvest_frac
        self.spec_depth = spec_depth
        self.spec_depth_auto = spec_depth_auto
        self._depth_resolved = False
        self._pending = None
        self._last_yield = 0
        self._buf = None
        self._buf_i = 0
        self._buf_sufmax = None
        self.torch_loglike = torch_loglike
        # every constructor argument is kept under its own name, as given,
        # so that a clone by constructor introspection (the calibrator's)
        # equals its prototype
        self.torch_transform = torch_transform
        self._transform = torch_transform if torch_transform is not None \
            else (lambda u: u)
        self.seed = seed
        self.mesh = mesh
        self.axis_name = axis_name
        self.scale = float(scale)
        self.max_it = max_it
        self.scale_adapt_factor = scale_adapt_factor
        self.adapt_slice_scale_target = adapt_slice_scale_target
        self.device = torch.device(device)
        # per-dispatch generator seeds from a host stream, as the
        # reference's per-dispatch keys (popfused.py:221-224)
        self._key_rng = np.random.Generator(np.random.PCG64(seed))
        self._gen = torch.Generator(device=self.device)
        self.logfile = logfile
        self.ncalls = 0
        # evaluations a strictly sequential sampler would have needed
        # for the same accepted chains (ncalls minus speculative waste)
        self.ncalls_useful = 0
        self.nrejects = 0
        self.discarded = 0
        self.logstat = []
        self.logstat_labels = ['accept_rate', 'efficiency', 'scale',
                               'nsteps', 'far_enough', 'mean_rel_jump']
        # (has_tregion, num_params): whether the walk fuses the p-space
        # wrapping-ellipsoid filter
        self._treg_key = (False, 0)
        # nsteps, host reads and rounds of every walk, in dispatch order
        self.walk_log = []

    def __str__(self):
        """Return string representation."""
        return 'FusedPopulationSliceSampler(popsize=%d, nsteps=%d, scale=%g)' \
            % (self.popsize, self.nsteps, self.scale)

    def _seed_dispatch(self):
        """Seed the generator from the next host key (two uint32 words),
        on a mesh mixed with this shard's index (the reference's
        ``fold_in``, ``popfused.py:490``)."""
        k = self._key_rng.integers(0, 2**32, size=2, dtype=np.uint32)
        self._gen.manual_seed(
            ((int(k[0]) << 32) | int(k[1])) & (2**63 - 1)
            if self.nshards == 1 else shard_seed(k, self._shard))

    def region_changed(self, Ls, region):
        """React to a region rebuild (no-op; state is per-dispatch)."""
        pass

    def _buf_remaining(self):
        return 0 if self._buf is None else len(self._buf[2]) - self._buf_i

    def needs_live_points(self, Lmin):
        """Whether the next ``__next__`` call may dispatch a population.

        Serving from the buffer is guaranteed when some remaining
        buffered point exceeds *Lmin* (tracked as a suffix maximum), no
        prefetch is due, and a dispatch is already in flight or not
        needed.
        """
        n = self._buf_remaining()
        if n == 0:
            return True
        if self._pending is None and \
                n <= max(1, int(0.3 * self._last_yield)):
            return True
        return not (self._buf_sufmax[self._buf_i] > Lmin)

    def _treg_eval(self):
        """Batch evaluator fusing the p-space wrapping-ellipsoid filter.

        Returns ``ev(u_rows, treg) -> (L, billed)``: transforms, tests
        membership in the packed WrappingEllipsoid when one is
        configured, and evaluates the likelihood. Rows outside the
        ellipsoid get L = -inf (a rejection) and are not billed; without
        an ellipsoid ``billed`` is None (every row billed).
        """
        loglike = self.torch_loglike
        transform = self._transform
        has_tregion, p = self._treg_key
        if not has_tregion:
            def ev(u_rows, treg):
                return loglike(transform(u_rows)).to(torch.float32), None
            return ev

        def ev(u_rows, treg):
            v = transform(u_rows)
            tin = _inside_ellipsoid(v, treg[:p],
                                    treg[p:p + p * p].reshape(p, p), treg[-1])
            return torch.where(tin, loglike(v).to(torch.float32),
                               -math.inf), tin
        return ev

    def _pack_whiten(self, region):
        """(d+1, d) f32 pack: whitening matrix + wrapped-dim mask row.

        Feeds :func:`segmentops.whitened_jump2`. T is
        ``transformLayer.T`` where the layer is affine, else
        ``diag(1/std)`` (ScalingLayer); saturating f32 cast.
        """
        layer = region.transformLayer
        d = self._seg_ndim
        T = getattr(layer, 'T', None)
        if T is None or np.ndim(T) != 2:
            std = np.asarray(
                getattr(layer, 'std', 1.0), np.float64).reshape(-1)
            if std.size != d:
                std = np.full(d, std[0] if std.size else 1.0)
            T = np.diag(1.0 / np.maximum(std, 1e-300))
        wmask = np.zeros((1, d), np.float32)
        wdims = getattr(layer, 'wrapped_dims', None)
        if wdims is not None and len(wdims):
            wmask[0, np.asarray(wdims, dtype=int)] = 1.0
        return np.vstack([_as_f32(T), wmask])

    def _pack_tregion(self, tregion):
        """Flat f32 vector [ctr(p), invcov(p,p), enlarge] (or a dummy)."""
        if tregion is None:
            return np.zeros(1, np.float32)
        p = tregion.u.shape[1]
        ctr, invcov, enlarge = tregion_geometry(tregion, p)
        return np.concatenate([
            ctr.ravel(), invcov.ravel(),
            np.asarray([enlarge], np.float32)]).astype(np.float32)

    def _sync_treg_key(self, tregion):
        """Track whether the walk fuses the p-space filter, and for p."""
        self._treg_key = (tregion is not None,
                          tregion.u.shape[1] if tregion is not None else 0)

    def _upload(self, *arrays):
        """Move float32 host arrays to the device in ONE copy; views back."""
        flat = np.concatenate([np.asarray(a, np.float32).ravel()
                               for a in arrays])
        packed = torch.as_tensor(flat).to(self.device, non_blocking=True)
        out, off = [], 0
        for a in arrays:
            a = np.asarray(a)
            out.append(packed[off:off + a.size].view(a.shape))
            off += a.size
        return out

    @staticmethod
    def _region_axes(region):
        axes = np.asarray(region.transformLayer.axes, np.float32)
        return np.diag(axes) if axes.ndim == 1 else axes

    # --- the likelihood-cost probe ---------------------------------------

    def _probe_likelihood_cost(self, x_dim):
        """Warm device cost of the likelihood per (popsize, x_dim) batch.

        Times one call of the transform and likelihood on the rows a
        spec round evaluates at the configured depth (popsize x
        spec_depth), the best of three after a warm-up call, and divides
        by the depth: CUDA events on a card, the host clock on the CPU.
        Returns seconds. The reference instead times ``reps`` popsize-row
        batches in one jitted loop and subtracts a null dispatch's
        latency; here a spec round's rows go in one call, so their
        batch's cost is the one a round pays, and the events also hold
        any wait of the card for the host's enqueue of the likelihood's
        ops (ROADMAP §C).
        """
        D = self.spec_depth
        ll, tr = self.torch_loglike, self._transform
        u = torch.full((self._local_popsize * D, x_dim), 0.5,
                       dtype=torch.float32, device=self.device)
        on_card = self.device.type == 'cuda'
        best = math.inf
        for i in range(4):
            if on_card:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                ll(tr(u))
                end.record()
                end.synchronize()
                t = start.elapsed_time(end) * 1e-3
            else:
                t0 = time.perf_counter()
                ll(tr(u))
                t = time.perf_counter() - t0
            if i:               # the first call warms caches and allocator
                best = min(best, t)
        return best / D

    def _resolve_spec_depth(self, x_dim):
        """One-time auto-tune of ``spec_depth`` before the first dispatch.

        Probes the likelihood's per-batch device cost and lowers the
        speculation depth when the billed extra rows cost more than the
        rounds they save (:func:`optimal_spec_depth`,
        ``popfused.py:408-451``). The probe runs once per (likelihood,
        transform, popsize, x_dim, device) in a process.
        """
        if self._depth_resolved:
            return
        self._depth_resolved = True
        auto = self.spec_depth_auto
        if auto is None:
            auto = self.device.type == 'cuda'
        if not auto or self.engine != 'spec' or self.spec_depth <= 1:
            return
        memo = (self.torch_loglike, self.torch_transform, self.popsize,
                x_dim, self.spec_depth, self.device)
        t_row = _PROBE_CACHE.get(memo)
        if t_row is None:
            try:
                t_row = self._probe_likelihood_cost(x_dim)
            except Exception:
                # an unprobeable likelihood keeps the configured depth
                _LOG.warning('spec_depth probe failed; keeping depth %d',
                             self.spec_depth, exc_info=True)
                return
            _PROBE_CACHE[memo] = t_row
        d = optimal_spec_depth(t_row, self.spec_depth)
        if d < self.spec_depth:
            _LOG.info('spec_depth auto-tuned %d -> %d (likelihood batch '
                      'cost %.3f ms)', self.spec_depth, d, 1e3 * t_row)
            if self.logfile:
                self.logfile.write('spec-depth\t%d\t%d\t%g\n'
                                   % (self.spec_depth, d, t_row))
            self.spec_depth = d

    # --- the walks ----------------------------------------------------------

    def _draw_banks(self, nlive, x_dim, segment=True):
        """Seed the generator and draw one dispatch's banks.

        The async engine's classic walk caps its rounds at ``max_it *
        nsteps`` (``popfused.py:721``); in segment mode it is the spec
        walk at depth 1 with the spec cap (``popfused.py:1236-1241``).
        """
        self._seed_dispatch()
        P, n, g = self._local_popsize, self.nsteps, self._gen
        if self.engine == 'sync':
            return draw_sync_banks(g, P, n, self.max_it, nlive, x_dim)
        D = 1 if self.engine == 'async' else self.spec_depth
        max_rounds = self.max_it * n if self.engine == 'async' \
            and not segment else spec_max_rounds(n, self.max_it, D)
        return draw_spec_banks(g, P, D, n, max_rounds, nlive, x_dim)

    def _walk(self, banks, live_u, live_L, nlive, axes, Lmin, scale, treg):
        """This engine's walk with this sampler's evaluator and settings.

        Returns ``uf, Lf, done, idx0, nc, nuseful, width, efficiency``:
        the walk-only convention of the reference's segment kernels
        (``popfused.py:1187-1201``) and the classic harvest's efficiency
        slot (the done fraction; sync: the mean accepting fraction).
        """
        ev = self._treg_eval()
        stats = dict(nsteps=self.nsteps)
        self.walk_log.append(stats)

        def evaluate(rows):
            return ev(rows, treg)
        if self.engine == 'sync':
            return sync_walk(banks, live_u, live_L, axes, Lmin, _f32(scale),
                             evaluate, stats=stats)
        target = max(1, int(np.ceil(self.harvest_frac
                                    * self._local_popsize)))
        out = spec_walk(banks, live_u, live_L, nlive, axes, Lmin,
                        _f32(scale), evaluate, self.nsteps,
                        target_done=target, stats=stats)
        return out + (out[2].to(torch.float32).mean(),)

    def _run_segment(self, banks, live_u, live_L, nlive, axes, scale, treg,
                     tpack):
        """Walk + on-device consumption (``popfused.py:1203-1234``).

        Each chain's whitened squared travel distance (end vs the
        ``live_u[idx0]`` start, read before the consume scan changes the
        live set) travels home as one trailing record column. Returns
        the new live state, the packed records and the exact int64
        (billed, useful) counts.

        On a mesh (``popfused.py:1243-1292``) *banks* are this shard's;
        the walkers' rows [uf | Lf | done | jump2] are gathered, the
        counts summed, the width and done fraction averaged, and the
        consume scan runs on the whole gathered batch on every shard.
        """
        Lmin0 = live_L.min()          # padding is +inf
        uf, Lf, done, idx0, nc, nu, width, _ = self._walk(
            banks, live_u, live_L, nlive, axes, Lmin0, scale, treg)
        jump2 = whitened_jump2(live_u[idx0], uf, tpack)
        # decorrelation normalizer from the live cloud the chains
        # actually walked in (the host region snapshot is up to
        # queue-depth segments stale)
        ref2 = whitened_cloud_var(live_u, nlive, tpack)
        donef = done.to(torch.float32)
        counts = torch.stack([nc, nu])
        done_frac = donef.mean()
        if self.nshards > 1:
            d = uf.shape[1]
            rows = all_gather_rows(
                torch.cat([uf, Lf[:, None], donef[:, None], jump2[:, None]],
                          dim=1), self.mesh, self.axis_name)
            uf, jump2 = rows[:, :d], rows[:, d + 2]
            Lf, donef = rows[:, d].contiguous(), rows[:, d + 1].contiguous()
            counts = psum(counts, self.mesh, self.axis_name)
            width, done_frac = pmean(torch.stack([width, done_frac]),
                                     self.mesh, self.axis_name)
        live_u2, live_L2, recs = consume_scan(live_u, live_L, uf, Lf, donef)
        recs = torch.cat([recs, jump2[:, None]], dim=1)
        packed = pack_segment(uf, Lf, recs, counts[0].to(torch.float32),
                              done_frac, width,
                              nuseful=counts[1].to(torch.float32), ref2=ref2)
        return live_u2, live_L2, packed, counts

    # --- classic mode ---------------------------------------------------

    def _launch(self, region, Lmin, us, Ls, tregion=None):
        """Run one population walk; returns a pending handle.

        The result streams home (:func:`parallel.launch.start_fetch`)
        while the integrator consumes the current buffer.
        """
        nlive, ndim = us.shape
        self._resolve_spec_depth(ndim)
        npad = round_up(nlive)
        self._sync_treg_key(tregion)
        live_u, live_L, axes, treg = self._upload(
            pad_rows(np.asarray(us, np.float32), npad),
            pad_rows(np.asarray(Ls, np.float32), npad, fill=-np.inf),
            self._region_axes(region), self._pack_tregion(tregion))
        banks = self._draw_banks(nlive, ndim, segment=False)
        uf, Lf, done, idx0, nc, nu, width, eff = self._walk(
            banks, live_u, live_L, nlive, axes, _f32(Lmin), self.scale, treg)
        donef = done.to(torch.float32)
        rows = torch.cat([uf, Lf[:, None], donef[:, None],
                          idx0[:, None].to(torch.float32)], dim=1)
        scalars = torch.zeros((1, ndim + 3), dtype=torch.float32,
                              device=self.device)
        scalars[0, :4] = torch.stack([nc.to(torch.float32), eff, width,
                                      nu.to(torch.float32)])
        packed = torch.cat([rows, scalars])
        counts = torch.stack([nc, nu])
        if self.nshards > 1:
            # each shard's walkers and its scalar row (popfused.py:473-498)
            packed = all_gather_rows(packed, self.mesh, self.axis_name)
            counts = psum(counts, self.mesh, self.axis_name)
        return (start_fetch(packed), start_fetch(counts),
                np.array(us, np.float32, copy=True), self.nsteps)

    def _harvest(self, region, transform, loglike, Lmin):
        """Fetch the pending dispatch and fill the sample buffer.

        The selected points are re-evaluated on the host in f64 before
        entering the tree; points at or below the *current* Lmin (which
        may have risen since launch) are discarded here.
        """
        handle, counts, us, at_nsteps = self._pending
        self._pending = None
        nlive, ndim = us.shape
        packed = finish_fetch(handle).astype(float)
        nc, nu = (int(c) for c in finish_fetch(counts))
        # column layout: [u(0:d), L, done, idx0]; one trailing scalar
        # row per shard: [ncall, efficiency, width, nuseful] (counts
        # rounded to float32; the exact sums come in *counts*); the
        # shards' efficiency and width are averaged (popfused.py:956-963)
        blocks = packed.reshape(self.nshards, -1, packed.shape[1])
        rows = blocks[:, :-1].reshape(-1, packed.shape[1])
        acc_rate = blocks[:, -1, 1].mean()
        width = blocks[:, -1, 2].mean()
        done = rows[:, ndim + 1] > 0.5
        uf = rows[:, :ndim][done]
        idx0 = rows[:, ndim + 2][done].astype(int)
        self.ncalls += nc
        self.ncalls_useful += nu
        np.clip(uf, 1e-7, 1 - 1e-7, out=uf)
        # f64 re-evaluation before the points enter the tree
        pf = transform(uf)
        Lf64 = loglike(pf)
        ok = Lf64 > Lmin
        self.nrejects += int((~ok).sum())
        if len(ok) >= 32 and ok.mean() < 0.05 and \
                not getattr(self, '_warned_mismatch', False):
            self._warned_mismatch = True
            import warnings
            warnings.warn(
                'f64 re-evaluation rejects %.0f%% of device-accepted '
                'points: torch_loglike/torch_transform probably do not '
                'match the host loglike/transform (did you forget '
                'torch_transform?)' % (100 * (1 - ok.mean())))

        far_enough, (move_distance, reference_distance) = \
            diagnose_move_distances(region, us[idx0[ok] % nlive, :],
                                    uf[ok])
        _, cloud_ref = reference_sqdistance_info(region)
        gm_target = decorrelation_gm_target(uf.shape[1]) \
            if cloud_ref else None
        L_ok = Lf64[ok]
        self._buf = (uf[ok], pf[ok], L_ok)
        self._buf_i = 0
        self._buf_sufmax = np.maximum.accumulate(L_ok[::-1])[::-1] \
            if len(L_ok) else L_ok
        self._last_yield = max(len(L_ok), 1)
        self.logstat.append([
            float(ok.mean()) if len(ok) else 0.0,
            float(acc_rate),
            self.scale,
            float(at_nsteps),
            float(np.mean(far_enough)) if len(far_enough) else 0.0,
            float(np.exp(np.mean(np.log(
                move_distance / reference_distance + 1e-10))))
            if len(far_enough) else 0.0,
        ])
        if self.logfile:
            self.logfile.write("rescale\t%.4f\t%.4f\t%g\t%d\t%.4f\t%g\n"
                               % tuple(self.logstat[-1]))

        self._adapt_scale(width)
        self._adapt_nsteps(self.logstat[-1][-2], len(far_enough), at_nsteps,
                           rel_jump_gm=self.logstat[-1][-1],
                           gm_target=gm_target)
        return nc

    def _adapt_scale(self, width):
        """Adapt the slice length guess from the final interval width."""
        if self.scale_adapt_factor != 1.0:
            if width >= self.scale / self.adapt_slice_scale_target:
                self.scale /= self.scale_adapt_factor
            else:
                self.scale *= self.scale_adapt_factor

    def _adapt_nsteps(self, far_frac, nchains, at_nsteps,
                      rel_jump_gm=None, gm_target=None):
        """Govern the chain length from the jump-distance diagnostics.

        One decision per dispatch (``popfused.py:1043-1097``): nsteps
        doubles when fewer than half the chains travelled the
        decorrelation scale, or when the GM relative jump stays below
        ``RELJUMP_MARGIN * gm_target`` for two dispatches (after a grace
        of two dispatches following a growth); it decays gently when the
        chains are comfortably decorrelated and never grew. Records from
        dispatches launched at another nsteps are ignored.
        """
        if not self.adaptive_nsteps or at_nsteps != self.nsteps \
                or nchains < 8:
            return
        gm_low = gm_target is not None and rel_jump_gm is not None \
            and rel_jump_gm < self.RELJUMP_MARGIN * gm_target
        if gm_low and self._gm_grace > 0:
            self._gm_grace -= 1
            self._gm_low_streak = 0
        else:
            self._gm_low_streak = self._gm_low_streak + 1 if gm_low else 0
            if not gm_low:
                self._gm_grace = 0
        if (far_frac < 0.5 or self._gm_low_streak >= 2) \
                and self.nsteps < self.max_nsteps:
            self._nsteps_grew = True
            self._gm_low_streak = 0
            self._gm_grace = 2
            self._set_nsteps(min(self.max_nsteps, self.nsteps * 2))
        elif far_frac > 0.9 and not gm_low \
                and self.nsteps > self.nsteps_min \
                and not self._nsteps_grew:
            self._set_nsteps(max(self.nsteps_min,
                                 int(np.ceil(self.nsteps / 1.5))))

    def observe_insertion_ranks(self, ranks, nlive, rec_nsteps=None):
        """Grow nsteps when insertion ranks are detectably non-uniform.

        The second growth signal of the ``adaptive_nsteps`` governor
        (``popfused.py:1099-1141``): a 4-sigma MWW U-test detection over a
        popsize-scaled window of insertion ranks doubles nsteps.
        *rec_nsteps* is the chain length the feeding batch was launched
        at; batches from before a growth reset the accumulator instead.
        """
        if not self.adaptive_nsteps or nlive <= 1:
            return
        if rec_nsteps is not None and int(rec_nsteps) != self.nsteps:
            self._mww_acc.reset()
            return
        self._mww_acc.add_many(np.asarray(ranks), nlive)
        if self._mww_acc.N < self._mww_window:
            return
        zscore = self._mww_acc.zscore
        self._mww_acc.reset()
        if abs(zscore) > self._mww_zthreshold \
                and self.nsteps < self.max_nsteps:
            self._nsteps_grew = True
            self._gm_grace = 2
            if self.logfile:
                self.logfile.write("mww-alarm\t%.2f\n" % zscore)
            _LOG.info('adaptive nsteps: insertion-rank z=%.1f over %d ranks',
                      zscore, self._mww_window)
            self._set_nsteps(min(self.max_nsteps, self.nsteps * 2))

    def _set_nsteps(self, nsteps):
        """Change nsteps (the next dispatch draws its banks at it)."""
        if nsteps == self.nsteps:
            return
        _LOG.info('adaptive nsteps: %d -> %d', self.nsteps, nsteps)
        if self.logfile:
            self.logfile.write("adapt-nsteps\t%d\t%d\n"
                               % (self.nsteps, nsteps))
        self.nsteps = int(nsteps)

    # --- segment mode -------------------------------------------------
    # The integrator's segment fast path (integrator._explore_segments)
    # drives these instead of __next__: the live state lives on the
    # device and chains across dispatches, each dispatch also consuming
    # its harvest into the live set (kernel K3). The host receives one
    # packed record array per dispatch and replays it into the tree.

    def segment_ok(self):
        """Segment mode runs on every engine with harvest_frac 1.

        The async engine walks as the spec walk at depth 1; sync walks
        in the shared walk-only convention. Segment consumption bills
        every harvested row, so the dispatch must walk the whole
        population to completion.
        """
        return self.harvest_frac >= 1.0

    def segment_start(self, us, Ls, ndraw=None):
        """Upload the live set and reset the dispatch queue."""
        nlive, ndim = us.shape
        self._resolve_spec_depth(ndim)
        npad = round_up(nlive)
        self._seg_nlive = nlive
        self._seg_ndim = ndim
        self._seg_npad = npad
        lu = pad_rows(np.asarray(us, np.float32), npad)
        lL = pad_rows(np.asarray(Ls, np.float32), npad, fill=np.inf)
        self._seg_state = tuple(self._upload(lu, lL))
        self._seg_queue = []
        # device state supersedes any buffered classic-mode harvest
        self._buf = None
        self._buf_i = 0
        self._pending = None

    def segment_launch(self, region, tregion=None):
        """Run one chained walk+consume segment; its result streams home.

        Reads from the host only what the walk's flag reads need
        (:func:`_drive`; none for the random walk).
        """
        self._sync_treg_key(tregion)
        axes, treg, tpack = self._upload(
            self._region_axes(region), self._pack_tregion(tregion),
            self._pack_whiten(region))
        live_u, live_L = self._seg_state
        banks = self._draw_banks(self._seg_nlive, self._seg_ndim,
                                 segment=True)
        lu, lL, packed, counts = self._run_segment(
            banks, live_u, live_L, self._seg_nlive, axes, self.scale, treg,
            tpack)
        self._seg_state = (lu, lL)
        self._seg_queue.append((start_fetch(packed), start_fetch(counts),
                                self.nsteps, region))

    def segment_fetch(self):
        """Wait for the oldest queued segment; returns parsed records.

        Returns a dict with per-row arrays (in consumption order):
        ``u (P,d), L, accept, worst, Lmin, rank, plateau, dup,
        jump2 (P,)`` and the scalars ``nc`` (walk evaluations),
        ``done_frac``, ``width``, ``nc_useful``, ``ref2_dev`` and
        ``nsteps``. Also feeds the jump-distance diagnostics and the
        adaptive nsteps governor, as the classic-mode harvest does.
        """
        handle, counts, at_nsteps, region = self._seg_queue.pop(0)
        packed = finish_fetch(handle).astype(float)
        nc, nu = (int(c) for c in finish_fetch(counts))
        d = self._seg_ndim
        rows, scal = packed[:-1], packed[-1]
        # guard against f32 rounding onto the cube boundary (region
        # construction requires strictly interior points)
        np.clip(rows[:, :d], 1e-7, 1 - 1e-7, out=rows[:, :d])
        flags = rows[:, d + 5]
        rec = dict(
            u=rows[:, :d], L=rows[:, d],
            accept=rows[:, d + 1] > 0.5,
            worst=rows[:, d + 2].astype(np.int64),
            Lmin=rows[:, d + 3],
            rank=rows[:, d + 4].astype(np.int64),
            plateau=flags >= 2, dup=(flags % 2) >= 1,
            jump2=rows[:, d + 6],
            nc=nc, done_frac=float(scal[1]),
            width=float(scal[2]), nc_useful=nu,
            ref2_dev=float(scal[4]),
            nsteps=int(at_nsteps))
        self.ncalls += rec['nc']
        self.ncalls_useful += rec['nc_useful']
        self._adapt_scale(rec['width'])
        self._segment_diagnose(rec, at_nsteps, region)
        return rec

    def _segment_diagnose(self, rec, at_nsteps, region):
        """Jump-distance diagnostics + nsteps adaptation per dispatch.

        The whitened squared travel distance and the cloud-variance
        normalizer both arrive from the device (``rec['jump2']``,
        ``rec['ref2_dev']``): queued dispatches run ahead of the host's
        region snapshot, whose variance would read the GM relative jump
        low. The MLFriends ball-radius branch keeps the host scale.
        """
        acc = rec['accept']
        n = int(acc.sum())
        if n == 0 or region is None:
            return
        d2 = rec['jump2'][acc]
        ref2, cloud_ref = reference_sqdistance_info(region)
        if cloud_ref and rec.get('ref2_dev', 0.0) > 0.0:
            ref2 = rec['ref2_dev']
        far_frac = float(np.mean(d2 > ref2))
        rel_jump_gm = float(np.exp(np.mean(
            0.5 * np.log(d2 / ref2 + 1e-20))))
        self.logstat.append([
            float(np.mean(acc)),
            rec['done_frac'],
            self.scale,
            float(at_nsteps),
            far_frac,
            rel_jump_gm,
        ])
        if self.logfile:
            self.logfile.write("rescale\t%.4f\t%.4f\t%g\t%d\t%.4f\t%g\n"
                               % tuple(self.logstat[-1]))
        gm_target = decorrelation_gm_target(region.unormed.shape[1]) \
            if cloud_ref else None
        self._adapt_nsteps(far_frac, n, at_nsteps,
                           rel_jump_gm=rel_jump_gm, gm_target=gm_target)

    def segment_pending(self):
        """Number of dispatches in flight."""
        q = getattr(self, '_seg_queue', None)
        return len(q) if q else 0

    def segment_stop(self):
        """Leave segment mode, dropping device state and queued work."""
        self._seg_state = None
        self._seg_queue = None

    def __next__(self, region, Lmin, us, Ls, transform, loglike, ndraw=10,
                 plot=False, tregion=None, log=False):
        """Return the next prepared samples as a chunk (u, p, L, nc).

        Hands out up to ``HANDOFF_CHUNK`` buffered rows at once. Refills
        from the pending dispatch when the buffer runs out and, on a
        card, launches the next dispatch once the buffer is down to ~30%
        of the last harvest.
        """
        nc = 0
        if self._buf_remaining() == 0:
            if self._pending is None:
                assert us is not None, \
                    'refill needed but live points were not provided ' \
                    '(needs_live_points contract violated)'
                self._pending = self._launch(region, Lmin, us, Ls,
                                             tregion=tregion)
            nc = self._harvest(region, transform, loglike, Lmin)
            if self._buf_remaining() == 0:
                return None, None, None, nc
        if self._pending is None and us is not None and \
                self.device.type != 'cpu' and \
                self._buf_remaining() <= max(1, int(0.3 * self._last_yield)):
            self._pending = self._launch(region, Lmin, us, Ls,
                                         tregion=tregion)
        i = self._buf_i
        j = min(i + self.HANDOFF_CHUNK, len(self._buf[2]))
        self._buf_i = j
        bu, bp, bL = self._buf
        return bu[i:j], bp[i:j], bL[i:j], nc


class FusedPopulationRandomWalkSampler(FusedPopulationSliceSampler):
    """Device-resident population Metropolis random walk.

    Counterpart of ``ultranest_tpu.popfused.FusedPopulationRandomWalkSampler``
    (``popfused.py:1564-1671``): every walker performs ``nsteps``
    Gaussian steps in region-axes space (:func:`rwalk_walk`), accepting
    moves inside the unit cube above the likelihood threshold; the scale
    adapts towards a target acceptance rate between dispatches. The
    acceptance rate travels in the slice engine's width slot, so classic
    and segment mode, the prefetch and the f64 re-check are shared with
    the slice sampler.
    """

    ENGINES = ('rwalk',)

    def __init__(self, popsize, nsteps, torch_loglike, torch_transform=None,
                 scale=1.0, scale_adapt_factor=0.9, target_acceptance=0.234,
                 seed=0, logfile=None, mesh=None, axis_name=None,
                 adaptive_nsteps=False, max_nsteps=1000, device='cuda'):
        super().__init__(
            popsize, nsteps, torch_loglike, torch_transform=torch_transform,
            scale=scale, scale_adapt_factor=scale_adapt_factor, seed=seed,
            logfile=logfile, engine='rwalk', mesh=mesh, axis_name=axis_name,
            adaptive_nsteps=adaptive_nsteps, max_nsteps=max_nsteps,
            device=device)
        self.target_acceptance = target_acceptance

    def __str__(self):
        """Return string representation."""
        return ('FusedPopulationRandomWalkSampler(popsize=%d, nsteps=%d, '
                'scale=%g)' % (self.popsize, self.nsteps, self.scale))

    def _draw_banks(self, nlive, x_dim, segment=True):
        self._seed_dispatch()
        return draw_rwalk_banks(self._gen, self._local_popsize, self.nsteps,
                                nlive, x_dim)

    def _walk(self, banks, live_u, live_L, nlive, axes, Lmin, scale, treg):
        ev = self._treg_eval()
        stats = dict(nsteps=self.nsteps)
        self.walk_log.append(stats)
        out = rwalk_walk(banks, live_u, live_L, axes, Lmin, _f32(scale),
                         lambda rows: ev(rows, treg), stats=stats)
        # the acceptance rate fills both the width and efficiency slots
        return out + (out[-1],)

    def segment_ok(self):
        """The random walk always walks the full population."""
        return True

    def _adapt_scale(self, acceptance_rate):
        """Steer the proposal scale towards the target acceptance rate."""
        if self.scale_adapt_factor == 1.0:
            return
        if acceptance_rate < self.target_acceptance:
            self.scale *= self.scale_adapt_factor
        else:
            self.scale /= self.scale_adapt_factor
