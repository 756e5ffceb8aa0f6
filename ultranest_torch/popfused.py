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

The reference runs its walks as device loops (``lax.while_loop`` and
``lax.scan``). Eager torch has no device-side loop. On a card every walk
runs as CUDA graphs (:class:`SpecGraphs`), its rounds hand kernels
around the user's likelihood:

* spec and async: a round is K4 ``kernels.spec_propose``, the
  likelihood and K5 ``kernels.spec_update``; a chunk of
  :data:`SPEC_CHECK_EVERY` rounds is one captured graph, replayed;
* sync: a round is one shrink iteration of every walker, K4 at depth 1,
  the likelihood and K6 ``kernels.sync_update``, which also ends a step
  where every walker accepted or ``max_it`` iterations ran; a chunk of
  :data:`SYNC_CHECK_EVERY` rounds, across step boundaries, is one graph;
* random walk: a step is ``torch.matmul`` of the noise and the region
  axes, the likelihood and K7 ``kernels.rwalk_accept``; the whole walk
  is one graph, replayed once.

On the CPU, and for a likelihood that cannot be captured, the same
rounds run from a host loop (:func:`_drive_walk`). The spec, async and
sync walks read the loop's "finished" flag once a chunk, through a
pinned copy and a CUDA event, one check behind the rounds already
queued (the card never waits for that read); the random walk has a
fixed trip count and reads nothing. Extra rounds after the flag turned
true are exact no-ops: every state update and every billed count is
masked by it. So the results are the reference's, bit for bit in the
integer outputs, and no round past the cap ever runs.

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

import collections
import functools
import logging
import math
import time
import warnings

import numpy as np
import torch

from . import tracing
from .fused import _as_f32, _f32, _inside_ellipsoid, tregion_geometry
from .ops import kernels
from .ops.kernels import cube_intersection as _cube_intersection
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
           'optimal_spec_depth', 'SpecGraphs', 'graph_call_seconds',
           'round_overhead', 'measure_round_overhead', 'SPEC_CHECK_EVERY',
           'SYNC_CHECK_EVERY', 'ROUND_OVERHEAD_S']

# rounds between two host reads of a walk's "done" flag
SPEC_CHECK_EVERY = 8
# rounds (shrink iterations of every walker, across step boundaries) in
# one graph of the sync walk, and between two host reads of its flag,
# read one chunk behind. On an NVIDIA H100 80GB HBM3 at a 700 W power
# limit (scripts/compare_walls.py --warm, two runs each, K6 as one kernel
# a round), sync at d 8 (popsize 128, nsteps 16, 200 live points) took
# 0.453/0.478 s at 2, 0.441/0.423 s at 4, 0.417/0.423 s at 8 and
# 0.390/0.438 s at 16; sync at d 2 (popsize 64, nsteps 8, 100 live)
# 0.155/0.137, 0.138/0.148, 0.129/0.135 and 0.128/0.135 s; equal results
# at every value. 8 and 16 tie; 16 queues 8% more no-op rounds.
SYNC_CHECK_EVERY = 8
# Fixed cost of one spec-walk round on the card without the likelihood,
# the A of optimal_spec_depth: K4, K5, the width sum and an eighth of the
# "finished" flag, replayed from a CUDA graph with the likelihood
# replaced by a constant on the device (round_overhead), measured by
# measure_round_overhead at the five spec-walk bench problems' shapes as
# chip_smoke.py runs them (asymgauss50 0.0145 ms, rosenbrock8 0.0084,
# multishell8 0.0084, loggamma30 0.0092, gauss100 0.0137), their mean,
# on an NVIDIA H100 80GB HBM3 at a 700 W power limit. The depth probe
# adds the likelihood's own fixed cost a call to it. The graph walk's
# launch phase over rounds, likelihood included, was 0.0978 ms before
# K4 and K5 were redesigned; the reference's 350 us was taken on a TPU.
ROUND_OVERHEAD_S = 1.0847e-5

_LOG = logging.getLogger('ultranest_torch.popfused')
# likelihood-cost probe results: (loglike, transform, popsize, x_dim,
# depth, device) -> _probe_likelihood_cost's dict
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


def _direction_bank(banks, live_u, axes, scale, out=None):
    """(nsteps, P, d) direction of every walker's every step.

    A 50/50 mix of differential-evolution pairs and region axes, scaled
    (``popfused.py:549-556``); written into *out* where given.
    """
    i1 = banks['i1']
    i2 = torch.where(banks['i2'] >= i1, banks['i2'] + 1, banks['i2'])
    dirbank = torch.where((banks['pick'] < 0.5)[..., None],
                          live_u[i1] - live_u[i2], axes[banks['jx']],
                          out=out)
    return dirbank.mul_(scale)


def _drive_rounds(run, max_rounds, every, lag):
    """Host loop standing in for the reference's ``lax.while_loop``:
    ``run(n)`` runs the next *n* rounds and returns the loop's 0-d bool
    "finished" flag.

    Runs *every* rounds (fewer at the cap) between two reads of the
    flag, *lag* reads behind, until a read gives True or *max_rounds*
    rounds ran. Unless *every* is 1 and *lag* 0, rounds run past the
    flag and must be exact no-ops. Returns ``(reads, rounds)``: the
    blocking host reads made and the rounds run, no-op rounds included.
    A read carries the dispatch deadline (raises
    :class:`~ultranest_torch.parallel.launch.DeviceLostError`): the walk
    blocks there before it reaches any result fetch.
    """
    flags = []
    reads = 0
    it = 0
    while it < max_rounds:
        n = min(every, max_rounds - it)
        flag = run(n)
        it += n
        # a CUDA flag is copied out; a CPU one may be rewritten in place
        flags.append(start_fetch(flag if flag.is_cuda else flag.clone()))
        if len(flags) > lag:
            reads += 1
            if bool(finish_fetch(flags.pop(0))):
                break
    return reads, it


def _f32_buffer(dev, *shape):
    return torch.zeros(shape, dtype=torch.float32, device=dev)


def _i64_buffer(dev, *shape):
    return torch.zeros(shape, dtype=torch.int64, device=dev)


def _set_scalar(buf, x):
    """Write float or 0-d tensor *x* into the 0-d buffer *buf*, on the
    device, without a host copy."""
    if torch.is_tensor(x):
        buf.copy_(x)
    else:
        buf.fill_(x)
    return buf


class _Walk:
    """A population walk's buffers, which stay put between dispatches:
    its banks, directions, threshold, :attr:`state` and 0-d bool
    "finished" :attr:`flag`; its captured graphs (rounds -> (graph,
    kernel launches of one replay)) and their memory pool.

    A subclass gives the walk's steps: its ``load`` copies a dispatch's
    inputs in (through this class's :meth:`load`), :meth:`init` starts
    the dispatch, ``round`` runs one round and :meth:`finished` writes
    the flag; and its round cap :attr:`max_rounds`, the rounds :attr:`every`
    between two reads of the flag (None: a fixed trip count, the flag
    unread) and whether the first round whose flag is up must be the
    last (:attr:`exact`). :func:`_drive_walk` runs the rounds.
    """

    every = None
    exact = False
    max_rounds = 1

    def __init__(self, flag):
        self.flag = flag
        self.graphs = {}
        self.pool = None
        self.state = {}
        self.start = {}

    def load(self, banks, live_u, live_L, Lmin, evaluate, v=None):
        """What every walk copies in: the threshold, the likelihood and
        the start, each walker at its live point ``idx0`` (``u``, ``L``)
        and, given its first direction *v*, on *v*'s full chord through
        the cube (``v``, ``tl``, ``tr``)."""
        idx0 = banks['idx0']
        self.start = dict(u=live_u[idx0], L=live_L[idx0])
        if v is not None:
            tl, tr = _cube_intersection(self.start['u'], v)
            self.start.update(v=v, tl=tl, tr=tr)
        _set_scalar(self.Lmin, Lmin)
        self.evaluate = evaluate

    def init(self):
        """Start a dispatch: the state's tensors named in :attr:`start`
        from there, the others zero."""
        for k, t in self.state.items():
            if k in self.start:
                t.copy_(self.start[k])
            else:
                t.zero_()

    def finished(self):
        """Write :attr:`flag` (a no-op where the round writes it)."""

    def run_rounds(self, n):
        """The next *n* rounds from the host; returns the flag."""
        for _ in range(n):
            self.round_body()
        self.finished()
        return self.flag

    def round_body(self):
        """A round run from the host (``evaluate.profile_run`` splits the
        host's time a round by this name)."""
        self.round()

    def replay_rounds(self, n, info):
        """The next *n* rounds as replays: a whole chunk's graph once, or
        below the cap the one-round graph *n* times. Each replay adds its
        graph's launches to ``kernels.LAUNCHES`` and counts in
        ``info['replays']``. Returns the flag."""
        chunk = self.every or self.max_rounds
        g, launched = self.graphs[n if n == chunk else 1]
        for _ in range(1 if n == chunk else n):
            g.replay()
            kernels.LAUNCHES.update(launched)
            info['replays'] += 1
        return self.flag


class SpecGraphs:
    """The population walks' rounds as CUDA graphs, captured once per
    shape: the spec and async walks' (:func:`spec_walk`), the sync
    walk's (:func:`sync_walk`) and the random walk's (:func:`rwalk_walk`).

    The reference runs a dispatch's rounds as one device loop. Here a
    chunk of rounds (spec: K4, the likelihood, K5 and the width sum,
    then the "finished" flag; sync: K4, the likelihood and K6, which
    writes the flag) is one captured graph, replayed between the host's
    flag reads; a one-round graph serves the rounds below the cap that a
    chunk would pass and the exact walk that reads every round. The
    random walk's whole dispatch is one graph. A graph reads and writes
    only buffers that stay put (the walk's :class:`_Walk`: the banks,
    the threshold, the state and the flag), so a dispatch copies its
    inputs in and replays. The caller's likelihood must read only
    tensors that stay put too: :meth:`static` keeps such copies.

    Entries are keyed by the walk and its shapes (spec: P, D, d, nsteps,
    the round cap and the finishing target; sync: P, d, nsteps and
    ``max_it``; random walk: P, d and nsteps), the device and
    :attr:`tag` (the caller's: the sampler puts its p-space filter's key
    and its likelihood there); the most recent :attr:`MAX_ENTRIES` are
    kept. A capture follows a warm-up round on a side stream, so that
    the likelihood's first-call work (cached constants) is done before
    it. A likelihood that cannot be captured (one that reads a value to
    the host or copies from host memory per call) makes the capture
    fail: :attr:`failed` keeps why, one warning names the likelihood,
    and the walks of this cache run their rounds from the host loop,
    with the same kernels.
    """

    MAX_ENTRIES = 4

    def __init__(self, name='likelihood'):
        self.name = name
        self.tag = ()
        self.failed = None
        self._entries = collections.OrderedDict()
        self._static = {}

    def static(self, name, t):
        """A buffer of *t*'s shape, dtype and device under *name*, that
        stays put between calls, holding a copy of *t*."""
        key = (name, tuple(t.shape), t.dtype, t.device)
        buf = self._static.get(key)
        if buf is None:
            buf = self._static[key] = torch.empty(
                t.shape, dtype=t.dtype, device=t.device)
        return buf.copy_(t)

    def entry(self, key, make):
        """The entry of *key*, made by ``make()`` where there is none."""
        e = self._entries.pop(key, None)
        if e is None:
            e = make()
        self._entries[key] = e
        while len(self._entries) > self.MAX_ENTRIES:
            self._entries.popitem(last=False)
        return e

    def capture(self, entry, sizes, body, flag):
        """Warm up one round on a side stream, then capture a graph of
        *n* rounds and the flag for each *n* in *sizes* into *entry* (a
        :class:`_Walk`). Returns the seconds it took, or None where the
        capture failed (then the stream and the allocator are as before,
        and :attr:`failed` says why). Booked as ``capture`` in the
        sampler's run in progress (:mod:`ultranest_torch.tracing`)."""
        with tracing.count('capture'):
            return self._capture(entry, sizes, body, flag)

    def _capture(self, entry, sizes, body, flag):
        t0 = time.perf_counter()
        dev = entry.flag.device
        if dev.type != 'cuda':
            raise ValueError('CUDA graphs need CUDA tensors, got %s' % dev)
        cur = torch.cuda.current_stream(dev)
        try:
            if entry.pool is None:
                entry.pool = torch.cuda.graph_pool_handle()
            side = torch.cuda.Stream(device=dev)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                body()
                flag()
            cur.wait_stream(side)
            torch.cuda.synchronize(dev)
            for n in sizes:
                g = torch.cuda.CUDAGraph()
                kernels.CAPTURED.clear()
                # a fresh stream per capture: a failed capture leaves
                # nothing behind on a stream that is used again
                cs = torch.cuda.Stream(device=dev)
                cs.wait_stream(cur)
                with torch.cuda.stream(cs):
                    g.capture_begin(pool=entry.pool)
                    try:
                        for _ in range(n):
                            body()
                        flag()
                    finally:
                        g.capture_end()
                cur.wait_stream(cs)
                entry.graphs[n] = (g, collections.Counter(kernels.CAPTURED))
        except Exception as exc:
            try:
                torch.cuda.synchronize(dev)
            except Exception:
                pass
            self.failed = '%s: %s' % (type(exc).__name__,
                                      str(exc).strip().splitlines()[0]
                                      if str(exc).strip() else '')
            msg = ('the likelihood %s cannot be captured in a CUDA graph '
                   '(%s); its walks run their rounds from the host loop, '
                   'with the same kernels' % (self.name, self.failed))
            _LOG.warning(msg)
            warnings.warn(msg, RuntimeWarning, stacklevel=3)
            return None
        return time.perf_counter() - t0


def _walk_of(graphs, key, make):
    """The walk of *key* from *graphs* (made by ``make()`` where it has
    none), or without *graphs* a fresh one."""
    if graphs is None:
        return make()
    return graphs.entry(key + (graphs.tag,), make)


def _drive_walk(walk, graphs):
    """Run the rounds of a loaded *walk* (:class:`_Walk`) from its start;
    returns the dispatch's stats: ``reads`` (blocking host reads of the
    flag), ``rounds`` (rounds run, no-op rounds included), ``graph``
    (whether the rounds ran as graphs), ``replays``, ``captures`` and
    ``capture_s`` (graphs captured in this call, and the seconds that
    took).

    In a segment dispatch the set-up is booked as the part ``load`` of
    the span in progress, the rounds as ``rounds`` (:func:`tracing.lap`).

    With *graphs* (a :class:`SpecGraphs` none of whose captures failed)
    the rounds run as replays of the walk's graphs, those it lacks
    captured first: a chunk of :attr:`_Walk.every` rounds and, where the
    round cap is no multiple of it, one round. Without, or where a
    capture fails, they run from the host, the same kernels on the same
    buffers: both give the same bits. The flag is read once a chunk
    (:func:`_drive_rounds`): where it is read on a card and the walk
    need not be exact, one read behind the rounds queued (the card never
    waits for that read), else at once.
    """
    info = dict(graph=False, replays=0, captures=0, capture_s=0.0)
    chunk = walk.every or walk.max_rounds
    sizes = [chunk] + ([1] if walk.max_rounds % chunk else [])
    graphed = graphs is not None and graphs.failed is None
    missing = [n for n in sizes if n not in walk.graphs] if graphed else []
    if missing:
        walk.init()
        took = graphs.capture(walk, missing, walk.round, walk.finished)
        graphed = took is not None
        if graphed:
            info.update(captures=len(missing), capture_s=took)
        else:
            walk.graphs.clear()
    walk.init()
    if graphed:
        info['graph'] = True
        run = functools.partial(walk.replay_rounds, info=info)
    else:
        run = walk.run_rounds
    tracing.lap('load')
    if walk.every is None:
        run(walk.max_rounds)
        reads, rounds = 0, walk.max_rounds
    else:
        lag = 1 if walk.flag.is_cuda and not walk.exact else 0
        reads, rounds = _drive_rounds(run, walk.max_rounds, walk.every, lag)
    tracing.lap('rounds')
    return dict(reads=reads, rounds=rounds, **info)


# spin cycles (torch.cuda._sleep) that keep the card busy while the host
# queues the replays a timing measures: about a millisecond on an H100
_SPIN_CYCLES = 2_000_000


def _replay_seconds(graph, dev, reps):
    """Device seconds of one replay of *graph*, its *reps* replays queued
    behind a spin kernel so that the card runs them back to back and the
    host's launches do not pace them."""
    cycles = _SPIN_CYCLES
    for _ in range(4):
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        behind = not start.query()
        end.synchronize()
        if behind:
            break
        cycles *= 4
    return start.elapsed_time(end) * 1e-3 / reps


def _eager_seconds(fn, on_card):
    """Seconds of one eager call of *fn*, the best of three after a
    warm-up call: CUDA events on a card, else the host clock."""
    best = math.inf
    for i in range(4):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            t = start.elapsed_time(end) * 1e-3
        else:
            t0 = time.perf_counter()
            fn()
            t = time.perf_counter() - t0
        if i:               # the first call warms caches and allocator
            best = min(best, t)
    return best


def graph_call_seconds(fn, device, calls=4, reps=8, trials=5, graphs=None):
    """Device seconds of one call of *fn* inside a CUDA graph, as a round
    replayed from the spec walk's graphs pays it.

    *calls* calls are captured in one graph by :meth:`SpecGraphs.capture`
    of *graphs* (a fresh cache if None): a warm-up call on a side stream
    first; where *fn* cannot be captured the cache's
    :attr:`SpecGraphs.failed` says why and None is returned. The graph's
    replays are timed on the card alone (queued behind a spin kernel),
    the best of *trials*.
    """
    dev = torch.device(device)
    graphs = graphs or SpecGraphs(getattr(fn, '__qualname__', repr(fn)))
    entry = _Walk(torch.zeros((), device=dev))
    if graphs.capture(entry, [calls], fn, lambda: None) is None:
        return None
    graph = entry.graphs[calls][0]
    return min(_replay_seconds(graph, dev, reps)
               for _ in range(trials)) / calls


def round_overhead(st, xibank, dirbank, Lmin, Lconst,
                   rounds=SPEC_CHECK_EVERY, trials=10):
    """Seconds of one spec-walk round without the likelihood: the A of
    :func:`optimal_spec_depth` (:data:`ROUND_OVERHEAD_S`).

    The round is the walk's (K4, the likelihood, K5 and the width sum,
    :func:`spec_walk`), with the likelihood replaced by *Lconst*, a
    (P*D,) float32 tensor that stays on the device: no likelihood kernel
    runs. On a card a chunk of *rounds* rounds and the "finished" flag
    is captured as the walk captures it (:class:`SpecGraphs`) and its
    replays are timed on the device alone, the best of *trials*, each
    from the state *st* as given; on the CPU the host clock times the
    same rounds run from the host. *st* (a :func:`spec_walk` state: the
    keys of :data:`kernels.SPEC_STATE` and ``widths``) is left as
    *rounds* real rounds whose likelihood gave *Lconst* leave it.
    """
    max_rounds, P, D = xibank.shape
    nsteps, _, d = dirbank.shape
    dev = st['u'].device
    walk = _SpecWalk(P, D, d, nsteps, max_rounds, P, dev)
    walk.xibank.copy_(xibank)
    walk.dirbank.copy_(dirbank)
    _set_scalar(walk.Lmin, Lmin)
    walk.evaluate = lambda rows: (Lconst, None)
    walk.start = st
    on_card = dev.type == 'cuda'
    if on_card:
        walk.init()
        graphs = SpecGraphs('a constant likelihood')
        if graphs.capture(walk, [rounds], walk.round, walk.finished) is None:
            raise RuntimeError('the round could not be captured: %s'
                               % graphs.failed)
    best = math.inf
    for _ in range(trials):
        walk.init()
        if on_card:
            t = _replay_seconds(walk.graphs[rounds][0], dev, 1)
        else:
            t0 = time.perf_counter()
            walk.run_rounds(rounds)
            t = time.perf_counter() - t0
        best = min(best, t)
    for k, t in walk.state.items():
        st[k].copy_(t)
    return best / rounds


def measure_round_overhead(P, D, d, nsteps, device='cuda', seed=0,
                           rounds=SPEC_CHECK_EVERY, trials=10):
    """:func:`round_overhead` at one shape, on a seeded state: walkers
    inside the cube on directions of scale 0.1 with their chords,
    *nsteps* steps of directions, and a constant likelihood a quarter of
    whose candidates beat the threshold (at D 8, nine walkers in ten
    accept in a round). Re-derive :data:`ROUND_OVERHEAD_S` with it after
    any change to the round body (``chip_smoke.py`` runs it at the spec
    problems' shapes). Returns seconds per round.
    """
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)
    walk = _SpecWalk(P, D, d, nsteps, rounds, P, dev)
    st = walk.state
    st['u'].copy_(0.05 + 0.9 * rand(P, d))
    st['v'].copy_(0.1 * randn(P, d))
    tl, tr = _cube_intersection(st['u'], st['v'])
    st['tl'].copy_(tl)
    st['tr'].copy_(tr)
    Lconst = randn(P * D)
    Lmin = torch.quantile(Lconst, 0.75)
    walk.xibank.copy_(rand(rounds, P, D))
    walk.dirbank.copy_(0.1 * randn(nsteps, P, d))
    return round_overhead(st, walk.xibank, walk.dirbank, Lmin, Lconst,
                          rounds=rounds, trials=trials)


class _SpecWalk(_Walk):
    """The spec (and async) walk: the D slice positions of every walker
    in each round (``xibank``), the directions of every step
    (``dirbank``), the threshold, the state (:data:`kernels.SPEC_STATE`
    and ``widths``, the running float sum of the accepted widths); the
    flag is "*target_done* walkers finished"."""

    def __init__(self, P, D, d, nsteps, max_rounds, target_done, dev):
        super().__init__(torch.zeros((), dtype=torch.bool, device=dev))
        f32 = functools.partial(_f32_buffer, dev)
        i64 = functools.partial(_i64_buffer, dev)
        self.xibank = f32(max_rounds, P, D)
        self.dirbank = f32(nsteps, P, d)
        self.Lmin = f32()
        self.state = dict(
            u=f32(P, d), L=f32(P), v=f32(P, d), tl=f32(P), tr=f32(P),
            step=i64(P), done=torch.zeros(P, dtype=torch.bool, device=dev),
            wbuf=f32(P), ncr=i64(), nur=i64(), nw=i64(), it=i64(),
            widths=f32())
        self.target = target_done
        self.max_rounds = max_rounds
        # Only with every walker required to finish are extra rounds
        # no-ops (every update is masked by ~done or anyhit)
        self.exact = target_done < P
        self.every = 1 if self.exact else SPEC_CHECK_EVERY

    def load(self, banks, live_u, live_L, axes, Lmin, scale, evaluate):
        """A dispatch's banks, threshold and likelihood; each walker
        starts at its live point on its first direction and full chord,
        counters and round at 0."""
        self.xibank.copy_(banks['xibank'])
        v = _direction_bank(banks, live_u, axes, scale, out=self.dirbank)[0]
        super().load(banks, live_u, live_L, Lmin, evaluate, v)

    def round(self):
        """K4 proposes every walker's D candidates, the likelihood
        evaluates them, K5 updates the state; the accepted widths are
        summed as the reference sums them, one round at a time."""
        st = self.state
        ts, tlc, trc, up = kernels.spec_propose(st['u'], st['v'], st['tl'],
                                                st['tr'], self.xibank,
                                                st['it'])
        Lp, tin = self.evaluate(up)
        kernels.spec_update(Lp.reshape(-1).contiguous(), tin, ts, tlc, trc,
                            self.Lmin, self.dirbank, st)
        st['widths'].add_(st['wbuf'].sum())

    def finished(self):
        self.flag.copy_(self.state['done'].sum() >= self.target)


def spec_walk(banks, live_u, live_L, nlive, axes, Lmin, scale, evaluate,
              nsteps, target_done=None, stats=None, graphs=None):
    """Speculative-shrink population walk (``popfused.py:538-650``).

    A slice-shrink rejection updates the bracket without a likelihood
    value, so the next D candidate positions of every walker's shrink
    chain are known in advance and evaluated in ONE batched likelihood
    call per round; the first candidate above *Lmin* wins, and the
    accepted chain is exactly the sequential sampler's. At D = 1 this is
    the async engine's walk (``popfused.py:697-812``): one row per
    walker per round, shrinking on rejection.

    A round is K4 (:func:`kernels.spec_propose`), the likelihood, K5
    (:func:`kernels.spec_update`) and the sum of the accepted widths.
    With *graphs* on a card, the rounds run as captured CUDA graphs
    (:class:`SpecGraphs`); otherwise from a host loop (the plain
    versions of K4 and K5 on the CPU). Both give the same bits.

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
        optional p-space filter and likelihood of (n, d) rows; with
        *graphs* it must read only tensors that stay put between calls
    nsteps: int
        slice steps per walker
    target_done: int or None
        walkers to finish before stopping (None: all). Below P every
        round's condition is read before the next round runs; otherwise
        once every :data:`SPEC_CHECK_EVERY` rounds.
    stats: dict or None
        if given, receives ``reads`` (blocking host reads of the flag),
        ``rounds`` (rounds run, no-op rounds included), ``graph``
        (whether the rounds ran as graphs), ``replays``, ``captures``
        and ``capture_s`` (graphs captured in this call, and the seconds
        that took)
    graphs: SpecGraphs or None
        run the rounds as this cache's CUDA graphs (CUDA tensors only)

    Returns
    -------
    uf, Lf, done, idx0, nc, nuseful, width: final points (P, d), their
    likelihoods, completion flags, start indices, billed and useful
    evaluation counts (0-d int64) and the mean slice width (0-d
    float32)
    """
    max_rounds, P, D = banks['xibank'].shape
    d = live_u.shape[1]
    dev = live_u.device
    if target_done is None:
        target_done = P
    walk = _walk_of(graphs, ('spec', P, D, d, nsteps, max_rounds,
                             target_done, str(dev)),
                    lambda: _SpecWalk(P, D, d, nsteps, max_rounds,
                                      target_done, dev))
    walk.load(banks, live_u, live_L, axes, Lmin, scale, evaluate)
    ran = _drive_walk(walk, graphs)
    if stats is not None:
        stats.update(ran)
    # the next dispatch rewrites the walk's buffers
    uf, Lf, done, nc, nuseful = (walk.state[k].clone()
                                 for k in ('u', 'L', 'done', 'ncr', 'nur'))
    width = walk.state['widths'] / torch.clamp(walk.state['nw'], min=1)
    return uf, Lf, done, banks['idx0'], nc, nuseful, width


class _SyncWalk(_Walk):
    """The sync walk: the slice positions as bank rows (``nsteps *
    max_it``, P, 1), the directions, the threshold and the state
    (:data:`kernels.SYNC_STATE`), whose flag ("every step ran") K6
    writes."""

    def __init__(self, P, d, nsteps, max_it, dev):
        f32 = functools.partial(_f32_buffer, dev)
        i64 = functools.partial(_i64_buffer, dev)
        state = dict(
            u=f32(P, d), v=f32(P, d), tl=f32(P), tr=f32(P), un=f32(P, d),
            Ln=f32(P), done=torch.zeros(P, dtype=torch.bool, device=dev),
            nc=i64(), s=i64(), it=i64(), row=i64(),
            flag=torch.zeros((), dtype=torch.bool, device=dev),
            accs=f32(nsteps), widths=f32(nsteps), tick=i64(2))
        super().__init__(state['flag'])
        self.state = state
        self.tbank = f32(nsteps * max_it, P, 1)
        self.dirbank = f32(nsteps, P, d)
        self.Lmin = f32()
        self.max_it = max_it
        self.max_rounds = nsteps * max_it
        self.every = SYNC_CHECK_EVERY

    def load(self, banks, live_u, live_L, axes, Lmin, scale, evaluate):
        """A dispatch's banks, threshold and likelihood; each walker
        starts at its live point on its first direction and full chord,
        nothing done, counters, step, iteration and bank row at 0."""
        self.tbank.copy_(banks['tbank'].reshape(self.tbank.shape))
        v = _direction_bank(banks, live_u, axes, scale, out=self.dirbank)[0]
        super().load(banks, live_u, live_L, Lmin, evaluate, v)
        self.start.update(un=self.start['u'], Ln=self.start.pop('L'))

    def round(self):
        """One shrink iteration of every walker: K4 at depth 1 proposes
        each walker's slice position from bank row ``state['row']``, the
        likelihood evaluates the rows, K6 updates the state and ends the
        step where it is over."""
        st = self.state
        ts, tlc, trc, up = kernels.spec_propose(st['u'], st['v'], st['tl'],
                                                st['tr'], self.tbank,
                                                st['row'])
        Lp, tin = self.evaluate(up)
        kernels.sync_update(Lp.reshape(-1).contiguous(), tin, ts, tlc, trc,
                            self.Lmin, self.dirbank, self.max_it, st)


def sync_walk(banks, live_u, live_L, axes, Lmin, scale, evaluate,
              stats=None, graphs=None):
    """Lockstep population walk (``popfused.py:814-877``).

    Every walker takes its step s before any takes step s + 1: per step,
    a direction and a full chord through the cube, then a shrink loop
    that evaluates one row per walker per iteration until every walker
    accepted or ``max_it`` iterations ran. Walkers that never accept
    keep their point. Every iteration bills all P rows the p-space
    filter lets through, finished walkers included, as the reference
    does.

    A round is one shrink iteration of every walker: K4 at depth 1
    (:func:`kernels.spec_propose`), the likelihood and K6
    (:func:`kernels.sync_update`), which also ends the step, so rounds
    run on across step boundaries with no host decision between steps;
    the round cap is ``nsteps * max_it``. The host reads K6's flag ("every
    step ran") once every :data:`SYNC_CHECK_EVERY` rounds, on a card one
    check behind the rounds queued: there ``reads == rounds //
    SYNC_CHECK_EVERY - 1`` below the cap, on the CPU ``rounds //
    SYNC_CHECK_EVERY``. With *graphs* on a card, each chunk of rounds is
    one replayed CUDA graph (:class:`SpecGraphs`); otherwise the rounds
    run from a host loop (the plain versions of K4 and K6 on the CPU).
    Both give the same bits.

    *banks* are the draws of :func:`draw_sync_banks` (``max_it`` >= 1);
    the other arguments are as for :func:`spec_walk`. Returns ``uf, Lf,
    done, idx0, nc, nuseful, width, acc_rate``: ``done`` all True,
    ``nuseful == nc`` (0-d int64; lockstep rounds evaluate no
    speculative rows), ``width`` the mean over steps of each step's
    median final bracket and ``acc_rate`` the mean over steps of the
    accepting fraction.
    """
    nsteps, max_it, P = banks['tbank'].shape
    if max_it < 1:
        raise ValueError('sync_walk needs max_it >= 1, got %d' % max_it)
    d = live_u.shape[1]
    dev = live_u.device
    walk = _walk_of(graphs, ('sync', P, d, nsteps, max_it, str(dev)),
                    lambda: _SyncWalk(P, d, nsteps, max_it, dev))
    walk.load(banks, live_u, live_L, axes, Lmin, scale, evaluate)
    ran = _drive_walk(walk, graphs)
    if stats is not None:
        stats.update(ran)
    # the next dispatch rewrites the walk's buffers
    uf, Lf, nc = (walk.state[k].clone() for k in ('un', 'Ln', 'nc'))
    done = torch.ones(P, dtype=torch.bool, device=dev)
    return (uf, Lf, done, banks['idx0'], nc, nc,
            walk.state['widths'].mean(), walk.state['accs'].mean())


def _rwalk_products(eps, axes, out):
    """Every step's product ``eps[s] @ axes.T`` into *out* (nsteps, P, d),
    in full float32 (TF32 off): one matmul a step, each the call the
    reference's scan makes a step. None depends on the walk, so all run
    before its first step. (One batched matmul of every step gives other
    bits on an H100 at the random-walk run's P 128, d 8:
    ``tests/test_torch_cuda.py::test_rwalk_products_batched_against_per_step``.)"""
    axes_t = axes.T
    for s in range(eps.shape[0]):
        torch.matmul(eps[s], axes_t, out=out[s])
    return out


class _RwalkWalk(_Walk):
    """The random walk: the noise, the region axes, the scale, the
    threshold, the state (:data:`kernels.RWALK_STATE`), every step's
    products and the proposal. Its one "round" is the whole walk, a
    fixed trip count: nothing is read."""

    def __init__(self, P, d, nsteps, dev):
        super().__init__(torch.zeros((), dtype=torch.bool, device=dev))
        f32 = functools.partial(_f32_buffer, dev)
        self.eps = f32(nsteps, P, d)
        self.axes = f32(d, d)
        self.scale = f32()
        self.Lmin = f32()
        self.m = f32(nsteps, P, d)
        self.up = f32(P, d)
        self.state = dict(u=f32(P, d), L=f32(P), nacc=_i64_buffer(dev),
                          nc=_i64_buffer(dev))

    def load(self, banks, live_u, live_L, axes, Lmin, scale, evaluate):
        """A dispatch's noise, axes, scale, threshold and likelihood;
        each walker starts at its live point, the counts at 0."""
        self.eps.copy_(banks['eps'])
        self.axes.copy_(axes)
        _set_scalar(self.scale, scale)
        super().load(banks, live_u, live_L, Lmin, evaluate)

    def round(self):
        """Every step of the dispatch: the products into ``m``
        (:func:`_rwalk_products`), K7's prologue (:func:`kernels.
        rwalk_accept` with no likelihoods: step 0's proposal ``u + scale
        * m[0]`` into ``up``), then a step is the likelihood of ``up``
        and K7, which accepts and writes the next step's proposal into
        ``up``."""
        nsteps = self.eps.shape[0]
        if nsteps == 0:
            return
        _rwalk_products(self.eps, self.axes, self.m)
        kernels.rwalk_accept(None, None, self.up, None, self.state, self.m[0],
                             self.scale)
        for s in range(nsteps):
            Lev, tin = self.evaluate(self.up)
            nxt = self.m[s + 1] if s + 1 < nsteps else None
            kernels.rwalk_accept(Lev.reshape(-1).contiguous(), tin, self.up,
                                 self.Lmin, self.state, nxt, self.scale)


def rwalk_walk(banks, live_u, live_L, axes, Lmin, scale, evaluate,
               stats=None, graphs=None):
    """Population Metropolis random walk (``popfused.py:1602-1631``).

    Each of the ``nsteps`` steps proposes ``u + scale * eps @ axes.T``
    for every walker (``eps`` from :func:`draw_rwalk_banks`) and accepts
    proposals inside the unit cube above *Lmin* (K7,
    :func:`kernels.rwalk_accept`, which also writes the next step's
    proposal; the products run before the first step,
    :class:`_RwalkWalk`). The loop has a fixed trip count, so the host
    reads nothing. The matmuls run in full float32 (TF32 stays off).
    With *graphs* on a card the whole walk is one CUDA graph
    (:class:`SpecGraphs`), replayed once; otherwise the steps run from
    the host (the plain versions of K7 on the CPU). Both give the same
    bits.

    Returns ``uf, Lf, done, idx0, nc, nuseful, acc_rate``: ``done`` all
    True, ``nuseful == nc`` (0-d int64; proposals outside the cube are
    not billed) and the acceptance rate (0-d float32).
    """
    nsteps, P, d = banks['eps'].shape
    dev = live_u.device
    walk = _walk_of(graphs, ('rwalk', P, d, nsteps, str(dev)),
                    lambda: _RwalkWalk(P, d, nsteps, dev))
    walk.load(banks, live_u, live_L, axes, Lmin, scale, evaluate)
    ran = _drive_walk(walk, graphs)
    if stats is not None:
        stats.update(ran, rounds=nsteps)
    # the next dispatch rewrites the walk's buffers
    uf, Lf, nc = (walk.state[k].clone() for k in ('u', 'L', 'nc'))
    acc_rate = walk.state['nacc'].to(torch.float32) / float(P * nsteps)
    done = torch.ones(P, dtype=torch.bool, device=dev)
    return uf, Lf, done, banks['idx0'], nc, nc, acc_rate


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
        # what the depth probe found, once it ran (_resolve_spec_depth)
        self.spec_probe = None
        self._pending = None
        self._last_yield = 0
        self._buf = None
        self._buf_i = 0
        self._buf_sufmax = None
        # the threshold that the buffered points were drawn above
        self._buf_Lmin = -np.inf
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
        # what became of the classic path's walk points, counted:
        # 'harvested', the walkers that finished above their dispatch's
        # threshold (in float64); 'dropped', those of them at or below
        # the threshold when they were harvested; 'stale', buffered
        # points thrown away because the threshold fell below the one
        # they were drawn above (_drop_stale)
        self.point_counts = dict(harvested=0, dropped=0, stale=0)
        self.logstat = []
        self.logstat_labels = ['accept_rate', 'efficiency', 'scale',
                               'nsteps', 'far_enough', 'mean_rel_jump']
        # (has_tregion, num_params): whether the walk fuses the p-space
        # wrapping-ellipsoid filter
        self._treg_key = (False, 0)
        # nsteps, host reads, rounds and the graphs (graph, replays,
        # captures, capture_s) of every walk, in dispatch order
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
        if n == 0 or Lmin < self._buf_Lmin:
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
        """Device cost of the likelihood as the walk pays it: returns
        ``dict(t_row_s, fixed_s, how)``.

        The transform and likelihood are timed on the rows a spec round
        evaluates at the configured depth D (popsize x D) and on one
        popsize batch. Their difference over D - 1 is ``t_row_s``, the
        cost of each further popsize batch (never below 0); what a call
        costs beyond its batches, ``fixed_s``, is a cost of the round
        whatever its depth (a likelihood of a few small ops costs its
        launches, and these the same at 128 rows as at 1024). On a card
        each call is captured in a CUDA graph and its replays are timed
        on the device alone (:func:`graph_call_seconds`; *how*
        ``'graph'``): that is what a round replayed from the walk's
        graphs pays, with none of the host's enqueue of the likelihood's
        ops; the reference gets the same by subtracting a null dispatch.
        The capture is this sampler's (:meth:`_spec_graphs`): where a call
        cannot be captured, its :attr:`SpecGraphs.failed` is set (one
        warning), the walk runs its rounds from the host loop and pays
        the eager call, so the eager calls are timed instead, with CUDA
        events, the best of three after a warm-up (``'eager'``); so too
        where the graphs failed already. On the CPU the host clock times
        the eager calls (``'host'``).
        """
        D, P = self.spec_depth, self._local_popsize
        ll, tr = self.torch_loglike, self._transform
        on_card = self.device.type == 'cuda'
        calls = []
        for rows in (P * D, P):
            u = torch.full((rows, x_dim), 0.5, dtype=torch.float32,
                           device=self.device)
            calls.append(lambda u=u: ll(tr(u)))
        cost = None
        graphs = self._spec_graphs() if on_card else None
        if on_card and graphs.failed is None:
            cost = [graph_call_seconds(c, self.device, graphs=graphs)
                    for c in calls]
            if None in cost:
                cost = None
        how = 'graph' if cost else 'eager' if on_card else 'host'
        if cost is None:
            cost = [_eager_seconds(c, on_card) for c in calls]
        t_row = max(0.0, (cost[0] - cost[1]) / (D - 1))
        return dict(t_row_s=t_row, fixed_s=max(0.0, cost[1] - t_row),
                    how=how)

    def _resolve_spec_depth(self, x_dim):
        """One-time auto-tune of ``spec_depth`` before the first dispatch.

        Probes the likelihood's device cost (:meth:`_probe_likelihood_cost`)
        and lowers the speculation depth when the billed extra rows cost
        more than the rounds they save (:func:`optimal_spec_depth`,
        ``popfused.py:408-451``), with the round's fixed cost taken as
        :data:`ROUND_OVERHEAD_S` (the round without the likelihood) plus
        the likelihood's per-call cost beyond its rows. The probe runs
        once per (likelihood, transform, popsize, x_dim, depth, device)
        in a process; :attr:`spec_probe` keeps what it found.
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
        probe = _PROBE_CACHE.get(memo)
        if probe is None:
            try:
                probe = self._probe_likelihood_cost(x_dim)
            except Exception:
                # an unprobeable likelihood keeps the configured depth
                _LOG.warning('spec_depth probe failed; keeping depth %d',
                             self.spec_depth, exc_info=True)
                return
            _PROBE_CACHE[memo] = probe
        t_row = probe['t_row_s']
        overhead = ROUND_OVERHEAD_S + probe['fixed_s']
        d = optimal_spec_depth(t_row, self.spec_depth, overhead)
        self.spec_probe = dict(probe, round_overhead_s=ROUND_OVERHEAD_S,
                               depth_from=self.spec_depth, depth=d)
        if d < self.spec_depth:
            _LOG.info('spec_depth auto-tuned %d -> %d (likelihood batch '
                      'cost %.3f ms, round %.3f ms)', self.spec_depth, d,
                      1e3 * t_row, 1e3 * overhead)
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
        stats, graphs, evaluate = self._walk_setup(treg)
        if self.engine == 'sync':
            return sync_walk(banks, live_u, live_L, axes, Lmin, _f32(scale),
                             evaluate, stats=stats, graphs=graphs)
        target = max(1, int(np.ceil(self.harvest_frac
                                    * self._local_popsize)))
        out = spec_walk(banks, live_u, live_L, nlive, axes, Lmin,
                        _f32(scale), evaluate, self.nsteps,
                        target_done=target, stats=stats, graphs=graphs)
        return out + (out[2].to(torch.float32).mean(),)

    def _walk_setup(self, treg):
        """What a walk of this sampler takes besides its inputs: its stats
        dict (appended to :attr:`walk_log`), on a card the sampler's
        graph cache (:meth:`_spec_graphs`; else None) and the evaluator
        of rows, ``evaluate(rows) -> (L, billed)``, with the p-space
        filter's pack *treg* (on a card read from a buffer that stays put
        between dispatches, as the graphs need)."""
        ev = self._treg_eval()
        stats = dict(nsteps=self.nsteps)
        self.walk_log.append(stats)
        graphs = None
        if self.device.type == 'cuda':
            graphs = self._spec_graphs()
            treg = graphs.static('treg', treg)

        def evaluate(rows):
            return ev(rows, treg)
        return stats, graphs, evaluate

    def _spec_graphs(self):
        """This sampler's :class:`SpecGraphs` (its walks' graphs, whatever
        the engine), tagged with what its walks' likelihood calls depend
        on besides the shapes."""
        if getattr(self, '_graphs', None) is None:
            ll = self.torch_loglike
            self._graphs = SpecGraphs(getattr(ll, '__qualname__', repr(ll)))
        self._graphs.tag = (self._treg_key, self.torch_loglike,
                            self._transform)
        return self._graphs

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
                np.array(us, np.float32, copy=True), self.nsteps,
                float(Lmin))

    def _harvest(self, region, transform, loglike, Lmin):
        """Fetch the pending dispatch and fill the sample buffer.

        The selected points are re-evaluated on the host in f64 before
        entering the tree; points at or below the *current* Lmin (which
        may have risen since launch) are discarded here.
        """
        handle, counts, us, at_nsteps, at_Lmin = self._pending
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
        above = Lf64 > at_Lmin
        self.point_counts['harvested'] += int(above.sum())
        self.point_counts['dropped'] += int((above & ~ok).sum())
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
        self._buf_Lmin = at_Lmin
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

    def _drop_stale(self, Lmin):
        """Throw away the buffered points and the dispatch in flight
        where *Lmin* lies below the threshold they were drawn above.

        Within a pass of the integrator the threshold only rises, and a
        point drawn above a lower threshold that lies above the current
        one is a draw above the current one. A new pass starts again at
        the roots, far below: a point drawn above the last pass's
        threshold is no draw from the prior above that, and handed to
        the new pass's first nodes it biases logZ upwards.
        """
        if self._pending is not None and Lmin < self._pending[-1]:
            self._pending = None
        if Lmin < self._buf_Lmin:
            self.point_counts['stale'] += self._buf_remaining()
            self._buf = None
            self._buf_i = 0
            self._buf_Lmin = -np.inf

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
        (:func:`_drive_rounds`; none for the random walk). Books its
        parts in the run in progress (:func:`tracing.lap`): ``load`` (the
        region's upload, the walk's set-up), ``banks``, ``rounds`` and
        ``tail``.
        """
        self._sync_treg_key(tregion)
        axes, treg, tpack = self._upload(
            self._region_axes(region), self._pack_tregion(tregion),
            self._pack_whiten(region))
        live_u, live_L = self._seg_state
        tracing.lap('load')
        banks = self._draw_banks(self._seg_nlive, self._seg_ndim,
                                 segment=True)
        tracing.lap('banks')
        lu, lL, packed, counts = self._run_segment(
            banks, live_u, live_L, self._seg_nlive, axes, self.scale, treg,
            tpack)
        self._seg_state = (lu, lL)
        self._seg_queue.append((start_fetch(packed), start_fetch(counts),
                                self.nsteps, region))
        tracing.lap('tail')

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
        raw = finish_fetch(handle)
        nc, nu = (int(c) for c in finish_fetch(counts))
        with tracing.count('parse'):
            rec = self._segment_parse(raw.astype(float), nc, nu, at_nsteps)
        with tracing.count('diagnose'):
            self._segment_diagnose(rec, at_nsteps, region)
        return rec

    def _segment_parse(self, packed, nc, nu, at_nsteps):
        """The records of a fetched segment (:meth:`segment_fetch`)."""
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
        of the last harvest. Buffered points and a dispatch drawn above
        a threshold higher than *Lmin* are thrown away first
        (:meth:`_drop_stale`).
        """
        self._drop_stale(Lmin)
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
        stats, graphs, evaluate = self._walk_setup(treg)
        out = rwalk_walk(banks, live_u, live_L, axes, Lmin, _f32(scale),
                         evaluate, stats=stats, graphs=graphs)
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
