# noqa: D400 D205
"""
Device-resident population slice sampler
----------------------------------------

Counterpart of ``ultranest_tpu/popfused.py`` with ``engine='spec'``, on
one device. A whole walker population advances through all its slice
steps in one dispatch, with the batched likelihood called once per
shrink round on (popsize x spec_depth) rows; one dispatch yields
``popsize`` independent samples.

The reference runs the walk as one ``lax.while_loop`` whose condition
lives on the device. Eager torch has no device-side loop, so here the
rounds are a host loop of torch ops (:func:`spec_walk`), and the host
reads the "all walkers done" flag once every :data:`SPEC_CHECK_EVERY`
rounds, through a pinned copy and a CUDA event, one check behind the
rounds already queued (the card never waits for that read). Extra rounds
after every walker is done are exact no-ops: every state update is
masked by ``~done`` or ``anyhit``, and the round counter is not an
output. So the results are the reference's, bit for bit in the integer
outputs, and no round past ``max_rounds`` ever runs.

All randomness of a dispatch is drawn up front (:func:`draw_spec_banks`)
from a ``torch.Generator`` on the sampler's device, seeded per dispatch
from the host PCG64 stream the reference draws its per-dispatch keys
from. The walk takes those banks as inputs, so a test can feed it the
reference's own draws.

Not ported yet, each raising ``NotImplementedError`` that names its
ROADMAP item: the ``async`` and ``sync`` engines and
:class:`FusedPopulationRandomWalkSampler` (queue A item 9), ``mesh=``
(item 13) and the spec-depth probe (``spec_depth_auto``, item 9). The
doubled-nsteps prewarm thread and the fingerprint-keyed kernel cache
have no counterpart: eager torch does not compile per shape.
"""

import logging
import math

import numpy as np
import torch

from .fused import _as_f32, _f32, _inside_ellipsoid, tregion_geometry
from .ops.pairwise import pad_rows, round_up
from .ordertest import UniformOrderAccumulator
from .parallel.launch import finish_fetch, start_fetch
from .popstepsampler import (GenericPopulationSampler,
                             decorrelation_gm_target,
                             diagnose_move_distances,
                             reference_sqdistance_info)
from .segmentops import (consume_scan, pack_segment, whitened_cloud_var,
                         whitened_jump2)

__all__ = ['FusedPopulationSliceSampler', 'FusedPopulationRandomWalkSampler',
           'draw_spec_banks', 'spec_walk', 'spec_max_rounds',
           'SPEC_CHECK_EVERY']

# rounds between two host reads of the walk's "all done" flag
SPEC_CHECK_EVERY = 8
# the billed and useful counts travel home as float32
F32_EXACT_COUNT = 2 ** 24

_LOG = logging.getLogger('ultranest_torch.popfused')


def spec_max_rounds(nsteps, max_it, depth):
    """Round cap of one spec dispatch (``popfused.py:535``).

    Generous on purpose: walkers still unfinished at the cap are
    discarded, which wastes their chains and selects survivors by shrink
    speed.
    """
    return nsteps * max(4, (max_it + depth - 1) // depth)


def draw_spec_banks(generator, P, D, nsteps, max_rounds, nlive, x_dim):
    """All random draws of one spec dispatch, on the generator's device.

    Returns a dict of raw draws, as the reference makes them
    (``popfused.py:547-558``) before any use:

    * ``xibank`` (max_rounds, P, D) float32 uniforms: the D speculative
      slice positions of every walker in each round;
    * ``i1`` (nsteps, P) in [0, nlive) and ``i2`` (nsteps, P) in
      [0, nlive - 1): the differential-evolution pair of each step
      (the walk shifts ``i2 >= i1`` up by one);
    * ``jx`` (nsteps, P) in [0, x_dim): the region axis of each step;
    * ``pick`` (nsteps, P) float32 uniforms: below 0.5 picks the pair;
    * ``idx0`` (P,) in [0, nlive): each walker's start.
    """
    g, dev = generator, generator.device
    return dict(
        xibank=torch.rand((max_rounds, P, D), generator=g, device=dev),
        i1=torch.randint(0, nlive, (nsteps, P), generator=g, device=dev),
        i2=torch.randint(0, max(nlive - 1, 1), (nsteps, P), generator=g,
                         device=dev),
        jx=torch.randint(0, x_dim, (nsteps, P), generator=g, device=dev),
        pick=torch.rand((nsteps, P), generator=g, device=dev),
        idx0=torch.randint(0, nlive, (P,), generator=g, device=dev))


def _cube_intersection(u, v):
    """Line coordinates where rays u + t*v cross the unit cube faces.

    Where ``v == 0`` the divisions give inf or nan; both are masked to
    -inf / +inf before the reductions, so none reaches ``max``/``min``.
    """
    nz = v != 0
    a = torch.where(nz, (0.0 - u) / v, -math.inf)
    b = torch.where(nz, (1.0 - u) / v, math.inf)
    return torch.minimum(a, b).amax(dim=1), torch.maximum(a, b).amin(dim=1)


def _start_flag(flag):
    """Begin reading a 0-d bool device tensor; returns a handle."""
    if flag.device.type != 'cuda':
        return flag, None
    host = torch.empty((), dtype=torch.bool, pin_memory=True)
    host.copy_(flag, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record()
    return host, ready


def _finish_flag(handle):
    """Wait for a :func:`_start_flag` read; returns a Python bool."""
    host, ready = handle
    if ready is not None:
        ready.synchronize()
    return bool(host)


def spec_walk(banks, live_u, live_L, nlive, axes, Lmin, scale, evaluate,
              nsteps, target_done=None, stats=None):
    """Speculative-shrink population walk (``popfused.py:538-650``).

    A slice-shrink rejection updates the bracket without a likelihood
    value, so the next D candidate positions of every walker's shrink
    chain are known in advance and evaluated in ONE batched likelihood
    call per round; the first candidate above *Lmin* wins, and the
    accepted chain is exactly the sequential sampler's.

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
    evaluation counts (0-d float32) and the mean slice width (0-d
    float32)
    """
    xibank = banks['xibank']
    max_rounds, P, D = xibank.shape
    dev = live_u.device
    if target_done is None:
        target_done = P
    i1 = banks['i1']
    i2 = torch.where(banks['i2'] >= i1, banks['i2'] + 1, banks['i2'])
    v_de = live_u[i1] - live_u[i2]
    v_ax = axes[banks['jx']]
    dirbank = torch.where((banks['pick'] < 0.5)[..., None], v_de,
                          v_ax) * scale
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

    # Only with every walker required to finish are extra rounds no-ops;
    # then the host reads the flag every SPEC_CHECK_EVERY rounds, one
    # check behind on a card so that the next rounds are already queued.
    exact = target_done < P
    k = 1 if exact else SPEC_CHECK_EVERY
    lag = 1 if (dev.type == 'cuda' and not exact) else 0
    flags = []
    reads = 0
    it = 0
    state = (u, L, v, tl, tr, step, done, widths, nw, ncr, nur)
    while it < max_rounds:
        for _ in range(min(k, max_rounds - it)):
            state = round_body(it, *state)
            it += 1
        flags.append(_start_flag(state[6].sum() >= target_done))
        if len(flags) > lag:
            reads += 1
            if _finish_flag(flags.pop(0)):
                break
    if stats is not None:
        stats.update(reads=reads, rounds=it)
    uf, Lf, _, tl, tr, step, done, widths, nw, ncr, nur = state
    width = widths / torch.clamp(nw, min=1)
    return (uf, Lf, done, idx0, ncr.to(torch.float32),
            nur.to(torch.float32), width)


class FusedPopulationSliceSampler(GenericPopulationSampler):
    """Vectorized slice sampler running on one device.

    Per step, each walker draws a direction (50/50 mix of
    differential-evolution pairs and region principal axes), intersects
    it with the unit cube, and shrink-samples its slice until it finds a
    point above the threshold. All walkers and all steps run in one
    dispatch (:func:`spec_walk`).

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
        only 'spec' is ported: each round evaluates a depth-``spec_depth``
        precomputed shrink chain per walker in one batched call
    harvest_frac: float
        end the dispatch when this fraction of walkers completed their
        chains. Values below 1.0 bias logZ (the reference's warning) and
        exclude segment mode.
    spec_depth: int
        candidates per walker per round
    adaptive_nsteps: bool
        govern the chain length online from the jump-distance and
        insertion-rank diagnostics (see :meth:`_adapt_nsteps`,
        :meth:`observe_insertion_ranks`)
    max_nsteps: int
        adaptation ceiling
    spec_depth_auto: None or False
        the reference's likelihood-cost probe that may lower
        ``spec_depth`` on accelerators. Its round-overhead constant
        (350 us) was measured on a TPU, so the port keeps the
        configured depth; True raises until the probe is re-derived
        for the GPU (ROADMAP queue A item 9).
    device: str or torch.device
        where the walk and the live set of segment mode live
    """

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
        if engine != 'spec':
            raise NotImplementedError(
                "engine=%r is not ported to ultranest_torch yet (ROADMAP "
                "queue A item 9); use engine='spec'" % (engine,))
        if mesh is not None or axis_name is not None:
            raise NotImplementedError(
                'mesh= is not ported to ultranest_torch yet (ROADMAP '
                'queue A item 13)')
        if spec_depth_auto:
            raise NotImplementedError(
                'spec_depth_auto: the likelihood-cost probe is not ported '
                'to ultranest_torch yet (ROADMAP queue A item 9)')
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
        self._pending = None
        self._last_yield = 0
        self._buf = None
        self._buf_i = 0
        self._buf_sufmax = None
        self.torch_loglike = torch_loglike
        self.torch_transform = torch_transform if torch_transform is not None \
            else (lambda u: u)
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
        # host reads and rounds of every walk, in dispatch order
        self.walk_log = []

    def __str__(self):
        """Return string representation."""
        return 'FusedPopulationSliceSampler(popsize=%d, nsteps=%d, scale=%g)' \
            % (self.popsize, self.nsteps, self.scale)

    def _seed_dispatch(self):
        """Seed the generator from the next host key (two uint32 words)."""
        k = self._key_rng.integers(0, 2**32, size=2, dtype=np.uint32)
        self._gen.manual_seed(((int(k[0]) << 32) | int(k[1]))
                              & (2**63 - 1))

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
        transform = self.torch_transform
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

    def _max_rounds(self):
        return spec_max_rounds(self.nsteps, self.max_it, self.spec_depth)

    def _draw_banks(self, nlive, x_dim):
        self._seed_dispatch()
        return draw_spec_banks(self._gen, self.popsize, self.spec_depth,
                               self.nsteps, self._max_rounds(), nlive, x_dim)

    def _walk(self, banks, live_u, live_L, nlive, axes, Lmin, scale, treg):
        """:func:`spec_walk` with this sampler's evaluator and settings."""
        ev = self._treg_eval()
        target = max(1, int(np.ceil(self.harvest_frac * self.popsize)))
        stats = {}
        self.walk_log.append(stats)
        return spec_walk(banks, live_u, live_L, nlive, axes, Lmin,
                         _f32(scale), lambda rows: ev(rows, treg),
                         self.nsteps, target_done=target, stats=stats)

    def _run_segment(self, banks, live_u, live_L, nlive, axes, scale, treg,
                     tpack):
        """Walk + on-device consumption (``popfused.py:1216-1232``).

        Each chain's whitened squared travel distance (end vs the
        ``live_u[idx0]`` start, read before the consume scan changes the
        live set) travels home as one trailing record column.
        """
        Lmin0 = live_L.min()          # padding is +inf
        uf, Lf, done, idx0, nc, nu, width = self._walk(
            banks, live_u, live_L, nlive, axes, Lmin0, scale, treg)
        jump2 = whitened_jump2(live_u[idx0], uf, tpack)
        # decorrelation normalizer from the live cloud the chains
        # actually walked in (the host region snapshot is up to
        # queue-depth segments stale)
        ref2 = whitened_cloud_var(live_u, nlive, tpack)
        donef = done.to(torch.float32)
        live_u2, live_L2, recs = consume_scan(live_u, live_L, uf, Lf, donef)
        recs = torch.cat([recs, jump2[:, None]], dim=1)
        packed = pack_segment(uf, Lf, recs, nc, donef.mean(), width,
                              nuseful=nu, ref2=ref2)
        return live_u2, live_L2, packed

    @staticmethod
    def _check_counts(nc, nuseful):
        """The f32 count slots are exact below 2**24: refuse to lose counts."""
        if max(nc, nuseful) >= F32_EXACT_COUNT:
            raise OverflowError(
                'a dispatch billed %d evaluations: float32 counts are '
                'exact only below 2**24; lower popsize or spec_depth'
                % max(nc, nuseful))

    # --- classic mode ---------------------------------------------------

    def _launch(self, region, Lmin, us, Ls, tregion=None):
        """Run one population walk; returns a pending handle.

        The result streams home (:func:`parallel.launch.start_fetch`)
        while the integrator consumes the current buffer.
        """
        nlive, ndim = us.shape
        npad = round_up(nlive)
        self._sync_treg_key(tregion)
        live_u, live_L, axes, treg = self._upload(
            pad_rows(np.asarray(us, np.float32), npad),
            pad_rows(np.asarray(Ls, np.float32), npad, fill=-np.inf),
            self._region_axes(region), self._pack_tregion(tregion))
        banks = self._draw_banks(nlive, ndim)
        uf, Lf, done, idx0, nc, nu, width = self._walk(
            banks, live_u, live_L, nlive, axes, _f32(Lmin), self.scale, treg)
        donef = done.to(torch.float32)
        rows = torch.cat([uf, Lf[:, None], donef[:, None],
                          idx0[:, None].to(torch.float32)], dim=1)
        scalars = torch.zeros((1, ndim + 3), dtype=torch.float32,
                              device=self.device)
        scalars[0, :4] = torch.stack([nc, donef.mean(), width, nu])
        return (start_fetch(torch.cat([rows, scalars])),
                np.array(us, np.float32, copy=True), self.nsteps)

    def _harvest(self, region, transform, loglike, Lmin):
        """Fetch the pending dispatch and fill the sample buffer.

        The selected points are re-evaluated on the host in f64 before
        entering the tree; points at or below the *current* Lmin (which
        may have risen since launch) are discarded here.
        """
        handle, us, at_nsteps = self._pending
        self._pending = None
        nlive, ndim = us.shape
        packed = finish_fetch(handle).astype(float)
        # column layout: [u(0:d), L, done, idx0]; one trailing scalar
        # row: [ncall, done_frac, width, nuseful]
        rows, scalars = packed[:-1], packed[-1]
        self._check_counts(scalars[0], scalars[3])
        nc = int(scalars[0])
        acc_rate, width = scalars[1], scalars[2]
        nu = int(scalars[3])
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
        """Change nsteps (the next dispatch walks at the new length)."""
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
        """Segment mode needs every walker to finish (harvest_frac 1).

        Segment consumption bills every harvested row, so the dispatch
        must walk the whole population to completion.
        """
        return self.harvest_frac >= 1.0

    def segment_start(self, us, Ls, ndraw=None):
        """Upload the live set and reset the dispatch queue."""
        nlive, ndim = us.shape
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
        """Run one chained walk+consume segment; its result streams home."""
        self._sync_treg_key(tregion)
        axes, treg, tpack = self._upload(
            self._region_axes(region), self._pack_tregion(tregion),
            self._pack_whiten(region))
        live_u, live_L = self._seg_state
        banks = self._draw_banks(self._seg_nlive, self._seg_ndim)
        lu, lL, packed = self._run_segment(
            banks, live_u, live_L, self._seg_nlive, axes, self.scale, treg,
            tpack)
        self._seg_state = (lu, lL)
        self._seg_queue.append((start_fetch(packed), self.nsteps, region))

    def segment_fetch(self):
        """Wait for the oldest queued segment; returns parsed records.

        Returns a dict with per-row arrays (in consumption order):
        ``u (P,d), L, accept, worst, Lmin, rank, plateau, dup,
        jump2 (P,)`` and the scalars ``nc`` (walk evaluations),
        ``done_frac``, ``width``, ``nc_useful``, ``ref2_dev`` and
        ``nsteps``. Also feeds the jump-distance diagnostics and the
        adaptive nsteps governor, as the classic-mode harvest does.
        """
        handle, at_nsteps, region = self._seg_queue.pop(0)
        packed = finish_fetch(handle).astype(float)
        d = self._seg_ndim
        rows, scal = packed[:-1], packed[-1]
        self._check_counts(scal[0], scal[3])
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
            nc=int(scal[0]), done_frac=float(scal[1]),
            width=float(scal[2]), nc_useful=int(scal[3]),
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
    """Device-resident population Metropolis random walk (not ported yet).

    Counterpart of ``ultranest_tpu.popfused.FusedPopulationRandomWalkSampler``.
    """

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            'FusedPopulationRandomWalkSampler is not ported to '
            'ultranest_torch yet (ROADMAP queue A item 9)')
