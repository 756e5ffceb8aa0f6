# noqa: D400 D205
"""
Fused device proposal path
--------------------------

Counterpart of ``ultranest_tpu/fused.py``. For a torch likelihood and
transform, one chain of device work per dispatch performs the hot loop
of a nested sampling iteration batch:

    draw candidates -> unit-cube test -> wrapping-ellipsoid test
    -> whiten -> radius membership (kernel K1) -> transform
    -> p-space ellipsoid test -> log-likelihood -> acceptance budget
    -> stable compaction [-> consume scan (kernel K3), segment mode]

It is split in two stages so both sides of a test can be fed the same
candidates: a random **draw** stage (:meth:`FusedRegionSampler.draw`)
and a deterministic stage that takes ``u`` and ``mult_ok``
(:func:`filter_stage`, then :func:`compact_classic` or
:func:`compact_segment`). Nothing in a dispatch waits for the device:
no ``.item()``, no ``nonzero``, no boolean-mask indexing, so queued
dispatches really run ahead of the host.

Region geometry travels as one f32 host array per dispatch (one
host-to-device copy), as in the reference. Randomness comes from one
``torch.Generator`` on the sampler's device, seeded per dispatch from
the host PCG64 stream the reference draws its per-dispatch keys from.
Matmuls run in full f32: TF32 must stay off
(``torch.backends.cuda.matmul.allow_tf32``, False by default).
"""

import numpy as np
import torch

from . import tracing
from .ops import kernels
from .ops.pairwise import pad_rows, pairwise_sqdist, round_up
from .parallel import (all_gather_rows, check_mesh, psum, shard_count,
                       shard_index, shard_seed)
from .parallel.launch import finish_fetch, start_fetch
from .segmentops import consume_scan, pack_segment

__all__ = ['FusedRegionSampler', 'filter_stage', 'compact_classic',
           'compact_segment', 'region_geometry']

# proposal method codes
METHOD_CUBE = 0         # uniform in the unit cube, filtered
METHOD_ELLIPSOID = 1    # uniform in the enlarged wrapping ellipsoid
METHOD_TBOX = 2         # uniform in the whitened-space bounding box
METHOD_POINTS = 3       # balls around live points, multiplicity-corrected

# method rotation order on starvation: global proposals first, then the
# live-point balls (which track tight multimodal tails best)
METHOD_CYCLE = [METHOD_ELLIPSOID, METHOD_POINTS, METHOD_CUBE, METHOD_TBOX]

# cap on accepted candidates returned per proposal call
MAX_RETURN = 1024

_F32MAX = float(np.finfo(np.float32).max)


def _as_f32(x):
    """Cast to float32 with overflow clipped to ±f32max (warning-free).

    Whitened-space geometry (bbox corners, 1/std scalings, ellipsoid
    radii) can exceed the f32 range when the live set is degenerate
    along an axis; a saturating cast keeps the packed geometry finite.
    """
    a = np.asarray(x, np.float64)
    return np.clip(a, -_F32MAX, _F32MAX).astype(np.float32)


def _f32(x):
    """Python float holding *x* rounded to float32."""
    return float(np.float32(x))


def _inside_ellipsoid(u, ctr, invcov, enlarge):
    d = u - ctr
    return ((d @ invcov) * d).sum(dim=1) <= enlarge


def tregion_geometry(tregion, num_params):
    """(ctr, invcov, enlarge) of a WrappingEllipsoid in FULL p-space.

    The wrapping ellipsoid factors out fixed (zero-variance) dimensions;
    the kernels operate on full ``num_params``-vectors, so the
    variable-dim form is embedded with zero inverse-covariance weight on
    fixed dims.
    """
    vd = tregion.variable_dims
    if vd is Ellipsis:
        return (_as_f32(tregion.ellipsoid_center),
                _as_f32(tregion.ellipsoid_invcov),
                np.float32(tregion.enlarge))
    idx = np.flatnonzero(vd)
    ctr = np.zeros(num_params, np.float32)
    inv = np.zeros((num_params, num_params), np.float32)
    ctr[idx] = tregion.ellipsoid_center
    inv[np.ix_(idx, idx)] = tregion.ellipsoid_invcov
    return ctr, inv, np.float32(tregion.enlarge)


def region_geometry(region, x_dim, tregion, device):
    """Region geometry on *device*: f32 tensors plus f32-rounded scalars.

    All arrays ship as ONE host-to-device copy and are sliced into views.
    Returns a dict with T, invT, ctr, ell_ctr, ell_invcov, ell_axes_T,
    tbox_lo, tbox_hi (and treg_ctr, treg_invcov with a tregion) as
    tensors, and maxradiussq, enlarge, treg_enlarge and kind as Python
    values.
    """
    layer = region.transformLayer
    # express the layer as an affine map (ScalingLayer is diagonal)
    if hasattr(layer, 'T') and np.ndim(layer.T) == 2:
        T, invT, ctr = _as_f32(layer.T), _as_f32(layer.invT), \
            _as_f32(layer.ctr)
    else:
        std = np.ravel(np.broadcast_to(layer.std, (1, x_dim)))
        mean = np.ravel(np.broadcast_to(layer.mean, (1, x_dim)))
        T, invT, ctr = _as_f32(np.diag(1.0 / std)), _as_f32(np.diag(std)), \
            _as_f32(mean)
    maxr = region.maxradiussq if region.maxradiussq is not None else 0.0
    # ellipsoid-only regions report maxradiussq = inf / >f32max; clip so
    # the f32 geometry stays finite (f32max radius^2 accepts all)
    maxr = float(min(maxr, _F32MAX))
    sq = np.float32(maxr) ** 0.5
    arrays = dict(
        T=T, invT=invT, ctr=ctr,
        ell_ctr=np.asarray(region.ellipsoid_center, np.float32),
        ell_invcov=np.asarray(region.ellipsoid_invcov, np.float32),
        ell_axes_T=np.asarray(region.ellipsoid_axes_T, np.float32),
        tbox_lo=_as_f32(region.bbox_lo) - sq,
        tbox_hi=_as_f32(region.bbox_hi) + sq)
    geo = dict(maxradiussq=_f32(maxr), enlarge=_f32(region.enlarge),
               treg_enlarge=1.0,
               kind='mlfriends' if type(region).__name__ == 'MLFriends'
               else 'ellipsoid')
    if tregion is not None:
        treg_ctr, treg_invcov, treg_enlarge = tregion_geometry(
            tregion, tregion.u.shape[1])
        arrays.update(treg_ctr=treg_ctr, treg_invcov=treg_invcov)
        geo['treg_enlarge'] = _f32(treg_enlarge)
    flat = np.concatenate([a.ravel() for a in arrays.values()])
    packed = torch.as_tensor(flat).to(device, non_blocking=True)
    off = 0
    for name, a in arrays.items():
        geo[name] = packed[off:off + a.size].view(a.shape)
        off += a.size
    return geo


def _radius_member(t_candidates, tpoints, tmask, maxradiussq):
    """Within MLFriends radius of any valid live point (kernel K1)."""
    return kernels.radius_member(tpoints, tmask, t_candidates,
                                 maxradiussq) > 0


def filter_stage(u, mult_ok, geo, tpoints, tmask, transform, loglike):
    """Deterministic filter -> transform -> likelihood of candidates *u*.

    Parameters
    ----------
    u: (n, d) float32
        candidates in the unit cube
    mult_ok: (n,) bool
        draw-stage acceptance (the live-point-ball multiplicity test)
    geo: dict
        from :func:`region_geometry`
    tpoints: (npad, d) float32
        whitened live points; tmask (npad,) int32 marks the valid rows

    Returns
    -------
    member, v, logl: region membership, transformed points, and the
    log-likelihood (-inf outside the region)
    """
    in_cube = ((u > 0) & (u < 1)).all(dim=1)
    member = in_cube & _inside_ellipsoid(u, geo['ell_ctr'],
                                         geo['ell_invcov'], geo['enlarge'])
    member = member & mult_ok
    if geo['kind'] == 'mlfriends':
        t = (u - geo['ctr']) @ geo['T']
        member = member & _radius_member(t, tpoints, tmask,
                                         geo['maxradiussq'])
    v = transform(u)
    if 'treg_ctr' in geo:
        member = member & _inside_ellipsoid(
            v, geo['treg_ctr'], geo['treg_invcov'], geo['treg_enlarge'])
    logl = loglike(v).to(torch.float32).masked_fill(~member, -np.inf)
    return member, v, logl


def _first_true_first(mask):
    """Stable permutation putting the True rows first, in draw order."""
    return torch.argsort((~mask).to(torch.int8), stable=True)


def compact_classic(u, v, logl, member, Lmin, budget, kreturn):
    """Acceptance budget and compaction of the classic path.

    Processing stops at the budget-th accepted row in draw order, as a
    sequential sampler that quits once it has enough would: later rows
    are neither returned nor billed to ncall. Accepted rows come first,
    in draw order, truncated to *kreturn* rows.

    Returns u, v, logl (kreturn rows), n_accepted and nc (0-d tensors).
    """
    accepted = member & (logl > Lmin)
    within = torch.cumsum(accepted.to(torch.int32), 0) <= min(budget,
                                                               kreturn)
    member = member & within
    accepted = accepted & within
    sel = _first_true_first(accepted)[:min(kreturn, u.shape[0])]
    n_acc = torch.clamp(accepted.sum(), max=sel.shape[0])
    return u[sel], v[sel], logl[sel], n_acc, member.sum()


def compact_segment(u, logl, member, Lmin, budget, scan_cap):
    """Acceptance budget and compaction of the segment path.

    Billing stops at the acceptance budget, and only rows that can be
    consumed (above the dispatch threshold, within budget) are marked
    valid; they come first in a window of *scan_cap* rows so the
    sequential scan is ~budget long, not ~ndraw.

    Returns u, logl, valid (float32) of scan_cap rows, and nc (0-d).
    """
    accepted0 = member & (logl > Lmin)
    wb = torch.cumsum(accepted0.to(torch.int32), 0) <= min(budget,
                                                           scan_cap)
    valid = accepted0 & wb
    order = _first_true_first(valid)[:scan_cap]
    return u[order], logl[order], valid[order].to(torch.float32), \
        (member & wb).sum()


class FusedRegionSampler:
    """Device-fused candidate proposal for torch models.

    Parameters
    ----------
    loglike: function
        (n, num_params) tensor -> (n,) log-likelihood tensor
    transform: function or None
        (n, x_dim) tensor -> (n, num_params) prior transform
    x_dim: int
        dimensionality
    seed: int
        seed of the host stream the per-dispatch generator seeds come from
    mesh: DeviceMesh or None
        shard candidate generation over this mesh
        (:mod:`ultranest_torch.parallel`): each shard draws ``max(128,
        ndraw / nshards)`` candidates from its own stream, filters them
        (kernel K1) and keeps at most ``max(16, MAX_RETURN / nshards)``;
        the shards' blocks are gathered and their billed counts summed.
        A sharded sampler stays on the classic budgeted path
        (:meth:`segment_ok`).
    axis_name: str, tuple or None
        shard over these mesh dimensions only (default: all of them)
    device: str or torch.device
        where proposals are drawn, filtered and evaluated
    """

    def __init__(self, loglike, transform, x_dim, seed=0, mesh=None,
                 axis_name=None, device='cuda'):
        self.loglike = loglike
        self.transform = transform if transform is not None else (lambda u: u)
        self.x_dim = x_dim
        self.device = torch.device(device)
        self.mesh, self.axis_name = check_mesh(mesh, axis_name)
        self.nshards = shard_count(mesh, axis_name)
        self._shard = shard_index(mesh, axis_name)
        # per-dispatch generator seeds come from a host stream, as the
        # reference's per-dispatch threefry keys do (fused.py:296)
        self._key_rng = np.random.Generator(np.random.PCG64(seed))
        self._gen = torch.Generator(device=self.device)
        self._pending = []
        # dispatches kept in flight ahead of the consumer (the
        # reference's TPU-tuned depth, to be measured again on the GPU);
        # 0 on the CPU, where there is no second processor to overlap
        self.prefetch_depth = 0 if self.device.type == 'cpu' else 2

    def _next_seed(self):
        """Generator seed of the next dispatch on this shard.

        One host key (two uint32 words) a dispatch; with a mesh, one key
        per shard (``fused.py:919``), and this shard's mixed with its
        index (:func:`~ultranest_torch.parallel.shard_seed`).
        """
        if self.nshards == 1:
            k = self._key_rng.integers(0, 2**32, size=(2,), dtype=np.uint32)
            return ((int(k[0]) << 32) | int(k[1])) & (2**63 - 1)
        keys = self._key_rng.integers(0, 2**32, size=(self.nshards, 2),
                                      dtype=np.uint32)
        return shard_seed(keys[self._shard], self._shard)

    def _seed_dispatch(self):
        """Seed the generator for the next dispatch."""
        self._gen.manual_seed(self._next_seed())

    # --- draw stage ----------------------------------------------------

    def _ball_offsets(self, n, scale):
        g, dev, d = self._gen, self.device, self.x_dim
        z = torch.randn((n, d), generator=g, device=dev)
        z = z / torch.linalg.vector_norm(z, dim=1, keepdim=True)
        r = torch.rand((n, 1), generator=g, device=dev) ** (1.0 / d)
        return z * r * scale

    def draw(self, method, n, geo, tpoints, tmask, nlive):
        """Draw *n* candidates with proposal *method* (a Python int).

        Returns u (n, d) float32 and mult_ok (n,) bool.
        """
        g, dev, d = self._gen, self.device, self.x_dim
        ones = torch.ones(n, dtype=torch.bool, device=dev)
        if method == METHOD_CUBE:
            return torch.rand((n, d), generator=g, device=dev), ones
        if method == METHOD_ELLIPSOID:
            offs = self._ball_offsets(n, float(np.sqrt(np.float32(
                geo['enlarge']))))
            return geo['ell_ctr'] + offs @ geo['ell_axes_T'], ones
        if method == METHOD_TBOX:
            v = torch.rand((n, d), generator=g, device=dev)
            v = geo['tbox_lo'] + v * (geo['tbox_hi'] - geo['tbox_lo'])
            return v @ geo['invT'] + geo['ctr'], ones
        assert method == METHOD_POINTS, method
        # balls around random live points in whitened space, with
        # 1/multiplicity acceptance (cf. upstream mlfriends.pyx:1072-1094)
        maxr = geo['maxradiussq']
        idx = torch.randint(0, nlive, (n,), generator=g, device=dev)
        t_prop = tpoints[idx] + self._ball_offsets(
            n, float(np.sqrt(np.float32(maxr))))
        within = (pairwise_sqdist(tpoints, t_prop) <= maxr) \
            & (tmask != 0)[:, None]
        counts = within.sum(dim=0)
        mult_ok = (torch.rand(n, generator=g, device=dev)
                   * counts.clamp(min=1) < 1) & (counts >= 1)
        return t_prop @ geo['invT'] + geo['ctr'], mult_ok

    # --- classic mode --------------------------------------------------

    def __call__(self, region, Lmin, ndraw, tregion=None, method=None,
                 naccept_budget=None):
        """Propose *ndraw* candidates; returns (u, v, logl, nc, ndraw).

        If prefetched dispatches are in flight (see :meth:`prefetch`),
        the oldest is harvested instead of paying a fresh dispatch.
        """
        if self._pending:
            return self._unpack(*self._pending.pop(0))
        return self._unpack(*self._launch(region, Lmin, ndraw, tregion,
                                          method, naccept_budget))

    def prefetch(self, region, Lmin, ndraw, tregion=None, method=None,
                 naccept_budget=None):
        """Launch upcoming proposal batches without waiting for them.

        Up to ``prefetch_depth`` dispatches are kept in flight; later
        ``__call__`` harvests them oldest-first. Candidates in deeper
        batches were proposed at a slightly stale threshold, which only
        costs extra rejected rows (the consumer re-filters by the live
        ``Lmin``). No-op on the CPU.
        """
        while len(self._pending) < self.prefetch_depth:
            self._pending.append(self._launch(region, Lmin, ndraw,
                                              tregion, method,
                                              naccept_budget))

    def _inputs(self, region, tregion=None, method=None,
                naccept_budget=None):
        """A classic dispatch's inputs on the device: (geo, tpoints, tmask,
        npts, method, naccept_budget)."""
        geo = region_geometry(region, self.x_dim, tregion, self.device)
        npts = len(region.unormed)
        npad = round_up(npts)
        tpoints = torch.as_tensor(
            pad_rows(np.asarray(region.unormed, np.float32), npad)).to(
            self.device, non_blocking=True)
        tmask = (torch.arange(npad, device=self.device) < npts).to(
            torch.int32)
        if naccept_budget is None:
            # half the live-point count: ample to keep the consumer fed
            # past the next refill, small enough that a high-acceptance
            # batch cannot burn evaluations on soon-stale points
            naccept_budget = max(64, npts // 2)
        if method is None or (geo['kind'] != 'mlfriends'
                              and method == METHOD_POINTS):
            method = METHOD_ELLIPSOID
        return geo, tpoints, tmask, npts, method, naccept_budget

    def _propose(self, seed, inputs, Lmin, ndraw, kreturn):
        """One shard's proposal batch from generator *seed*.

        Draws *ndraw* candidates, filters and evaluates them and keeps at
        most *kreturn* accepted rows. Returns one f32 pack (the rows [u |
        v | logl], then a row [nc, n_acc, 0..]) and the billed count nc
        (0-d int64).
        """
        geo, tpoints, tmask, npts, method, budget = inputs
        self._gen.manual_seed(seed)
        u, mult_ok = self.draw(method, ndraw, geo, tpoints, tmask, npts)
        member, v, logl = filter_stage(u, mult_ok, geo, tpoints, tmask,
                                       self.transform, self.loglike)
        u, v, logl, n_acc, nc = compact_classic(
            u, v, logl, member, _f32(Lmin), budget, kreturn)
        rows = torch.cat([u, v, logl[:, None]], dim=1)
        scal = torch.zeros((1, rows.shape[1]), dtype=torch.float32,
                           device=self.device)
        scal[0, 0] = nc
        scal[0, 1] = n_acc
        return torch.cat([rows, scal]), nc

    def _launch(self, region, Lmin, ndraw, tregion=None, method=None,
                naccept_budget=None):
        ndraw = round_up(ndraw, 128)
        inputs = self._inputs(region, tregion, method, naccept_budget)
        seed = self._next_seed()
        if self.nshards == 1:
            pack, _ = self._propose(seed, inputs, Lmin, ndraw, MAX_RETURN)
            counts = None
        else:
            # each shard's block of rows and its [nc, n_acc] row,
            # gathered; the billed counts summed exactly in int64
            pack, nc = self._propose(seed, inputs, Lmin,
                                     max(128, ndraw // self.nshards),
                                     max(16, MAX_RETURN // self.nshards))
            pack = all_gather_rows(pack, self.mesh, self.axis_name)
            counts = start_fetch(psum(nc, self.mesh, self.axis_name))
        return (start_fetch(pack), counts, pack.shape[1] - self.x_dim - 1,
                ndraw)

    def _unpack(self, handle, counts, num_params, ndraw):
        packed = finish_fetch(handle).astype(float)
        x_dim = self.x_dim
        # one block of rows and a scalar row per shard
        blocks = packed.reshape(self.nshards, -1, packed.shape[1])
        keep = [block[:min(int(block[-1, 1]), len(block) - 1)]
                for block in blocks]
        rows = np.concatenate(keep)
        nc = int(blocks[0, -1, 0]) if counts is None \
            else int(finish_fetch(counts))
        u = rows[:, :x_dim]
        v = rows[:, x_dim:x_dim + num_params]
        logl = rows[:, -1]
        # guard against f32 rounding to the cube boundary
        np.clip(u, 1e-7, 1 - 1e-7, out=u)
        return u, v, logl, nc, ndraw

    # --- segment mode --------------------------------------------------
    # Driven by integrator._explore_segments: the live set chains on the
    # device and each dispatch draws a candidate batch AND consumes it
    # (segmentops.consume_scan). The whitened live points for the
    # membership test are recomputed from the device live set every
    # dispatch.

    segment_capable = True
    # the p-space WrappingEllipsoid filter is part of filter_stage, so
    # non-affine transforms keep segments
    segment_tregion_ok = True

    def segment_ok(self):
        """Whether segment mode should drive this sampler.

        Default on for a CUDA device and off for the CPU, as the
        reference does for accelerator and CPU backends. Override with
        ``sampler.fused_sampler.segment_enabled = True/False``. Never on
        a mesh of more than one shard (``fused.py:637``): a sharded
        rejection run takes the classic budgeted path with prefetch.
        """
        enabled = getattr(self, 'segment_enabled', None)
        if enabled is None:
            enabled = self.device.type != 'cpu'
        return enabled and self.nshards == 1

    def segment_start(self, us, Ls, ndraw=4096):
        """Upload live state and reset the dispatch queue."""
        nlive, d = us.shape
        assert d == self.x_dim
        self._seg_nlive = nlive
        self._seg_npad = round_up(nlive)
        # batch size: the caller's request, raised to the engine's own
        # learned preference (see segment_fetch); the cap is the
        # reference's TPU-tuned value, to be measured again on the GPU
        self._seg_ndraw_max = 1 << (14 if self.device.type == 'cpu'
                                    else 17)
        pref = min(getattr(self, '_seg_ndraw_pref', 0), self._seg_ndraw_max)
        self._seg_ndraw = round_up(max(int(ndraw), 512, pref), 128)
        lu = pad_rows(np.asarray(us, np.float32), self._seg_npad)
        lL = pad_rows(np.asarray(Ls, np.float32), self._seg_npad,
                      fill=np.inf)
        self._seg_state = (torch.as_tensor(lu).to(self.device),
                           torch.as_tensor(lL).to(self.device))
        self._seg_queue = []
        self._seg_method_i = 0
        self._pending = []        # classic prefetch superseded

    def segment_launch(self, region, tregion=None):
        """Dispatch one chained draw+consume segment (does not wait).
        Books its parts in the run in progress (:func:`tracing.lap`):
        ``geometry``, ``draw``, ``filter`` and ``tail``."""
        geo = region_geometry(region, self.x_dim, tregion, self.device)
        method = METHOD_CYCLE[self._seg_method_i % len(METHOD_CYCLE)]
        if geo['kind'] != 'mlfriends' and method == METHOD_POINTS:
            method = METHOD_ELLIPSOID
        nlive, ndraw = self._seg_nlive, self._seg_ndraw
        live_u, live_L = self._seg_state
        Lmin0 = live_L.min()          # padding is +inf
        tmask = (torch.arange(live_L.shape[0], device=self.device)
                 < nlive).to(torch.int32)
        tpoints = (torch.where(tmask[:, None] != 0, live_u, 0.0)
                   - geo['ctr']) @ geo['T']
        tracing.lap('geometry')
        self._seed_dispatch()
        u, mult_ok = self.draw(method, ndraw, geo, tpoints, tmask, nlive)
        tracing.lap('draw')
        member, _, logl = filter_stage(u, mult_ok, geo, tpoints, tmask,
                                       self.transform, self.loglike)
        tracing.lap('filter')
        u, logl, valid, nc = compact_segment(
            u, logl, member, Lmin0, max(64, nlive // 2),
            min(MAX_RETURN, ndraw))
        live_u2, live_L2, recs = consume_scan(live_u, live_L, u, logl, valid)
        self._seg_state = (live_u2, live_L2)
        packed = pack_segment(u, logl, recs, nc.to(torch.float32),
                              valid.mean(), torch.zeros_like(Lmin0))
        self._seg_queue.append(start_fetch(packed))
        tracing.lap('tail')

    def segment_fetch(self):
        """Wait for the oldest queued segment; returns parsed records."""
        raw = finish_fetch(self._seg_queue.pop(0))
        with tracing.count('parse'):
            return self._segment_parse(raw.astype(float))

    def _segment_parse(self, packed):
        """The records of a fetched segment (:meth:`segment_fetch`)."""
        d = self.x_dim
        rows, scal = packed[:-1], packed[-1]
        # guard against f32 rounding onto the cube boundary
        np.clip(rows[:, :d], 1e-7, 1 - 1e-7, out=rows[:, :d])
        flags = rows[:, d + 5]
        nc = int(scal[0])
        if nc < max(1, self._seg_ndraw // 200):
            # proposal strategy starved: rotate to the next method
            self._seg_method_i += 1
        # grow the batch when a dispatch cannot fill the acceptance
        # budget: extra draws are budget-capped in billing
        scan_cap = min(MAX_RETURN, max(128, self._seg_ndraw))
        navail = float(scal[1]) * scan_cap
        budget = max(64, self._seg_nlive // 2)
        if navail < 0.9 * budget and self._seg_ndraw < self._seg_ndraw_max:
            factor = min(4.0, 1.5 * budget / max(navail, 8.0))
            want = int(self._seg_ndraw * max(factor, 2.0))
            self._seg_ndraw_pref = min(want, self._seg_ndraw_max)
            self._seg_ndraw = round_up(self._seg_ndraw_pref, 128)
        return dict(
            u=rows[:, :d], L=rows[:, d],
            accept=rows[:, d + 1] > 0.5,
            worst=rows[:, d + 2].astype(np.int64),
            Lmin=rows[:, d + 3],
            rank=rows[:, d + 4].astype(np.int64),
            plateau=flags >= 2, dup=(flags % 2) >= 1,
            nc=nc, done_frac=float(scal[1]), width=float(scal[2]))

    def segment_pending(self):
        """Number of dispatches in flight (``fused.py:774-777``): launched
        and not yet fetched; 0 outside segment mode."""
        q = getattr(self, '_seg_queue', None)
        return len(q) if q else 0

    def segment_stop(self):
        """Leave segment mode, dropping device state and queued work."""
        self._seg_state = None
        self._seg_queue = None
