# noqa: D400 D205
"""
Nested sampling integrators
---------------------------

The samplers of the PyTorch port: counterparts of
``ReactiveNestedSampler`` and the textbook ``NestedSampler`` in
``ultranest_tpu/integrator.py``, with the same run options, results
dicts and run-directory files.

The data-dependent outer loop stays on the host. For a model with a
torch likelihood (``torch_loglike=``), candidate proposal, region
filtering (CUDA kernel K1), transform and likelihood run as one chain of
device work per dispatch (:class:`ultranest_torch.fused.FusedRegionSampler`);
in segment mode (the default on a CUDA device) each dispatch also
consumes its batch into the device live set (kernel K3), and the host
replays the records. Region rebuilds bootstrap the MLFriends radius in
kernel K2 on the same device. A step sampler set as ``sampler.stepsampler``
(:class:`ultranest_torch.popfused.FusedPopulationSliceSampler` with its
spec, async and sync engines, or
:class:`ultranest_torch.popfused.FusedPopulationRandomWalkSampler`) takes
the place of the region proposal, with the same segment path. Accepted
points are re-checked in f64 on the host before they enter the tree.
A host step sampler of :mod:`ultranest_torch.stepsampler` (one
likelihood call per step, numpy on the host) walks in the same regions:
their rebuilds, and the region queries the sampler makes, run on the
sampler's device. :class:`NestedSampler` is the fixed-live-point sampler;
its loop is host numpy and its regions are built on its device.
``plot()`` writes the corner, run and trace plots
(:mod:`ultranest_torch.plot`).

Stored runs: :func:`read_file` recomputes the logZ sequence of a run
directory, ``resume='resume-similar'`` salvages a stored run for a
modified likelihood (both need h5py: they read HDF5 point stores), and
:func:`warmstart_from_similar_file` deforms the prior around a previous
posterior (:mod:`ultranest_torch.hotstart`). The file formats are the
JAX package's, so either package reads the other's run directories.
A dispatch that misses its deadline (``ULTRANEST_TORCH_DISPATCH_DEADLINE``,
:mod:`ultranest_torch.parallel.launch`) degrades the run to the host path.

Multi-device runs: with ``mesh=`` (:mod:`ultranest_torch.parallel`),
one process per rank runs this whole sampler; candidate generation and
the bootstrap radius rounds are sharded over the ranks, everything else
is identical on every rank.
"""

import csv
import json
import os
import sys
import time
import warnings

import numpy as np
import torch
from numpy import exp, log
from numpy import logaddexp

from .fused import FusedRegionSampler
from .fused import METHOD_CYCLE

from .mlfriends import AffineLayer
from .mlfriends import LocalAffineLayer
from .mlfriends import MLFriends
from .mlfriends import RobustEllipsoidRegion  # noqa: F401 (re-export)
from .mlfriends import ScalingLayer
from .mlfriends import SimpleRegion  # noqa: F401 (re-export)
from .mlfriends import WrappingEllipsoid
from .mlfriends import find_nearby  # noqa: F401 (re-export)
from .netiter import BreadthFirstIterator  # noqa: I100 (grouped imports)
from .netiter import MultiCounter
from .netiter import PointPile
from .netiter import SingleCounter
from .netiter import TreeNode
from .netiter import combine_results
from .netiter import count_tree_between
from .netiter import dump_tree
from .netiter import find_nodes_before
from .netiter import logz_sequence
from .netiter import replay_sequence
from .ops.pairwise import match_clusters
from .ordertest import UniformOrderAccumulator
from .parallel import check_mesh
from .parallel.launch import DeviceLostError
from .parallel.strategy import bootstrap_kl_table
from .store import HDF5PointStore
from .store import NullPointStore
from .store import TextPointStore
from .utils import create_logger
from .utils import is_affine_transform
from .utils import listify as _listify
from .utils import make_run_dir
from .utils import normalised_kendall_tau_distance
from .utils import resample_equal
from .utils import vectorize
from .utils import vol_prefactor
from .viz import get_default_viz_callback

__all__ = ['ReactiveNestedSampler', 'NestedSampler', 'read_file',
           'warmstart_from_similar_file']

int_t = np.int64


def _next_pow2(n):
    """Smallest power of two >= n (batch-size bucketing)."""
    return 1 << (int(n) - 1).bit_length()


def _quantile_window(pi, tail):
    """Index interval [ilo, ihi] covering all but *tail* probability.

    *ilo* is the first index whose cumulative probability reaches *tail*;
    *ihi* the last one still below ``1 - tail``.
    """
    cum = np.cumsum(pi)
    ilo = int(np.searchsorted(cum, tail, side='left'))
    ihi = int(np.searchsorted(cum, 1.0 - tail, side='right')) - 1
    return min(ilo, len(cum) - 1), ihi


def _width_plan(required_widths, floor):
    """Flatten (Llo, Lhi, width) requirements into an (L, width) schedule.

    Any likelihood value covered by a requirement interval must carry at
    least that interval's width; everything carries at least *floor*.
    Dips between requirements are filled so the schedule rises
    monotonically into its peak from both ends.
    """
    knots = np.unique(np.concatenate((
        [-np.inf, np.inf],
        [iv[0] for iv in required_widths],
        [iv[1] for iv in required_widths])).astype(float))
    need = np.full(knots.shape, float(floor))
    for Llo, Lhi, width in required_widths:
        covered = (knots >= Llo) & (knots <= Lhi)
        need[covered] = np.maximum(need[covered], width)

    peak = int(np.argmax(need))
    need[:peak + 1] = np.maximum.accumulate(need[:peak + 1])
    need[peak:] = np.maximum.accumulate(need[peak:][::-1])[::-1]
    return list(zip(knots, need))


class _StoredRun:
    """Replay access to stored run rows ``(Lmin, L, quality, u.., v..)``.

    The threshold-pop logic shared by :func:`read_file` and
    :func:`resume_from_similar_file` (``ultranest_tpu/integrator.py:137-171``).
    """

    def __init__(self, rows, x_dim, num_params):
        self.remaining = list(enumerate(np.asarray(rows)))
        self.x_dim = x_dim
        self.num_params = num_params
        self.total = len(self.remaining)

    def pop(self, Lmin):
        """Remove and return the first row whose arc spans *Lmin*."""
        for i, (idx, row) in enumerate(self.remaining):
            if row[0] <= Lmin < row[1]:
                return self.remaining.pop(i)
        return None, None

    def unpack(self, row):
        """Split a raw row into (u, v, logl)."""
        d = self.x_dim
        return (row[3:3 + d],
                row[3 + d:3 + d + self.num_params],
                row[1])

    def pop_initial(self):
        """Yield (u, v, logl) of all stored prior samples, consuming them."""
        while True:
            _, row = self.pop(-np.inf)
            if row is None:
                return
            yield self.unpack(row)


# options accepted by ReactiveNestedSampler.run / .run_iter, with their
# defaults. run_iter, meant for hands-on stepping, disables the
# insertion-order alarm by default (wide window, loose threshold).
_RUN_OPTION_DEFAULTS = dict(
    update_interval_volume_fraction=0.8, update_interval_ncall=None,
    log_interval=None, show_status=True, viz_callback='auto',
    dlogz=0.5, dKL=0.5, frac_remain=0.01, Lepsilon=0.001, min_ess=400,
    max_iters=None, max_ncalls=None, max_num_improvement_loops=-1,
    min_num_live_points=400, cluster_num_live_points=40,
    insertion_test_zscore_threshold=4, insertion_test_window=10,
    region_class=MLFriends,
    widen_before_initial_plateau_num_warn=10000,
    widen_before_initial_plateau_num_max=50000,
)
_RUN_ITER_OVERRIDES = dict(
    insertion_test_zscore_threshold=2, insertion_test_window=10000,
)


def _resolve_run_options(given, interactive):
    """Merge user-supplied run options over the defaults table."""
    options = dict(_RUN_OPTION_DEFAULTS)
    if interactive:
        options.update(_RUN_ITER_OVERRIDES)
    unknown = sorted(set(given) - set(options))
    if unknown:
        raise TypeError('unexpected run option(s): %s' % ', '.join(unknown))
    options.update(given)
    return options


class _PassState:
    """Mutable book-keeping of one exploration pass.

    Groups the tree walker, the (1+nbootstraps)-estimator bank, the
    insertion-rank test and the efficiency/status counters so the pass
    methods of :class:`ReactiveNestedSampler` can hand state around
    explicitly instead of through one giant loop body.
    """

    __slots__ = (
        'nroots', 'log_interval', 'explorer', 'main_iterator',
        'insertion_test', 'insertion_test_runs', 'insertion_test_quality',
        'insertion_test_direction', 'ndraw', 'it', 'it_at_first_region',
        'ncall_at_run_start', 'ncall_region_at_run_start',
        'next_update_interval_volume', 'last_status', 'region_sequence',
        'nclusters', 'saved_nodeids', 'saved_logl',
        'minimal_widths_sequence')



def _load_stored_run(log_dir, x_dim):
    """Load the raw point table of a stored run from *log_dir*."""
    import h5py
    filepath = os.path.join(log_dir, 'results', 'points.hdf5')
    with h5py.File(filepath, 'r') as fileobj:
        _, ncols = fileobj['points'].shape
        rows = fileobj['points'][:]
    return _StoredRun(rows, x_dim, ncols - 3 - x_dim), filepath, ncols


def _walk_stored_tree(explorer, stored, pointpile, batchsize):
    """Advance *explorer* through the stored run, in likelihood order.

    Yields lists of ``(Lmin, live_values, replacements)`` where
    *replacements* holds the (u, v, logl) tuples entering at that node.
    """
    pending = []
    while True:
        visit = explorer.next_node()
        if visit is None:
            break
        rootid, node, (_, _, live_values, _) = visit
        entering = []
        _, row = stored.pop(node.value)
        if row is not None:
            u, v, logl = stored.unpack(row)
            assert logl > node.value
            entering.append((u, v, logl))
            node.children.append(pointpile.make_node(logl, u, v))
        pending.append((node.value, live_values.copy(), entering))
        if len(pending) >= batchsize:
            yield pending
            pending = []
        explorer.expand_children_of(rootid, node)
    if pending:
        yield pending


def resume_from_similar_file(log_dir, x_dim, loglikelihood, transform,
                             max_tau=0, verbose=False, ndraw=400):
    """Adapt a stored run to a modified likelihood function in place.

    Replays the stored tree while re-evaluating the new likelihood; keeps
    iterating as long as the live point order stays within *max_tau*
    normalised Kendall tau distance of the stored order, then truncates.

    Parameters
    ----------
    log_dir: str
        run directory containing ``results/points.hdf5``
    x_dim: int
        dimensionality
    loglikelihood, transform: functions
        new vectorized model functions
    max_tau: float
        0 (conservative) .. 1 (negligent) allowed live-point disorder
    verbose: bool or int
        progress reporting
    ndraw: int
        likelihood evaluation batch size
    """
    stored, filepath, ncols = _load_stored_run(log_dir, x_dim)
    scratch_path = filepath + '.new'
    rewritten = HDF5PointStore(scratch_path, ncols, mode='w')

    old_pile = PointPile(x_dim, stored.num_params)
    new_pile = PointPile(x_dim, stored.num_params)

    def check_transform(u_batch, v_stored):
        v_now = transform(np.array(u_batch, ndmin=2, dtype=float))
        assert np.allclose(v_now, v_stored), \
            'transform inconsistent, cannot resume'
        return v_now

    init = list(stored.pop_initial())
    init_u = [u for u, _, _ in init]
    init_v = check_transform(init_u, [v for _, v, _ in init])
    init_logl_new = loglikelihood(init_v)

    old_roots, new_roots = [], []
    for (u, v, logl_old), logl_new in zip(init, init_logl_new):
        old_roots.append(old_pile.make_node(logl_old, u, v))
        new_roots.append(new_pile.make_node(logl_new, u, v))
        rewritten.add(_listify([-np.inf, logl_new, 0.0], u, v), 1)

    old_walk = BreadthFirstIterator(old_roots)
    new_walk = BreadthFirstIterator(new_roots)
    counter = SingleCounter()
    counter.Lmax = init_logl_new.max()

    # salvage horizon: advance it while old and new likelihood agree on
    # the live point ordering, freeze it on first divergence
    consistent = True
    horizon_like = -1e300
    horizon_iter = 0
    bump = 1 + 1e-6
    niter = 0

    for batch in _walk_stored_tree(old_walk, stored, old_pile, ndraw):
        flat = [uvl for _, _, entering in batch for uvl in entering]
        if flat:
            v_batch = check_transform([u for u, _, _ in flat],
                                      [v for _, v, _ in flat])
            batch_logl_new = loglikelihood(v_batch)
        else:
            batch_logl_new = []

        consumed = 0
        for _Lmin_old, live_old, entering in batch:
            rootid2, node2, (live_nodes2, _, live_new, _) = \
                new_walk.next_node()
            Lmin_new = float(node2.value)

            if len(live_old) != len(live_new):
                if verbose == 2:
                    print("stopping, number of live points differ (%d vs %d)"
                          % (len(live_old), len(live_new)))
                consistent = False
                break

            tau = normalised_kendall_tau_distance(live_old, live_new)
            if tau > max_tau:
                consistent = False
            elif len(live_old) > 10:
                consistent = True
            if not consistent:
                # pretend likelihood keeps increasing slightly, hoping
                # the divergence stays below the local step size
                node2.value = horizon_like
                horizon_like = horizon_like * bump
                break
            horizon_like = Lmin_new
            horizon_iter = niter

            for u, v, _logl_old in entering:
                logl_new = batch_logl_new[consumed]
                consumed += 1
                node2.children.append(new_pile.make_node(logl_new, u, v))
                if logl_new > Lmin_new:
                    rewritten.add(
                        _listify([Lmin_new, logl_new, 0.0], u, v), 1)

            counter.passing_node(node2, live_nodes2)
            niter += 1
            if verbose:
                sys.stderr.write("%d...\r" % niter)
            new_walk.expand_children_of(rootid2, node2)

        if not consistent:
            break

    if verbose:
        sys.stderr.write("%d/%d iterations salvaged (%.2f%%).\n" % (
            horizon_iter + 1, stored.total,
            (horizon_iter + 1) * 100.0 / stored.total))

    # truncate the rewritten store to the salvageable part and swap it in
    table = rewritten.fileobj['points']
    keep = table[:][table[:, 0] <= horizon_like, :]
    del rewritten.fileobj['points']
    rewritten.fileobj.create_dataset(
        'points', dtype=np.float64,
        shape=(0, rewritten.ncols), maxshape=(None, rewritten.ncols))
    rewritten.fileobj['points'].resize(len(keep), axis=0)
    rewritten.fileobj['points'][:] = keep
    rewritten.close()
    os.replace(scratch_path, filepath)


def _update_region_bootstrap(region, nbootstraps, minvol=0.0, rng=np.random,
                             mesh=None):
    """Refresh *region* radius/enlargement by bootstrapping.

    The radius rounds run in kernel K2 on the region's device; with a
    mesh they are split over its shards and max-reduced.
    LinAlgError propagates to the caller, which keeps the previous region.
    """
    assert nbootstraps > 0, nbootstraps
    region.maxradiussq, region.enlarge = region.compute_enlargement(
        minvol=minvol, nbootstraps=nbootstraps, rng=rng, mesh=mesh)
    return region.maxradiussq, region.enlarge


class NestedSampler:
    """Textbook fixed-live-point nested sampler.

    The loop, the likelihood and the candidate draws are host numpy, as
    in the reference package, so a seeded run is the reference's run.
    The MLFriends region is built on *device*: each rebuild bootstraps
    its radius in kernel K2 there.
    """

    def __init__(self, param_names, loglike, transform=None,
                 derived_param_names=[], resume='subfolder', run_num=None,
                 log_dir='logs/test', num_live_points=1000,
                 vectorized=False, wrapped_params=[], seed=None,
                 device='cuda'):
        """Set up the fixed-N nested sampler.

        Parameters
        ----------
        param_names: list of str
            parameter names; length sets the dimensionality
        loglike: function
            vectorized log-likelihood (if *vectorized*)
        transform: function or None
            vectorized unit-cube-to-physical transform
        derived_param_names: list of str
            extra columns returned by transform
        log_dir: str
            output directory
        resume: 'resume', 'overwrite' or 'subfolder'
            resume behaviour
        wrapped_params: list of bools
            circular parameter flags
        num_live_points: int
            number of live points
        vectorized: bool
            whether user functions accept arrays of points
        run_num: int or None
            subfolder number
        seed: int or None
            seed for the sampler's private RNG (None: global numpy RNG)
        device: str or torch.device
            where the regions are built and the bootstrap radius kernel
            runs ('cuda' by default; the tests pass 'cpu')
        """
        self.device = torch.device(device)
        self.paramnames = list(param_names)
        self.x_dim = len(self.paramnames)
        self.derivedparamnames = derived_param_names
        self.num_params = self.x_dim + len(derived_param_names)
        self.num_live_points = num_live_points
        self.sampler = 'nested'
        self.volfactor = vol_prefactor(self.x_dim)
        self.rng = np.random.RandomState(seed) \
            if seed is not None else np.random
        self.wrapped_axes = [] if wrapped_params is None \
            else np.where(wrapped_params)[0]

        assert resume or resume in ('overwrite', 'subfolder', 'resume'), \
            "resume should be one of 'overwrite' 'subfolder' or 'resume'"
        if not vectorized:
            loglike = vectorize(loglike)
            if transform is not None:
                transform = vectorize(transform)
        self.transform = transform if transform is not None else (lambda x: x)
        self._validate_model(loglike)

        def safe_loglike(x):
            """Evaluate likelihood, asserting finiteness."""
            logl = loglike(np.asarray(x))
            assert np.isfinite(logl).all(), (
                'User-provided loglikelihood returned non-finite value')
            return logl

        self.loglike = safe_loglike

        self.use_mpi = False
        self.comm = None
        self.mpi_size = 1
        self.mpi_rank = 0

        self.log = True
        self.log_to_disk = log_dir is not None
        if self.log_to_disk:
            self.logs = make_run_dir(log_dir, run_num,
                                     append_run_num=resume == 'subfolder')
            log_dir = self.logs['run_dir']
        else:
            log_dir = None
        self.logger = create_logger(
            __name__ + '.' + type(self).__name__, log_dir=log_dir)
        self.logger.info('Num live points [%d]', self.num_live_points)

        ncols = 3 + self.x_dim + self.num_params
        if self.log_to_disk:
            mode = 'a' if resume is True or resume == 'resume' else 'w'
            self.pointstore = HDF5PointStore(
                os.path.join(self.logs['results'], 'points.hdf5'),
                ncols, mode=mode)
        else:
            self.pointstore = NullPointStore(ncols)

    def _validate_model(self, loglike):
        """Probe the user functions once with two random points."""
        u = self.rng.uniform(size=(2, self.x_dim))
        p = self.transform(u)
        assert p.shape == (2, self.num_params), (
            "Error in transform function: returned shape is %s, expected %s"
            % (p.shape, (2, self.num_params)))
        logl = loglike(p)
        assert np.logical_and(u > 0, u < 1).all(), (
            "Error in transform function: u was modified!")
        assert np.shape(logl) == (2,), (
            "Error in loglikelihood function: returned shape is %s"
            % str(np.shape(logl)))
        assert np.isfinite(logl).all(), (
            "Error in loglikelihood function: returned non-finite values")

    def _initial_live_points(self):
        """Replay stored prior samples, then fill up from the prior.

        Returns (u, v, logl, n_fresh) where *n_fresh* counts new
        likelihood evaluations.
        """
        stored_u, stored_v, stored_logl = [], [], []
        for _ in range(self.num_live_points):
            _, row = self.pointstore.pop(-np.inf)
            if row is None:
                break
            stored_u.append(row[3:3 + self.x_dim])
            stored_v.append(row[3 + self.x_dim:
                                3 + self.x_dim + self.num_params])
            stored_logl.append(row[1])

        nfresh = self.num_live_points - len(stored_logl)
        if nfresh == 0:
            return (np.array(stored_u), np.array(stored_v),
                    np.array(stored_logl), 0)

        fresh_u = self.rng.uniform(size=(nfresh, self.x_dim))
        fresh_v = self.transform(fresh_u)
        fresh_logl = self.loglike(fresh_v)
        if self.log_to_disk:
            for i in range(nfresh):
                self.pointstore.add(
                    _listify([-np.inf, fresh_logl[i], 0.0],
                             fresh_u[i, :], fresh_v[i, :]), nfresh)
        if stored_u:
            fresh_u = np.concatenate((np.array(stored_u), fresh_u))
            fresh_v = np.concatenate((np.array(stored_v), fresh_v))
            fresh_logl = np.concatenate((np.array(stored_logl), fresh_logl))
        return fresh_u, fresh_v, fresh_logl, nfresh

    def _pop_stored_candidate(self, loglstar):
        """Next stored candidate row for threshold *loglstar*, as a batch.

        Returns (u, v, logl) arrays of length one; logl is -inf when the
        store has nothing left for this threshold.
        """
        row_buf = np.full((1, 3 + self.x_dim + self.num_params), -np.inf)
        if self.log_to_disk:
            _, stored = self.pointstore.pop(loglstar)
            if stored is not None:
                row_buf[0, :] = stored
            self._replaying = not self.pointstore.stack_empty
        else:
            # nothing is stored without a run directory (the reference
            # replays rows of zeros there and never ends)
            self._replaying = False
        return (row_buf[:, 3:3 + self.x_dim],
                row_buf[:, 3 + self.x_dim:3 + self.x_dim + self.num_params],
                row_buf[:, 1])

    def _sample_candidates(self, region, loglstar, ndraw):
        """Draw one region-bounded candidate batch and evaluate it.

        Returns (u, v, logl, ncall) with only region members kept (every
        member costs one likelihood call, accepted or not).
        """
        u = region.sample(nsamples=ndraw, rng=self.rng)
        if u.shape[0] == 0:
            return u, np.empty((0, self.x_dim)), np.empty((0,)), 0
        v = self.transform(u)
        logl = self.loglike(v)
        self._ncall += u.shape[0]
        keep = logl > loglstar
        if self.log:
            for ui, vi, logli in zip(u[keep], v[keep], logl[keep]):
                self.pointstore.add(
                    _listify([loglstar, logli, 0.0], ui, vi), self._ncall)
        return u[keep, :], v[keep, :], logl[keep], u.shape[0]

    def _rebuild_region(self, region, transformLayer, active_u, it,
                        first_time):
        """Bootstrap a fresh region; keep the old one unless volume shrank."""
        if first_time:
            candidate = region
        else:
            layer = transformLayer.create_new(active_u, region.maxradiussq,
                                              device=self.device)
            candidate = MLFriends(active_u, layer, device=self.device)
        _update_region_bootstrap(candidate, 30, 0.0, rng=self.rng)
        if candidate.estimate_volume() < region.estimate_volume():
            region = candidate
        region.create_ellipsoid(
            minvol=exp(-it / self.num_live_points) * self.volfactor)
        return region

    def run(self, update_interval_iter=None, update_interval_ncall=None,
            log_interval=None, dlogz=0.001, max_iters=None):
        """Run until the remainder fraction falls below *dlogz*.

        Returns a results dict with samples, weighted_samples, ncall,
        niter, logz and logzerr.
        """
        if update_interval_ncall is None:
            update_interval_ncall = max(1, round(self.num_live_points))
        if update_interval_iter is None:
            update_interval_iter = max(1, round(
                self.num_live_points
                if update_interval_ncall == 0
                else 0.2 * self.num_live_points))
        if log_interval is None:
            log_interval = max(1, round(0.2 * self.num_live_points))
        else:
            log_interval = round(log_interval)
            if log_interval < 1:
                raise ValueError("log_interval must be >= 1")

        viz_callback = get_default_viz_callback()
        active_u, active_v, active_logl, nfresh = self._initial_live_points()
        self._ncall = nfresh
        self._replaying = True

        # dead point columns, in removal order
        dead_u, dead_v, dead_logl, dead_logwt = [], [], [], []
        h = 0.0
        logz = -1e300
        logvol = log(1.0 - exp(-1.0 / self.num_live_points))
        logz_remain = np.max(active_logl)

        if self.x_dim > 1:
            transformLayer = AffineLayer(wrapped_dims=self.wrapped_axes)
        else:
            transformLayer = ScalingLayer(wrapped_dims=self.wrapped_axes)
        transformLayer.optimize(active_u, active_u)
        region = MLFriends(active_u, transformLayer, device=self.device)

        self.logger.info('Starting sampling ...')
        buf_u = buf_v = buf_logl = np.empty((0,))
        buf_pos = 0
        ndraw = 128
        it = 0
        first_region = True
        rebuild_at_ncall = -1
        rebuild_at_iter = -1

        while max_iters is None or it < max_iters:
            # shrink: move the worst live point to the dead list
            worst = np.argmin(active_logl)
            loglstar = active_logl[worst]
            logwt = logvol + loglstar
            logz_new = np.logaddexp(logz, logwt)
            h = (exp(logwt - logz_new) * loglstar
                 + exp(logz - logz_new) * (h + logz) - logz_new)
            logz = logz_new
            dead_u.append(np.array(active_u[worst]))
            dead_v.append(np.array(active_v[worst]))
            dead_logwt.append(logwt)
            dead_logl.append(loglstar)

            if self._ncall > rebuild_at_ncall and it > rebuild_at_iter:
                region = self._rebuild_region(
                    region, transformLayer, active_u, it, first_region)
                transformLayer = region.transformLayer
                first_region = False
                rebuild_at_ncall = self._ncall + update_interval_ncall
                rebuild_at_iter = it + update_interval_iter
                if self.log:
                    viz_callback(
                        points=dict(u=active_u, p=active_v,
                                    logl=active_logl),
                        info=dict(
                            it=it, ncall=self._ncall, logz=logz,
                            logz_remain=logz_remain,
                            paramnames=self.paramnames
                            + self.derivedparamnames,
                            logvol=logvol),
                        region=region, transformLayer=transformLayer)
                    self.pointstore.flush()

            # refill the candidate buffer until one clears the threshold
            accepted = False
            while not accepted:
                if buf_pos >= len(buf_logl) and self._replaying:
                    buf_u, buf_v, buf_logl = \
                        self._pop_stored_candidate(loglstar)
                    buf_pos = 0 if np.isfinite(buf_logl[0]) else 1
                while buf_pos >= len(buf_logl):
                    buf_u, buf_v, buf_logl, _nc = self._sample_candidates(
                        region, loglstar, ndraw)
                    buf_pos = 0
                if buf_logl[buf_pos] > loglstar:
                    accepted = True
                    active_u[worst] = buf_u[buf_pos, :]
                    active_v[worst] = buf_v[buf_pos, :]
                    active_logl[worst] = buf_logl[buf_pos]
                    # keep the region tracking the live points
                    region.u[worst, :] = active_u[worst]
                    region.unormed[worst, :] = \
                        region.transformLayer.transform(active_u[worst])
                    transformLayer.clusterids[worst] = 0
                buf_pos += 1

            logvol -= 1.0 / self.num_live_points
            logz_remain = np.max(active_logl) - it / self.num_live_points
            fraction_remain = np.logaddexp(logz, logz_remain) - logz

            if it % log_interval == 0 and self.log:
                sys.stdout.write(
                    'Z=%.1g+%.1g | Like=%.1g..%.1g | it/evals=%d/%d '
                    'eff=%.4f%%  \r'
                    % (logz, logz_remain, loglstar, np.max(active_logl),
                       it, self._ncall,
                       np.inf if self._ncall == 0
                       else it * 100 / self._ncall))
                sys.stdout.flush()
                ndraw = _next_pow2(max(128, min(
                    16384, round((self._ncall + 1) / (it + 1)))))

            if fraction_remain < dlogz:
                break
            it = it + 1

        # absorb the remaining live points into the integral
        logvol = -len(dead_v) / self.num_live_points \
            - log(self.num_live_points)
        for i in range(self.num_live_points):
            logwt = logvol + active_logl[i]
            logz_new = np.logaddexp(logz, logwt)
            h = (exp(logwt - logz_new) * active_logl[i]
                 + exp(logz - logz_new) * (h + logz) - logz_new)
            logz = logz_new
            dead_u.append(np.array(active_u[i]))
            dead_v.append(np.array(active_v[i]))
            dead_logwt.append(logwt)
            dead_logl.append(active_logl[i])

        dead_u = np.array(dead_u)
        dead_v = np.array(dead_v)
        dead_wt = exp(np.array(dead_logwt) - logz)
        dead_logl = np.array(dead_logl)
        logzerr = np.sqrt(h / self.num_live_points)

        if self.log_to_disk:
            with open(os.path.join(self.logs['results'], 'final.csv'),
                      'w') as f:
                writer = csv.writer(f)
                writer.writerow(['niter', 'ncall', 'logz', 'logzerr', 'h'])
                writer.writerow([it + 1, self._ncall, logz, logzerr, h])
            self.pointstore.close()

        print()
        print("niter: {:d}\n ncall: {:d}\n nsamples: {:d}\n"
              " logz: {:6.3f} +/- {:6.3f}\n h: {:6.3f}"
              .format(it + 1, self._ncall, len(dead_v), logz, logzerr, h))

        self.results = dict(
            samples=resample_equal(dead_v, dead_wt / dead_wt.sum(),
                                   rstate=self.rng),
            ncall=self._ncall, niter=it, logz=logz, logzerr=logzerr,
            weighted_samples=dict(
                upoints=dead_u, points=dead_v, weights=dead_wt,
                logweights=dead_logwt, logl=dead_logl),
        )
        return self.results

    def print_results(self):
        """Print a summary of the evidence and parameter posteriors."""
        print()
        print('logZ = %(logz).3f +- %(logzerr).3f' % self.results)
        print()
        for i, p in enumerate(self.paramnames + self.derivedparamnames):
            col = self.results['samples'][:, i]
            sigma = col.std()
            med = col.mean()
            j = 3 if sigma == 0 else max(
                0, int(-np.floor(np.log10(sigma))) + 1)
            fmt = '%%.%df' % j
            print(('    %-20s' + fmt + " +- " + fmt) % (p, med, sigma))

    def plot(self):
        """Write a corner plot to the plots directory."""
        if self.log_to_disk:
            import matplotlib.pyplot as plt

            from .plot import cornerplot
            # the classic results dict carries no parameter names (the
            # reference's plot() fails on that)
            cornerplot(dict(self.results, paramnames=self.paramnames
                            + self.derivedparamnames))
            plt.savefig(os.path.join(self.logs['plots'], 'corner.pdf'),
                        bbox_inches='tight')
            plt.close()


def warmstart_from_similar_file(usample_filename, param_names, loglike,
                                transform, vectorized=False,
                                min_num_samples=50,
                                torch_loglike=None, torch_transform=None):
    """Build an accelerated auxiliary problem from a previous posterior.

    Loads ``chains/weighted_post_untransformed.txt`` of a previous run and
    deforms the prior around its posterior
    (:func:`ultranest_torch.hotstart.get_auxiliary_contbox_parameterization`),
    so a fresh run needs far fewer iterations. Passing *torch_loglike* /
    *torch_transform* attaches batched torch counterparts as ``.torch``
    attributes on the returned functions, so the warm-started sampler
    keeps the device path (``torch_loglike=aux_loglike.torch``,
    ``torch_transform=aux_transform.torch``).

    Returns
    -------
    aux_param_names: list
    aux_loglikelihood: function
    aux_transform: function
    vectorized: bool
    """
    from .hotstart import get_auxiliary_contbox_parameterization
    try:
        with open(usample_filename) as f:
            old_param_names = f.readline().lstrip('#').strip().split()
            auxiliary_usamples = np.loadtxt(f)
    except IOError:
        warnings.warn('not hot-resuming, could not load file "%s"'
                      % usample_filename, stacklevel=2)
        return param_names, loglike, transform, vectorized

    ulogl = auxiliary_usamples[:, 1]
    uweights_full = auxiliary_usamples[:, 0] * np.exp(ulogl - ulogl.max())
    mask = uweights_full > 0
    uweights = uweights_full[mask]
    uweights /= uweights.sum()
    upoints = auxiliary_usamples[mask, 2:]

    nsamples = len(upoints)
    if nsamples < min_num_samples:
        raise ValueError('file "%s" has too few samples (%d) to hot-resume'
                         % (usample_filename, nsamples))
    if old_param_names != ['weight', 'logl'] + list(param_names):
        raise ValueError(
            'file "%s" has parameters %s, expected %s, cannot hot-resume.'
            % (usample_filename, old_param_names, param_names))

    return get_auxiliary_contbox_parameterization(
        param_names, loglike=loglike, transform=transform,
        vectorized=vectorized, upoints=upoints, uweights=uweights,
        torch_loglike=torch_loglike, torch_transform=torch_transform)


class ReactiveNestedSampler:
    """Nested sampler with reactive exploration strategy.

    Adaptively adds live points where the evidence / posterior / effective
    sample size targets require them. Storage & resume capable.
    """

    def __init__(self, param_names, loglike, transform=None,
                 derived_param_names=[], wrapped_params=None,
                 resume='subfolder', run_num=None, log_dir=None,
                 num_test_samples=2, draw_multiple=True, num_bootstraps=30,
                 vectorized=False, ndraw_min=128, ndraw_max=65536,
                 storage_backend='hdf5', warmstart_max_tau=-1, seed=None,
                 torch_loglike=None, torch_transform=None, device='cuda',
                 mesh=None):
        """Initialise nested sampler.

        Parameters
        ----------
        param_names: list of str
            parameter names; length sets dimensionality
        loglike: function
            vectorized log-likelihood (if *vectorized*)
        transform: function or None
            vectorized unit-cube-to-physical transform
        derived_param_names: list of str
            extra columns returned by transform
        log_dir: str or None
            output directory (None: no storage)
        resume: 'resume', 'resume-similar', 'overwrite' or 'subfolder'
            resume behaviour; 'resume-similar' salvages stored points from a
            modified likelihood up to *warmstart_max_tau* disorder (HDF5
            run directories only, so it needs h5py)
        run_num: int or None
            subfolder number
        wrapped_params: list of bools or None
            circular parameter flags
        num_test_samples: int
            number of random points for the startup sanity check
        vectorized: bool
            whether user functions accept arrays of points
        draw_multiple: bool
            adapt batch size between ndraw_min/ndraw_max with inefficiency
        ndraw_min, ndraw_max: int
            candidate batch bounds (kept as powers of two on device)
        num_bootstraps: int
            number of bootstrap rounds for logZ estimators and regions
        storage_backend: str or object
            'hdf5', 'tsv', 'csv' or a point-store instance
        warmstart_max_tau: float
            allowed live-point disorder for resume-similar (0..1)
        seed: int or None
            seed for the sampler's private RNG (None: global numpy RNG)
        torch_loglike: function or None
            batched log-likelihood on torch tensors, (n, num_params) ->
            (n,). When given (together with *torch_transform* if a
            transform exists), candidate proposal, region filtering,
            transform and likelihood run on *device* in one chain of work
            per batch (:class:`ultranest_torch.fused.FusedRegionSampler`),
            instead of the host path through *loglike*. *loglike* must
            still be given: accepted points are re-checked with it in f64.
        torch_transform: function or None
            batched prior transform on torch tensors matching *transform*
        device: str or torch.device
            where the proposal path and the bootstrap radius kernel run
            ('cuda' by default; the tests pass 'cpu'). Nothing moves to
            another device behind the caller's back.
        mesh: torch.distributed.device_mesh.DeviceMesh or None
            shard the work over the ranks of a multi-process job
            (:mod:`ultranest_torch.parallel`; one process per rank, each
            running this whole sampler with the same *seed*): candidate
            generation of the *torch_loglike* path and the bootstrap
            radius rounds of every region rebuild. The tree, the live
            points and the strategy stay identical on every rank.
            Population step samplers take their own ``mesh=``.
        """
        self.paramnames = param_names
        self.derivedparamnames = derived_param_names
        self.x_dim = len(param_names)
        self.num_params = self.x_dim + len(derived_param_names)
        self.sampler = 'reactive-nested'
        self.num_bootstraps = int(num_bootstraps)
        self.transform_layer_class = ScalingLayer if self.x_dim == 1 \
            else LocalAffineLayer
        self.wrapped_axes = self._parse_wrapped(wrapped_params)
        self.rng = np.random.RandomState(seed) \
            if seed is not None else np.random

        # one program on every rank; sharded work goes over the mesh
        self.use_mpi = False
        self.mpi_size = 1
        self.mpi_rank = 0
        self.device = torch.device(device)
        self.mesh = check_mesh(mesh)[0]
        if mesh is not None and seed is None:
            raise ValueError('a run with mesh= needs a seed: every rank '
                             'must draw the same host streams')

        resume_modes = (True, 'overwrite', 'subfolder', 'resume',
                        'resume-similar')
        assert resume in resume_modes, (
            "resume should be one of 'overwrite' 'subfolder', 'resume' "
            "or 'resume-similar'")
        want_resume = resume in ('resume-similar', 'resume', True)

        self.log = True
        self.log_to_disk = self.log and log_dir is not None
        self.log_to_pointstore = self.log_to_disk
        # segment mode: also store candidates the host did not insert
        # (classic-path parity; see _log_segment_leftovers)
        self.store_segment_rejects = True
        if self.log_to_disk:
            self.logs = make_run_dir(log_dir, run_num,
                                     append_run_num=resume == 'subfolder')
            log_dir = self.logs['run_dir']
        else:
            log_dir = None
        if self.log:
            self.logger = create_logger('ultranest_torch', log_dir=log_dir)
            self.logger.debug(
                'ReactiveNestedSampler: dims=%d+%d, resume=%s, log_dir=%s, '
                'backend=%s, vectorized=%s, nbootstraps=%s, ndraw=%s..%s',
                self.x_dim, len(derived_param_names), resume, log_dir,
                storage_backend, vectorized, num_bootstraps, ndraw_min,
                ndraw_max)

        self.root = TreeNode(id=-1, value=-np.inf)
        self.pointpile = PointPile(self.x_dim, self.num_params)
        self._open_pointstore(storage_backend, want_resume)
        self.ncall = self.pointstore.ncalls
        self.ncall_region = 0

        if not vectorized:
            loglike = vectorize(loglike)
            if transform is not None:
                transform = vectorize(transform)
            draw_multiple = False
        self.draw_multiple = draw_multiple
        self.ndraw_min = ndraw_min
        self.ndraw_max = ndraw_max

        self.build_tregion = transform is not None
        if not self._check_likelihood_function(transform, loglike,
                                               num_test_samples):
            # stored likelihood values disagree with the function we got
            assert self.log_to_disk
            if resume == 'resume-similar':
                self._salvage_points(loglike, transform, warmstart_max_tau,
                                     storage_backend, vectorized, ndraw_min)
            elif want_resume:
                raise Exception(
                    "Cannot resume because loglikelihood function changed, "
                    "unless resume=resume-similar. To start from scratch, "
                    "delete '%s'." % log_dir)
        self._set_likelihood_function(transform, loglike, num_test_samples)
        self.stepsampler = None
        self._init_fused_sampler(torch_loglike, torch_transform, seed, mesh)

    def _parse_wrapped(self, wrapped_params):
        """Indices of circular parameters."""
        if wrapped_params is None:
            return []
        assert len(wrapped_params) == self.x_dim, (
            "wrapped_params has the number of entries:", wrapped_params,
            ", expected", self.x_dim)
        return np.where(wrapped_params)[0]

    def _open_pointstore(self, storage_backend, want_resume):
        """Attach the persistent point store (or a null store)."""
        ncols = 3 + self.x_dim + self.num_params
        if not self.log_to_pointstore:
            self.pointstore = NullPointStore(ncols)
            return
        if not isinstance(storage_backend, str):
            self.pointstore = storage_backend
            return
        path = os.path.join(self.logs['results'],
                            'points.' + storage_backend)
        if storage_backend == 'hdf5':
            self.pointstore = HDF5PointStore(
                path, ncols, mode='a' if want_resume else 'w')
        elif storage_backend in ('tsv', 'csv'):
            self.pointstore = TextPointStore(path, ncols)
            self.pointstore.delimiter = \
                ',' if storage_backend == 'csv' else '\n'
        else:
            raise ValueError('unknown storage_backend: %r'
                             % (storage_backend,))

    def _salvage_points(self, loglike, transform, warmstart_max_tau,
                        storage_backend, vectorized, ndraw_min):
        """resume-similar: re-anchor stored points to the new likelihood."""
        assert storage_backend == 'hdf5', \
            'resume-similar is only supported for HDF5 files'
        assert 0 <= warmstart_max_tau <= 1, \
            'warmstart_max_tau parameter needs to be set to a value ' \
            'between 0 and 1'
        self.pointstore.close()
        del self.pointstore
        if self.log:
            self.logger.info(
                'trying to salvage points from previous, different run ...')
        resume_from_similar_file(
            self.logs['run_dir'], self.x_dim, loglike, transform,
            ndraw=ndraw_min if vectorized else 1,
            max_tau=warmstart_max_tau, verbose=False)
        self.pointstore = HDF5PointStore(
            os.path.join(self.logs['results'], 'points.hdf5'),
            3 + self.x_dim + self.num_params, mode='a')

    def _init_fused_sampler(self, torch_loglike, torch_transform, seed,
                            mesh=None):
        """Attach the fused device proposal engine, if a torch model exists."""
        self.fused_sampler = None
        self._fused_method = 0  # index into fused.METHOD_CYCLE
        if torch_loglike is None or len(self.wrapped_axes) != 0:
            return
        fused_seed = seed if seed is not None else np.random.randint(2**31)
        self.fused_sampler = FusedRegionSampler(
            torch_loglike, torch_transform, self.x_dim, seed=fused_seed,
            mesh=mesh, device=self.device)

    def _check_likelihood_function(self, transform, loglike,
                                   num_test_samples):
        """Sanity-check the user functions; verify resume consistency.

        Returns whether the most recently stored point still yields the
        same likelihood value.
        """
        can_check_resume = num_test_samples \
            and not self.pointstore.stack_empty
        nfresh = num_test_samples - (1 if can_check_resume else 0)

        if nfresh > 0:
            u = self.rng.uniform(size=(nfresh, self.x_dim))
            p = u if transform is None else transform(u)
            assert np.shape(p) == (nfresh, self.num_params), (
                "Error in transform function: returned shape is %s, "
                "expected %s" % (np.shape(p), (nfresh, self.num_params)))
            logl = loglike(p)
            assert np.logical_and(u > 0, u < 1).all(), (
                "Error in transform function: u was modified!")
            assert np.shape(logl) == (nfresh,), (
                "Error in loglikelihood function: returned shape is %s, "
                "expected %s" % (np.shape(logl), (nfresh,)))
            assert np.isfinite(logl).all(), (
                "Error in loglikelihood function: returned non-finite "
                "number: %s for input u=%s p=%s" % (logl, u, p))

        if not can_check_resume:
            return True

        # replay the most recent stored row through the new functions
        _, last = self.pointstore.stack[-1]
        assert len(last) == 3 + self.x_dim + self.num_params, (
            "Cannot resume: problem has different dimensionality",
            len(last), (2, self.x_dim, self.num_params))
        u_stored = last[3:3 + self.x_dim]
        p_stored = last[3 + self.x_dim:3 + self.x_dim + self.num_params]
        L_stored = last[1]
        if self.log:
            self.logger.debug(
                "Testing resume consistency: %s: u=%s -> p=%s -> L=%s ",
                last, u_stored, p_stored, L_stored)
        u = u_stored.reshape((1, -1))
        p = u if transform is None else transform(u)
        if not np.allclose(p.flatten(), p_stored) and self.log:
            self.logger.warning(
                "Trying to resume from previous run, but transform function "
                "gives different result: %s gave %s, now %s",
                u_stored, p_stored, p.flatten())
        assert np.allclose(p.flatten(), p_stored), (
            "Cannot resume because transform function changed. "
            "To start from scratch, delete '%s'." % self.logs['run_dir'])
        L_now = loglike(p).flatten()[0]
        if not np.isclose(L_now, L_stored) and self.log:
            self.logger.warning(
                "Trying to resume from previous run, but likelihood "
                "function gives different result: %s gave %s, now %s",
                u_stored.flatten(), L_stored, L_now)
        return np.isclose(L_now, L_stored)

    def _set_likelihood_function(self, transform, loglike, num_test_samples,
                                 make_safe=False):
        """Store the user functions (optionally wrapped to be forgiving)."""
        if make_safe:
            def checked_loglike(x):
                """Evaluate likelihood; clip non-finite values to -1e100."""
                x = np.asarray(x)
                if x.ndim == 1:
                    assert x.shape[0] == self.x_dim
                    x = x[None, :]
                logl = np.atleast_1d(loglike(x))
                logl[~np.isfinite(logl)] = -1e100
                return logl

            self.loglike = checked_loglike
        else:
            self.loglike = loglike

        if transform is None:
            self.transform = lambda x: x
        elif make_safe:
            def checked_transform(x):
                """Transform, coercing a single point into a batch."""
                x = np.asarray(x)
                if x.ndim == 1:
                    assert x.shape[0] == self.x_dim
                    x = x[None, :]
                return transform(x)

            self.transform = checked_transform
        else:
            self.transform = transform

        probe = np.full((2, self.x_dim), 1e-6)
        probe[1, :] = 1 - 1e-6
        self.transform_limits = self.transform(probe).transpose()
        self.volfactor = vol_prefactor(self.x_dim)

    def _widen_nodes(self, weighted_parents, weights, nnodes_needed,
                     update_interval_ncall):
        """Ensure parents carry *nnodes_needed* parallel arcs; plan children.

        Returns a dict mapping node id -> minimum number of children to
        maintain.
        """
        ndone = len(weighted_parents)
        if ndone == 0:
            if self.log:
                self.logger.info('No parents, so widening roots')
            self._widen_roots(nnodes_needed)
            return {}

        # parents carrying few forks carry most posterior weight: favor them
        invw = 1.0 / np.asarray(weights)
        if np.ptp(invw) == 0:
            parents = weighted_parents
        else:
            chosen = self.rng.choice(len(weighted_parents),
                                     size=nnodes_needed,
                                     p=invw / invw.sum())
            parents = [weighted_parents[k] for k in chosen]

        del weighted_parents, weights
        parents.sort(key=lambda n: n.value)
        Lmin = parents[0].value
        if np.isinf(Lmin):
            # parents sampled from the whole prior: widen roots instead
            if self.log:
                self.logger.info('parent value is -inf, so widening roots')
            self._widen_roots(nnodes_needed)
            return {}

        per_parent = int(np.ceil((nnodes_needed - ndone) / len(parents)))
        if self.log:
            self.logger.info('Will add %d live points (x%d) at L=%.1g ...',
                             nnodes_needed - ndone, per_parent, Lmin)
        plan = {}
        for parent in parents:
            have = plan.get(parent.id, len(parent.children))
            plan[parent.id] = have + per_parent
        return plan

    def _widen_roots_beyond_initial_plateau(self, nroots, num_warn,
                                            num_stop):
        """Widen roots, over-provisioning across any initial plateau.

        Repeats :meth:`_widen_roots` until `nroots`-1 points exceed the
        lowest loglikelihood value (Fowlie+2020 plateau handling), bounded
        by *num_stop*.
        """
        target = nroots
        warned = False
        while True:
            self._widen_roots(target)
            Ls = np.array([node.value for node in self.root.children])
            Lmin = Ls.min()
            if self.log and target > num_warn and not warned:
                self.logger.warning(
                    "The loglikelihood has a large plateau with L=%g. "
                    "ultranest can handle this correctly, by discarding live "
                    "points with the same loglikelihood (arxiv:2005.08602, "
                    "arxiv:2010.13884), but you can avoid this by making the "
                    "loglikelihood increase towards the good region. "
                    "The initial number of live points has grown beyond %d "
                    "and will be capped at %d.", Lmin, num_warn, num_stop)
                warned = True
            if target >= num_stop:
                return
            nflat = int((Ls == Lmin).sum())
            plateau = 1 < nflat < len(Ls) and len(Ls) - nflat + 1 < nroots
            if not plateau:
                return
            if self.log:
                self.logger.debug(
                    'Found plateau of %d/%d initial points at L=%g. '
                    'Avoid this by a continuously increasing loglikelihood '
                    'towards good regions.', nflat, target, Lmin)
            target = min(num_stop, target + (nflat - 1))

    def _widen_roots(self, nroots):
        """Ensure the root has *nroots* children.

        Replays stored prior samples first, then draws the remainder
        fresh from the prior.
        """
        have = len(self.root.children)
        if self.log and have > 0:
            self.logger.info(
                'Widening roots to %d live points (have %d already) ...',
                nroots, have)
        nmissing = nroots - have
        if nmissing <= 0:
            return

        stored_u, stored_v, stored_logl = [], [], []
        if self.log and self.use_point_stack:
            for _ in range(nmissing):
                _, row = self.pointstore.pop(-np.inf)
                if row is None:
                    break
                stored_u.append(row[3:3 + self.x_dim])
                stored_v.append(row[3 + self.x_dim:
                                    3 + self.x_dim + self.num_params])
                stored_logl.append(row[1])
        u = np.array(stored_u)
        v = np.array(stored_v)
        logl = np.array(stored_logl)

        nfresh = nmissing - len(logl)
        assert nfresh >= 0
        if nfresh > 0:
            if self.log:
                self.logger.info('Sampling %d live points from prior ...',
                                 nfresh)
            self.ncall += nfresh
            fresh_u = self.rng.uniform(size=(nfresh, self.x_dim))
            fresh_v = self.transform(fresh_u)
            fresh_logl = self.loglike(fresh_v)
            assert fresh_logl.shape == (nfresh,), (
                fresh_logl.shape, nfresh)
            if self.log_to_pointstore:
                for i in range(nfresh):
                    self.pointstore.add(_listify(
                        [-np.inf, fresh_logl[i], 0.0],
                        fresh_u[i, :], fresh_v[i, :]), 1)
            if len(u) > 0:
                u = np.concatenate((u, fresh_u))
                v = np.concatenate((v, fresh_v))
                logl = np.concatenate((logl, fresh_logl))
            else:
                u, v, logl = fresh_u, fresh_v, fresh_logl
            assert u.shape == (nmissing, self.x_dim)
            assert v.shape == (nmissing, self.num_params)
            assert logl.shape == (nmissing,)

        self.root.children += [
            self.pointpile.make_node(logl_i, u_i, v_i)
            for u_i, v_i, logl_i in zip(u, v, logl)]
        if len(u) > 4:
            self.build_tregion = not is_affine_transform(u, v)

    def _adaptive_strategy_advice(self, Lmin, parallel_values, main_iterator,
                                  minimal_widths, frac_remain, Lepsilon):
        """Return the (Llo, Lhi) interval needing more sampling (nan if done)."""
        Ls = np.sort(parallel_values)
        Lmin, Lmax = Ls[0], Ls[-1]

        # all live points equal within tolerance: stop
        if Lmax - Lmin < Lepsilon:
            return np.nan, np.nan

        # level at which the remainder would contribute frac_remain of Z
        Lnext = main_iterator.logZremain - log(len(Ls)) \
            - (main_iterator.logVolremaining + log(frac_remain))
        second = Ls[1] if len(Ls) > 1 else Ls[0]
        Lnext = max(min(Lnext, np.median(Ls)), second)

        undecided = main_iterator.logZremain > main_iterator.logZ \
            or main_iterator.remainder_fraction > frac_remain
        return (Lmin, Lnext) if undecided else (np.nan, np.nan)

    def _strategy_ess(self, w, saved_logl, min_ess):
        """Where must sampling improve to reach *min_ess* effective samples?"""
        ess = len(w) / (1.0 + ((len(w) * w - 1)**2).sum() / len(w))
        Llo, Lhi = np.inf, -np.inf
        if ess < min_ess:
            picks = self.rng.choice(len(w), p=w, size=min_ess)
            Llo = saved_logl[picks].min()
            Lhi = saved_logl[picks].max()
        if self.log and Lhi > Llo:
            self.logger.info(
                "Effective samples strategy wants to improve: %.2f..%.2f "
                "(ESS = %.1f, need >%d)", Llo, Lhi, ess, min_ess)
        elif self.log and min_ess > 0:
            self.logger.info(
                "Effective samples strategy satisfied (ESS = %.1f, need >%d)",
                ess, min_ess)
        return Llo, Lhi

    def _strategy_kl(self, saved_logl, ref_logw, other_logw, dKL):
        """Which interval do bootstrapped posteriors disagree about?

        Computes the KL divergence of each bootstrap posterior against the
        main estimator; estimators deviating more than *dKL* nat vote for
        the likelihood interval holding the bulk of their disagreement.
        The (niter x nbootstraps) divergence table comes from
        :func:`ultranest_torch.parallel.strategy.bootstrap_kl_table`.
        """
        KL, KLtot = bootstrap_kl_table(ref_logw, other_logw,
                                       mesh=self.mesh)
        dKLtot = np.abs(KLtot - KLtot.mean())

        profile = np.where(KL > 0, KL, 0)
        profile /= profile.sum(axis=0)[None, :]

        Llo, Lhi = np.inf, -np.inf
        # NOTE: bootstrap k's KL profile is zipped against ROW k of the
        # weight table, exactly as the reference does
        # (integrator.py:1690-1702) — the row indexing makes the snap
        # very conservative (usually expanding to the first iterations),
        # and the improvement loop's convergence depends on it.
        for pi, dKLi, logw_row in zip(profile.T, dKLtot, other_logw):
            if dKLi <= dKL:
                continue
            ilo, ihi = _quantile_window(pi, 1.0 / 400)
            # snap to the nearest finite-weight entry
            finite_lo, = np.where(np.isfinite(logw_row[:ilo]))
            finite_hi, = np.where(np.isfinite(logw_row[ihi:]))
            ilo2 = finite_lo[-1] if len(finite_lo) > 0 else 0
            ihi2 = ihi + finite_hi[0] if len(finite_hi) > 0 else -1
            Llo = min(Llo, saved_logl[ilo2])
            Lhi = max(Lhi, saved_logl[ihi2])

        if self.log and Lhi > Llo:
            self.logger.info(
                "Posterior uncertainty strategy wants to improve: %.2f..%.2f "
                "(KL: %.2f+-%.2f nat, need <%.2f nat)",
                Llo, Lhi, KLtot.mean(), dKLtot.max(), dKL)
        elif self.log:
            self.logger.info(
                "Posterior uncertainty strategy is satisfied "
                "(KL: %.2f+-%.2f nat, need <%.2f nat)",
                KLtot.mean(), dKLtot.max(), dKL)
        return Llo, Lhi

    def _strategy_nlive(self, main_iterator, saved_logl, w, dlogz):
        """How many live points would the evidence target have needed?"""
        deltalogZ = np.abs(main_iterator.all_logZ[1:] - main_iterator.logZ)
        tail_fraction = w[np.asarray(main_iterator.istail)].sum() / w.sum()
        logzerr_tail = logaddexp(
            log(tail_fraction) + main_iterator.logZ,
            main_iterator.logZ) - main_iterator.logZ

        Nlive_min = 0
        worst_err = max(main_iterator.logZerr, deltalogZ.max(),
                        main_iterator.logZerr_bs)
        if worst_err > dlogz:
            if self.log and logzerr_tail > worst_err:
                self.logger.info(
                    "logz error is dominated by tail. Decrease frac_remain "
                    "to make progress.")
            # conservative floor from the total iteration count
            Nlive_min = int(np.ceil(len(saved_logl)**0.5 / dlogz))
            if self.log:
                self.logger.debug(
                    "  conservative estimate says at least %d live points "
                    "are needed to reach dlogz goal", Nlive_min)

            # sharper estimate: back out the nlive sequence from the
            # realised shrinkage widths, then find the smallest uniform
            # floor whose expected error meets the target
            itmax = self.rng.choice(len(w), p=w)
            logweights = np.array(main_iterator.logweights[:itmax])
            with np.errstate(divide='ignore', invalid='ignore'):
                shrink = 1 - np.exp(logweights[1:, 0] - logweights[:-1, 0])
                nlive = 1.0 / np.log(
                    (1 - np.sqrt(1 - 4 * shrink)) / (2 * shrink))
                nlive[~(np.isfinite(nlive) & (nlive > 1))] = 1

            nlive_sets, niter = np.unique(nlive.astype(int),
                                          return_counts=True)
            if self.log and len(niter) > 0:
                self.logger.debug(
                    "  number of live points vary between %.0f and %.0f, "
                    "most (%d/%d iterations) have %d",
                    nlive.min(), nlive.max(), niter.max(), itmax,
                    nlive_sets[niter.argmax()])
            for floor in nlive_sets:
                raised = np.maximum(nlive_sets, floor)
                expected_err = (niter / raised**2.0).sum()**0.5
                if expected_err < dlogz:
                    Nlive_min = int(floor)
                    if self.log:
                        self.logger.debug(
                            "  at least %d live points are needed to reach "
                            "dlogz goal", Nlive_min)
                    break

        if self.log and Nlive_min > 0:
            self.logger.info(
                "Evidence uncertainty strategy wants %d minimum live points "
                "(dlogz from %.2f to %.2f, need <%s)",
                Nlive_min, deltalogZ.mean(), deltalogZ.max(), dlogz)
        elif self.log:
            self.logger.info(
                "Evidence uncertainty strategy is satisfied "
                "(dlogz=%.2f, need <%s)",
                (main_iterator.logZerr_bs**2 + logzerr_tail**2)**0.5, dlogz)
        if self.log:
            self.logger.info(
                '  logZ error budget: single: %.2f bs:%.2f tail:%.2f '
                'total:%.2f required:<%.2f',
                main_iterator.logZerr, main_iterator.logZerr_bs,
                logzerr_tail,
                (main_iterator.logZerr_bs**2 + logzerr_tail**2)**0.5, dlogz)
        return Nlive_min

    def _find_strategy(self, saved_logl, main_iterator, dlogz, dKL, min_ess):
        """Ask each strategy where more exploration is needed.

        Returns (Nlive_min, (Llo_KL, Lhi_KL), (Llo_ess, Lhi_ess)).
        """
        saved_logl = np.asarray(saved_logl)
        logw = np.asarray(main_iterator.logweights) \
            + saved_logl[:, None] - main_iterator.all_logZ
        ref_logw = logw[:, :1]
        other_logw = logw[:, 1:]
        w = exp(ref_logw.flatten())
        w /= w.sum()

        ess_interval = self._strategy_ess(w, saved_logl, min_ess)
        kl_interval = self._strategy_kl(saved_logl, ref_logw, other_logw,
                                        dKL)
        Nlive_min = self._strategy_nlive(main_iterator, saved_logl, w,
                                         dlogz)
        return Nlive_min, kl_interval, ess_interval

    def _warn_if_stuck(self, u, v, logl, naccepted, ndraw, nit, Lmin):
        """Diagnose an inefficient rejection phase, once per run.

        Dumps the live points and the failing candidate batch to the
        extra/ directory and raises if no live point can be improved on
        (plateau exhaustion or resuming a different problem).
        """
        if self.sampling_slow_warned or nit * ndraw < 100000 or nit <= 20:
            return
        message = (
            "Sampling from region seems inefficient (%d/%d accepted in "
            "iteration %d). To improve efficiency, modify the "
            "transformation so that the current live points are "
            "ellipsoidal, or use a stepsampler, or set frac_remain to a "
            "lower number (e.g., 0.5) to terminate earlier."
            % (naccepted, ndraw, nit))
        if self.log_to_disk:
            stem = os.path.join(self.logs['extra'],
                                'sampling-stuck-it%d' % nit)
            np.savez(stem + '.npz',
                     u=self.region.u, unormed=self.region.unormed,
                     maxradiussq=self.region.maxradiussq,
                     sample_u=u, sample_v=v, sample_logl=logl)
            np.savetxt(stem + '.csv', self.region.u, delimiter=',')
        warnings.warn(message, stacklevel=3)
        logl_live = self.loglike(self.transform(self.region.u))
        if (logl_live == Lmin).all():
            raise ValueError(
                "Region cannot sample a higher point. "
                "All remaining live points have the same value.")
        if not (logl_live > Lmin).any():
            raise ValueError(
                "Region cannot sample a higher point. "
                "Perhaps you are resuming from a different problem? "
                "Delete the output files and start again.")
        self.sampling_slow_warned = True

    def _refill_samples(self, Lmin, ndraw, nit):
        """Draw one batch of region candidates and evaluate the likelihood.

        The batch size is bucketed to powers of two, as in the reference.
        """
        ndraw = _next_pow2(max(ndraw, 16))
        if self.fused_sampler is not None:
            # single fused device dispatch: draw + filter + transform + L
            u, v, logl, nc, ndrawn = self.fused_sampler(
                self.region, Lmin, ndraw, tregion=self.tregion,
                method=METHOD_CYCLE[self._fused_method])
            if len(u) == 0 or nc < max(1, ndrawn // 200):
                # proposal strategy starved: rotate to the next one
                self._fused_method = (self._fused_method + 1) \
                    % len(METHOD_CYCLE)
            self.ncall_region += ndrawn
            return u, v, logl, nc, 0

        u = self.region.sample(nsamples=ndraw, rng=self.rng)
        assert np.logical_and(u > 0, u < 1).all(), u
        if u.shape[0] == 0:
            v = np.empty((0, self.num_params))
            logl = np.empty((0,))
            accepted = np.empty(0, dtype=bool)
            nc = 0
        else:
            if u.shape[0] > 1 and not self.draw_multiple:
                u = u[:1, :]
            v = self.transform(u)
            logl = np.full(u.shape[0], -np.inf)
            if self.tregion is not None:
                # pre-filter with the wrapping ellipsoid in p-space
                evaluate = self.tregion.inside(v)
            else:
                evaluate = np.ones(u.shape[0], dtype=bool)
            nc = int(evaluate.sum())
            if nc > 0:
                logl[evaluate] = self.loglike(v[evaluate, :])
            accepted = logl > Lmin

        self._warn_if_stuck(u, v, logl, accepted.sum(), ndraw, nit, Lmin)
        self.ncall_region += ndraw
        return u[accepted, :], v[accepted, :], logl[accepted], nc, 0

    def _pop_replay_batch(self, Lmin):
        """Load the next stored point for *Lmin* into the sample buffer."""
        row = np.full((1, 3 + self.x_dim + self.num_params), np.nan)
        if self.log_to_pointstore:
            _, stored = self.pointstore.pop(Lmin)
            row[0, :] = stored if stored is not None else -np.inf
            self.use_point_stack = not self.pointstore.stack_empty
        self.likes = row[:, 1]
        self.samples = row[:, 3:3 + self.x_dim]
        self.samplesv = row[:, 3 + self.x_dim:
                            3 + self.x_dim + self.num_params]
        self.ib = 0 if np.isfinite(self.likes[0]) else 1

    def _degrade_to_host(self, why):
        """Swap dead device samplers for host equivalents and keep going.

        On a dispatch deadline (:class:`parallel.launch.DeviceLostError`)
        the fused rejection path falls back to host region sampling, and
        a device population sampler (one with a ``torch_loglike``) is
        replaced by the host ``RegionSliceSampler`` at the same nsteps;
        the run goes on with the user's numpy likelihood. The point store
        already holds every evaluated point, so a later rerun on a
        healthy device resumes at full speed. Region rebuilds still run
        on the sampler's device.
        """
        msg = ('accelerator lost mid-run (%s); continuing on the host '
               'CPU path. Every evaluated point is in the point store; '
               'rerun later to resume on a healthy device.' % why)
        warnings.warn(msg)
        if self.log:
            self.logger.warning(msg)
        self.fused_sampler = None
        ss = self.stepsampler
        if ss is not None and getattr(ss, 'torch_loglike', None) is not None:
            from .stepsampler import RegionSliceSampler
            self.stepsampler = RegionSliceSampler(
                nsteps=max(int(getattr(ss, 'nsteps', 16)), 1))

    def _fill_sample_buffer(self, Lmin, ndraw, active_u, active_values,
                            nit):
        """Generate fresh candidates into the sample buffer (device or host)."""
        try:
            if self.stepsampler is not None:
                u, v, logl, nc = self.stepsampler.__next__(
                    self.region, Lmin=Lmin, us=active_u, Ls=active_values,
                    transform=self.transform, loglike=self.loglike,
                    tregion=self.tregion, ndraw=ndraw)
                quality = self.stepsampler.nsteps
            else:
                u, v, logl, nc, quality = self._refill_samples(
                    Lmin, ndraw, nit)
        except DeviceLostError as e:
            self._degrade_to_host(e)
            return self._fill_sample_buffer(Lmin, ndraw, active_u,
                                            active_values, nit)

        if logl is None:
            u = np.empty((0, self.x_dim))
            v = np.empty((0, self.num_params))
            logl = np.empty((0,))
        elif np.asarray(u).ndim == 1:
            assert np.logical_and(u > 0, u < 1).all(), u
            u = np.asarray(u).reshape((1, self.x_dim))
            v = np.asarray(v).reshape((1, self.num_params))
            logl = np.asarray(logl).reshape((1,))

        self.samples = u
        self.samplesv = v
        self.likes = logl
        self.ib = 0
        self.ncall += nc
        if self.log_to_pointstore:
            for ui, vi, logli in zip(u, v, logl):
                self.pointstore.add(
                    _listify([Lmin, logli, quality], ui, vi), self.ncall)

    def _maybe_prefetch(self, Lmin, ndraw):
        """Keep one device proposal batch in flight while the host consumes.

        The useful yield of a rejection batch is bounded by how far the
        threshold rises while consuming it (~tens of insertions per
        batch regardless of batch size), so the next dispatch is
        launched as soon as the previous one is harvested: the device
        computes and streams it while the host walks the tree.
        Prefetch no-ops while a dispatch is already pending, so this
        costs at most one speculative batch at a time.
        """
        if self.fused_sampler is None or self.use_point_stack:
            return
        if len(self.samples) >= 8:
            self.fused_sampler.prefetch(
                self.region, Lmin, ndraw, tregion=self.tregion,
                method=METHOD_CYCLE[self._fused_method])

    def _create_point(self, Lmin, ndraw, active_u, active_values):
        """Draw a new point above likelihood threshold *Lmin*.

        Consumes the sample buffer, replaying the point store first (this
        is how resume works), then refilling from the region sampler.
        """
        if self.stepsampler is None and self.fused_sampler is None \
                and self._region_membership_unchecked:
            # sanity check, once per region rebuild: membership can only
            # change when the region does
            self._region_membership_unchecked = False
            assert self.region.inside(active_u).any(), (
                "None of the live points satisfies the current region!",
                self.region.maxradiussq, self.region.u, active_u)

        nit = 0
        while True:
            if self.ib >= len(self.samples) and self.use_point_stack:
                self._pop_replay_batch(Lmin)
            while self.ib >= len(self.samples):
                self._fill_sample_buffer(Lmin, ndraw, active_u,
                                         active_values, nit)
                nit += 1

            i = self.ib
            self.ib += 1
            if not self.likes[i] > Lmin:
                continue
            u = self.samples[i, :]
            assert np.logical_and(u > 0, u < 1).all(), u
            p = self.samplesv[i, :]
            logl = self.likes[i]
            if self.fused_sampler is not None:
                self._maybe_prefetch(Lmin, ndraw)
                # the device filter ran in f32; re-evaluate the selected
                # point on the host in f64. Quantized likelihoods would
                # create spurious ties (plateau detections) in the tree.
                # Not counted in ncall: the point was already counted as
                # a device member evaluation.
                logl = float(self.loglike(p.reshape((1, -1)))[0])
                if not logl > Lmin:
                    continue
            return u, p, logl

    def _init_region(self, active_u, active_node_ids, nbootstraps, minvol):
        """Build the very first region of a pass from the live points."""
        self.transformLayer = self.transform_layer_class(
            wrapped_dims=self.wrapped_axes)
        self.transformLayer.optimize(active_u, active_u, minvol=minvol)
        self.region = self.region_class(active_u, self.transformLayer,
                                        device=self.device)
        self.region_nodes = active_node_ids.copy()
        assert self.region.maxradiussq is None
        _update_region_bootstrap(self.region, nbootstraps, minvol,
                                 rng=self.rng, mesh=self.mesh)
        self.region.create_ellipsoid(minvol=minvol)

    def _refit_region_radius(self, active_u, active_node_ids, nbootstraps,
                             minvol):
        """Recompute an invalidated radius, keeping the current layer.

        The radius is dropped when the live point set shrinks (leaf
        removal). Old cluster labels are carried over to the new point set
        by radius-ball matching in one device dispatch; points claimed by
        several old clusters stay unassigned, which forces acceptance of
        the next full rebuild.

        Returns True if unassigned points remain.
        """
        oldu = self.region.u
        self.region.u = active_u
        self.region_nodes = active_node_ids.copy()
        self.region.set_transformLayer(self.transformLayer)
        _update_region_bootstrap(self.region, nbootstraps, minvol,
                                 rng=self.rng, mesh=self.mesh)

        oldt = self.transformLayer.transform(oldu)
        self.transformLayer.clusterids = match_clusters(
            oldt, self.transformLayer.clusterids,
            self.region.unormed, self.region.maxradiussq, device=self.device)
        assert len(self.region.u) == len(self.transformLayer.clusterids)
        self.region.create_ellipsoid(minvol=minvol)
        return bool((self.transformLayer.clusterids == 0).any())

    def _fit_candidate_region(self, active_u, nbootstraps, minvol):
        """Cluster + whiten + bootstrap a fresh region proposal.

        Returns (region, cluster_sizes). Numerical trouble (warnings
        promoted to errors, singular covariances) propagates to the
        caller, which then keeps the previous region.
        """
        layer = self.transformLayer.create_new(
            active_u, self.region.maxradiussq, minvol=minvol,
            device=self.device)
        assert not (layer.clusterids == 0).any()
        _, cluster_sizes = np.unique(layer.clusterids, return_counts=True)
        if self.log and cluster_sizes.min() == 1:
            self.logger.debug(
                "clustering found some stray points %s",
                np.unique(layer.clusterids, return_counts=True))
        if self.log and layer.nclusters >= 20:
            self.logger.info(
                "Found a lot of clusters: %d (%d with >1 members)",
                layer.nclusters, (cluster_sizes > 1).sum())

        candidate = self.region_class(active_u, layer, device=self.device)
        assert np.isfinite(candidate.unormed).all()
        _update_region_bootstrap(candidate, nbootstraps, minvol,
                                 rng=self.rng, mesh=self.mesh)
        candidate.create_ellipsoid(minvol=minvol)
        return candidate, cluster_sizes

    def _check_live_point_health(self, active_u, region):
        """Live points must be distinct and span a full-rank ellipsoid."""
        distinct = np.sum(active_u[1:] != active_u[0], axis=0) > self.x_dim
        return (len(active_u) > self.x_dim and distinct.all()
                and np.linalg.matrix_rank(region.ellipsoid_cov)
                == self.x_dim)

    def _acceptable_region(self, candidate, cluster_sizes, active_u,
                           must_accept):
        """Hysteresis rule for swapping in a candidate region."""
        # consistency: every live point inside the candidate ellipsoid
        # (the radius part of inside() holds trivially for the defining
        # points, each sits in its own ball — host numpy, no dispatch)
        if not candidate.inside_ellipsoid(active_u).all():
            if self.log:
                self.logger.debug(
                    "Proposed region is inconsistent (maxr=%g,enlarge=%g) "
                    "and will be skipped.",
                    candidate.maxradiussq, candidate.enlarge)
            return False
        # clustering sanity: not all singletons, largest cluster >= dim
        layer = candidate.transformLayer
        if not (layer.nclusters < len(candidate.u)
                and cluster_sizes.max() >= candidate.u.shape[1]):
            return False
        # volume must shrink, unless acceptance is forced (prevents
        # re-connection of separating modes)
        return must_accept or (candidate.estimate_volume()
                               <= self.region.estimate_volume())

    def _update_region(self, active_u, active_node_ids,
                       bootstrap_rootids=None, active_rootids=None,
                       nbootstraps=30, minvol=0.0, active_p=None):
        """Build a new region (and p-space wrapping ellipsoid) from live points.

        Regions are bootstrapped on device; a new region is accepted only if
        all live points are inside, the volume shrank (or acceptance is
        forced) and the clustering is sensible — the hysteresis preventing
        reconnection of dying modes.

        Returns True if an update was made.
        """
        assert nbootstraps > 0
        updated = False
        if self.region is None:
            self._init_region(active_u, active_node_ids, nbootstraps, minvol)
            updated = True

        assert self.transformLayer is not None
        must_accept = False
        if self.region.maxradiussq is None:
            must_accept = self._refit_region_radius(
                active_u, active_node_ids, nbootstraps, minvol)
            updated = True

        assert len(self.region.u) == len(self.transformLayer.clusterids)
        with warnings.catch_warnings(), np.errstate(all='raise'):
            try:
                candidate, cluster_sizes = self._fit_candidate_region(
                    active_u, nbootstraps, minvol)
                self.live_points_healthy = self._check_live_point_health(
                    active_u, candidate)
                assert (candidate.u == active_u).all()
                if self._acceptable_region(candidate, cluster_sizes,
                                           active_u, must_accept):
                    self.region = candidate
                    self.transformLayer = candidate.transformLayer
                    self.region_nodes = active_node_ids.copy()
                    assert not (self.transformLayer.clusterids == 0).any()
                    updated = True
            except (Warning, FloatingPointError, np.linalg.LinAlgError):
                if self.log:
                    self.logger.debug("not updating region", exc_info=True)

        assert len(self.region.u) == len(self.transformLayer.clusterids)
        self._refresh_tregion(active_p, nbootstraps)
        self._refresh_region_caches()
        self._region_membership_unchecked = True
        return updated

    def _refresh_region_caches(self):
        """Rebuild the per-iteration caches derived from the region.

        * cluster occupancy counts (and how many ids hold >1 point), so
          the per-iteration expansion test does not re-run np.unique
          over the cluster labels 40k+ times per pass;
        * node-id -> region-slot map, so replacing a live point does not
          scan the whole region_nodes array.
        Both are maintained incrementally by :meth:`_swap_into_region`
        between rebuilds.
        """
        ids = self.transformLayer.clusterids
        self._cluster_counts = np.bincount(ids).astype(np.int64)
        self._n_multi_clusters = int((self._cluster_counts > 1).sum())
        slots = {}
        for slot, nid in enumerate(self.region_nodes):
            slots.setdefault(int(nid), []).append(slot)
        self._region_node_slots = slots

    def _cluster_label_zeroed(self, old_id):
        """Track one point moving from cluster *old_id* to unassigned."""
        counts = self._cluster_counts
        old_id = int(old_id)
        if old_id != 0:
            if counts[old_id] == 2:
                self._n_multi_clusters -= 1
            counts[old_id] -= 1
            if counts[0] == 1:
                self._n_multi_clusters += 1
            counts[0] += 1

    def _refresh_tregion(self, active_p, nbootstraps):
        """Fit the p-space wrapping ellipsoid (pre-filter for candidates)."""
        self.tregion = None
        if active_p is None or not self.build_tregion:
            return
        try:
            with np.errstate(invalid='raise'):
                tregion = WrappingEllipsoid(active_p)
                tregion.enlarge = tregion.compute_enlargement(
                    nbootstraps=max(1, nbootstraps), rng=self.rng)
                tregion.create_ellipsoid()
                self.tregion = tregion
        except (FloatingPointError, np.linalg.LinAlgError):
            if self.log:
                self.logger.debug("not updating t-ellipsoid", exc_info=True)

    def _expand_nodes_before(self, Lmin, nnodes_needed, update_interval_ncall):
        """Ensure *nnodes_needed* parallel arcs exist before *Lmin*."""
        self.pointstore.reset()
        parents, weights = find_nodes_before(self.root, Lmin)
        target_min_num_children = self._widen_nodes(
            parents, weights, nnodes_needed, update_interval_ncall)
        if len(parents) == 0:
            Llo = -np.inf
        else:
            Llo = min(n.value for n in parents)
        return Llo, Lmin, target_min_num_children

    def _should_node_be_expanded(self, it, Llo, Lhi, minimal_widths_sequence,
                                 target_min_num_children, node,
                                 parallel_values, max_ncalls, max_iters,
                                 live_points_healthy):
        """Decide whether to sample a new child above this node's value."""
        Lmin = node.value
        nlive = len(parallel_values)

        if not (Lmin <= Lhi and Llo <= Lhi):
            return False

        if not live_points_healthy:
            if self.log:
                self.logger.debug(
                    "not expanding, because live points are linearly dependent")
            return False

        over_call_budget = max_ncalls is not None \
            and self.ncall >= max_ncalls
        over_iter_budget = max_iters is not None and it >= max_iters
        if it > 0 and (over_call_budget or over_iter_budget):
            return False

        # in a plateau, only shrink (Fowlie+2020)
        if np.count_nonzero(Lmin == parallel_values) > 1:
            if self.log:
                self.logger.debug(
                    "Plateau detected at L=%e, not replacing live point."
                    % Lmin)
            return False

        while Lmin > minimal_widths_sequence[0][0]:
            minimal_widths_sequence.pop(0)

        if self.region is None:
            minimal_width_clusters = 0
        else:
            # incrementally maintained count of cluster labels holding
            # more than one point (includes label 0, as the reference's
            # np.unique over all labels did)
            minimal_width_clusters = \
                self.cluster_num_live_points * self._n_multi_clusters

        minimal_width = max(minimal_widths_sequence[0][1],
                            minimal_width_clusters)

        nmin = target_min_num_children.get(node.id, 1) \
            if target_min_num_children else 1
        expand_node = len(node.children) < nmin
        # the first iteration must expand, otherwise H is never initialized
        too_wide = nlive > minimal_width and it > 0

        return expand_node and not too_wide

    def run(self, **run_options):
        r"""Run until the target convergence criteria are fulfilled.

        Parameters
        ----------
        update_interval_volume_fraction: float
            rebuild the region when the volume shrank by this fraction
        update_interval_ncall: int
            unused (kept for API compatibility)
        log_interval: int
            status-line update interval in iterations
        show_status: bool
            show a live status line
        viz_callback: function, 'auto' or False
            live view callback on region rebuilds
        dlogz: float
            target evidence uncertainty (std between bootstrapped logZ)
        dKL: float
            target posterior uncertainty (KL divergence, nat)
        frac_remain: float
            terminate when this fraction of the integral is in the remainder
        Lepsilon: float
            tolerance for considering live points equal
        min_ess: int
            target number of effective posterior samples
        max_iters: int
            maximum number of iterations
        max_ncalls: int
            maximum number of likelihood evaluations
        max_num_improvement_loops: int
            bound on reactive improvement loops
        min_num_live_points: int
            minimum live points throughout the run
        cluster_num_live_points: int
            minimum live points per detected cluster
        insertion_test_zscore_threshold: float
            threshold for the insertion-rank U-test (inf disables)
        insertion_test_window: int
            iterations between insertion test resets
        region_class: MLFriends, RobustEllipsoidRegion or SimpleRegion
            region construction algorithm
        widen_before_initial_plateau_num_warn: int
            warn when plateau-driven root widening exceeds this
        widen_before_initial_plateau_num_max: int
            hard cap on plateau-driven root widening

        Returns
        -------
        results: dict
            posterior samples, logz(+errors), ess, H, posterior summaries,
            weighted samples, maximum likelihood point,
            insertion_order_MWW_test (see reference
            integrator.py:2388-2457 for the full schema).
        """
        for _result in self.run_iter(
                **_resolve_run_options(run_options, interactive=False)):
            if self.log:
                self.logger.debug("did a run_iter pass!")
        if self.log:
            self.logger.info("done iterating.")
        return self.results

    def _prepare_run(self, dlogz, frac_remain, min_num_live_points,
                     cluster_num_live_points, region_class,
                     widen_before_initial_plateau_num_warn,
                     widen_before_initial_plateau_num_max):
        """Validate targets, prime the point stack, provision live points."""
        if -np.log1p(frac_remain) > dlogz:
            raise ValueError(
                "To achieve the desired logz accuracy, set frac_remain to a "
                "value much smaller than %s (currently: %s)"
                % (exp(-dlogz) - 1, frac_remain))

        # error is ~ sqrt(iterations)/Nlive: enforce a sensible minimum
        if min_num_live_points < 1000**0.5 / dlogz:
            min_num_live_points = int(np.ceil(1000**0.5 / dlogz))
            if self.log:
                self.logger.info(
                    "To achieve the desired logz accuracy, "
                    "min_num_live_points was increased to %d"
                    % min_num_live_points)
        assert min_num_live_points >= cluster_num_live_points, (
            'min_num_live_points(%d) cannot be less than '
            'cluster_num_live_points(%d)'
            % (min_num_live_points, cluster_num_live_points))

        if self.log_to_pointstore:
            if len(self.pointstore.stack) > 0:
                self.logger.info("Resuming from %d stored points",
                                 len(self.pointstore.stack))
            self.use_point_stack = not self.pointstore.stack_empty
        else:
            self.use_point_stack = False

        self.min_num_live_points = min_num_live_points
        self.cluster_num_live_points = cluster_num_live_points
        self.sampling_slow_warned = False
        self.build_tregion = True
        self.region_class = region_class

        self._widen_roots_beyond_initial_plateau(
            min_num_live_points,
            widen_before_initial_plateau_num_warn,
            widen_before_initial_plateau_num_max)

    def _begin_pass(self, Lmax, minimal_widths, log_interval):
        """Per-pass state: tree walker, estimator bank, bookkeeping."""
        st = _PassState()
        roots = self.root.children
        st.nroots = len(roots)
        st.log_interval = max(1, round(0.1 * st.nroots)) \
            if log_interval is None else round(log_interval)
        if st.log_interval < 1:
            raise ValueError("log_interval must be >= 1")

        st.explorer = BreadthFirstIterator(roots)
        st.main_iterator = MultiCounter(
            nroots=st.nroots, nbootstraps=max(1, self.num_bootstraps),
            random=False, check_insertion_order=False, rng=self.rng)
        st.main_iterator.Lmax = max(Lmax,
                                    max(n.value for n in roots))
        st.insertion_test = UniformOrderAccumulator()
        st.insertion_test_runs = []
        st.insertion_test_quality = np.inf
        st.insertion_test_direction = 0

        self.transformLayer = None
        self.region = None
        self.tregion = None
        self._region_membership_unchecked = True
        self.live_points_healthy = True
        self.ib = 0
        self.samples = []
        self.pointstore.reset()
        if self.log_to_pointstore:
            self.use_point_stack = not self.pointstore.stack_empty
        else:
            self.use_point_stack = False

        st.ndraw = self.ndraw_min if self.draw_multiple else 40
        st.it = 0
        st.it_at_first_region = 0
        st.ncall_at_run_start = self.ncall
        st.ncall_region_at_run_start = self.ncall_region
        st.next_update_interval_volume = 1
        st.last_status = time.time()
        st.region_sequence = []
        st.nclusters = 1
        st.saved_nodeids = []
        st.saved_logl = []
        st.minimal_widths_sequence = _width_plan(
            minimal_widths, self.min_num_live_points)
        if self.log:
            self.logger.debug('minimal_widths_sequence: %s',
                              st.minimal_widths_sequence)
        return st

    def _refresh_region_if_due(self, st, Lminval, active_u, active_p,
                               active_node_ids, active_rootids,
                               active_values, viz_callback,
                               update_interval_volume_log_fraction):
        """Rebuild the region when the volume shrank enough; update viz.

        Returns whether a rebuild was attempted this iteration.
        """
        mi = st.main_iterator
        if not mi.logVolremaining < st.next_update_interval_volume:
            return False
        if self.region is None:
            st.it_at_first_region = st.it
        region_fresh = self._update_region(
            active_u=active_u, active_p=active_p,
            active_node_ids=active_node_ids,
            active_rootids=active_rootids,
            bootstrap_rootids=mi.rootids[1:, ],
            nbootstraps=self.num_bootstraps,
            minvol=exp(mi.logVolremaining))
        if region_fresh and self.stepsampler is not None:
            self.stepsampler.region_changed(active_values, self.region)
        # buffered candidates stay valid across region rebuilds: they
        # were drawn uniformly above Lmin from an envelope containing
        # the constrained set, and insertion re-checks L > current Lmin.

        _, cluster_sizes = np.unique(
            self.region.transformLayer.clusterids, return_counts=True)
        st.nclusters = (cluster_sizes > 1).sum()
        st.region_sequence.append(
            (Lminval, len(active_node_ids), st.nclusters,
             np.max(active_values)))
        st.next_update_interval_volume = \
            mi.logVolremaining + update_interval_volume_log_fraction

        if self.log and viz_callback:
            viz_callback(
                points=dict(u=active_u, p=active_p, logl=active_values),
                info=dict(
                    it=st.it, ncall=self.ncall,
                    logz=mi.logZ, logz_remain=mi.logZremain,
                    logvol=mi.logVolremaining,
                    paramnames=self.paramnames + self.derivedparamnames,
                    paramlims=self.transform_limits,
                    order_test_correlation=st.insertion_test_quality,
                    order_test_direction=st.insertion_test_direction,
                    stepsampler_info=self.stepsampler.get_info_dict()
                    if hasattr(self.stepsampler, 'get_info_dict')
                    else {}),
                region=self.region,
                transformLayer=self.transformLayer,
                region_fresh=region_fresh)
        if self.log:
            self.pointstore.flush()
        return region_fresh

    def _log_segment_leftovers(self, rec, idx, stop_at, u_acc, p_acc,
                               L64, Li_seq, quality):
        """Store segment candidates the host did not insert.

        Classic-mode parity (reference integrator.py:1935-1939 stores
        every candidate the sampler hands over, inserted or not):

        * accepted rows past the truncation point — their f64 values are
          already computed; on resume ``pointstore.pop`` serves them, so
          an interrupted segment run re-pays ~no walk evaluations;
        * completed walkers below the risen threshold — stored with the
          device value (they can never match a future ``pop``, their
          role is forensics: rejection-rate analysis of stored runs).

        Disable with ``sampler.store_segment_rejects = False`` to keep
        point files minimal.
        """
        rows = []
        if stop_at < idx.size:
            sl = slice(stop_at, idx.size)
            rows.append(np.column_stack([
                Li_seq[sl], L64[sl],
                np.full(idx.size - stop_at, float(quality)),
                u_acc[sl], p_acc[sl]]))
        # below-threshold rows only (L <= their consume-time minimum):
        # these can never match a future pop — purely forensic. Rows
        # with L > Lmin but accept=False are UNFINISHED walkers (chains
        # shorter than nsteps) — storing them would let a resume insert
        # correlated samples the original run discarded; rows with
        # non-finite L are compaction padding (fused rejection batches)
        rej = np.flatnonzero(~rec['accept']
                             & (rec['L'] <= rec['Lmin'])
                             & np.isfinite(rec['L']))
        if rej.size:
            u_r = rec['u'][rej]
            rows.append(np.column_stack([
                rec['Lmin'][rej], rec['L'][rej],
                np.full(rej.size, float(quality)),
                u_r, self.transform(u_r)]))
        if rows:
            self.pointstore.add_many(np.concatenate(rows, axis=0),
                                     self.ncall)

    def _insertion_test_batch(self, st, ranks, nlive, zst, win):
        """Feed a batch of insertion ranks to the MWW U-test, vectorized.

        Exactly equivalent to per-row :meth:`UniformOrderAccumulator.add`
        + threshold/window checks (the classic loop at
        :meth:`_track_insertion_order`), but the scan between reset
        events is one cumulative-sum pass — resets are rare, so the
        python cost is O(events), not O(rows).
        """
        acc = st.insertion_test
        norm = (np.asarray(ranks, float) + 0.5) / nlive
        i, k = 0, len(norm)
        while i < k:
            # the window expiry guarantees an event within win+1 rows,
            # so each scan is bounded: total cost O(k), not O(k^2/win)
            m = min(k - i, max(int(win) - acc.N + 1, 1))
            S = acc.U + np.cumsum(norm[i:i + m])
            n = acc.N + 1 + np.arange(m)
            z = (S - 0.5 * n) / np.sqrt(n / 12.0)
            trig = np.flatnonzero((np.abs(z) > zst) | (n > win))
            if trig.size == 0:
                acc.load(S[-1], n[-1])
                i += m
                continue
            j = int(trig[0])
            acc.load(S[j], n[j])
            if abs(acc.zscore) > zst:
                st.insertion_test_runs.append(acc.N)
                st.insertion_test_quality = acc.N
                st.insertion_test_direction = np.sign(acc.zscore)
                acc.reset()
            else:
                st.insertion_test_quality = np.inf
                st.insertion_test_direction = 0
                acc.reset()
            i += j + 1

    def _track_insertion_order(self, st, L, nlive, active_values,
                               zscore_threshold, window):
        """Feed the rank U-test; reset it on detection or window expiry."""
        if not (np.isfinite(zscore_threshold) and nlive > 1):
            return
        st.insertion_test.add(int((active_values < L).sum()), nlive)
        if abs(st.insertion_test.zscore) > zscore_threshold:
            st.insertion_test_runs.append(st.insertion_test.N)
            st.insertion_test_quality = st.insertion_test.N
            st.insertion_test_direction = np.sign(st.insertion_test.zscore)
            st.insertion_test.reset()
        elif st.insertion_test.N > window:
            st.insertion_test_quality = np.inf
            st.insertion_test_direction = 0
            st.insertion_test.reset()

    def _swap_into_region(self, node, child, u, active_p):
        """Replace *node*'s slot in the region tracking with the new point.

        Between rebuilds the region follows the live points; the
        ellipsoid center is re-meaned incrementally instead of refit.
        """
        slot = self._region_node_slots.pop(int(node.id), [])
        self._region_node_slots.setdefault(int(child.id), []).extend(slot)
        self.region_nodes[slot] = child.id
        if len(slot):
            removed_sum = self.region.u[slot].sum(axis=0)
            self.region.u[slot] = u
            self.region.unormed[slot] = \
                self.region.transformLayer.transform(u)
            self.region.ellipsoid_center = (
                self.region.ellipsoid_center
                + (len(slot) * u - removed_sum) / len(self.region.u))
        if self.tregion:
            self.tregion.update_center(np.mean(active_p, axis=0))
        for s in slot:
            self._cluster_label_zeroed(self.transformLayer.clusterids[s])
        self.transformLayer.clusterids[slot] = 0

    def _emit_status(self, st, Lmin, Llo, Lhi, nlive, strategy_stale,
                     show_status):
        """Write the status line + debug log; adapt the batch size."""
        st.last_status = time.time()
        ncall_region_here = self.ncall_region - st.ncall_region_at_run_start
        ncall_here = self.ncall - st.ncall_at_run_start
        it_here = st.it - st.it_at_first_region
        mi = st.main_iterator

        if show_status:
            if Lmin < -1e8:
                fmt = ('Z=%.1g(%.2f%%) | Like=%.2g..%.2g [%.4g..%.4g]%s| '
                       'it/evals=%d/%d eff=%.4f%% N=%d \r')
            elif Llo < -1e8:
                fmt = ('Z=%.1f(%.2f%%) | Like=%.2f..%.2f [%.4g..%.4g]%s| '
                       'it/evals=%d/%d eff=%.4f%% N=%d \r')
            else:
                fmt = ('Z=%.1f(%.2f%%) | Like=%.2f..%.2f [%.4f..%.4f]%s| '
                       'it/evals=%d/%d eff=%.4f%% N=%d \r')
            sys.stdout.write(fmt % (
                mi.logZ, 100 * (1 - mi.remainder_fraction),
                Lmin, mi.Lmax, Llo, Lhi,
                '*' if strategy_stale else ' ', st.it, self.ncall,
                np.inf if ncall_here == 0 else it_here * 100 / ncall_here,
                nlive))
            sys.stdout.flush()
        self.logger.debug(
            'iteration=%d, ncalls=%d, regioncalls=%d, ndraw=%d, '
            'logz=%.2f, remainder_fraction=%.4f%%, Lmin=%.2f, Lmax=%.2f',
            st.it, self.ncall, self.ncall_region, st.ndraw, mi.logZ,
            100 * mi.remainder_fraction, Lmin, mi.Lmax)

        if self.fused_sampler is not None:
            # size device dispatches so ONE batch fills the acceptance
            # budget (~nlive/2 points): each dispatch pays a fixed
            # launch and fetch cost, so the right batch is
            # draws-per-iteration x budget, not the host path's
            # draws-per-single-iteration. Billing is budget-capped in
            # the dispatch, so larger batches cost device flops, not
            # ncall.
            inefficiency = (ncall_region_here + 1) / (it_here + 1)
            budget = max(64, nlive // 2)
            proposal = 2.0 * inefficiency * budget
            st.ndraw = int(max(self.ndraw_min,
                               min(self.ndraw_max, proposal)))
        elif self.draw_multiple:
            # proposals per successful iteration, smoothed exponentially
            inefficiency = (ncall_region_here + 1) / (it_here + 1)
            proposal = 0.04 * inefficiency + st.ndraw * 0.96
            st.ndraw = max(self.ndraw_min,
                           min(self.ndraw_max, round(proposal),
                               st.ndraw * 100))
            if inefficiency > 100000 \
                    and st.it >= st.it_at_first_region + 10:
                # reset the efficiency window so one pathological phase
                # does not poison the adaptation forever
                st.ncall_at_run_start = self.ncall
                st.it_at_first_region = st.it
                st.ncall_region_at_run_start = self.ncall_region

    def _segment_eligible(self, st, opts):
        """Whether the device segment fast path can run right now.

        Segment mode covers the pure-replacement phase: a device-chained
        population sampler, one child per consumed node, no pointstore
        replay/logging, no p-space wrapping region, healthy live points,
        and a frontier of childless nodes. Everything else falls back to
        the classic per-node loop.
        """
        ss = self.stepsampler if self.stepsampler is not None \
            else self.fused_sampler
        if not getattr(ss, 'segment_capable', False) \
                or not ss.segment_ok():
            return False
        mi = st.main_iterator
        if mi.random or self.region is None \
                or self.use_point_stack \
                or not self.live_points_healthy:
            return False
        if self.tregion is not None \
                and not getattr(ss, 'segment_tregion_ok', False):
            # non-affine transform needs the p-space wrapping-ellipsoid
            # filter; samplers that fuse it on device keep the fast path
            return False
        if opts['target_min_num_children']:
            return False
        ex = st.explorer
        if not ex.active_nodes \
                or any(len(n.children) for n in ex.active_nodes):
            return False
        return True

    def _explore_segments(self, st, opts):
        """Consume nested-sampling iterations in device-resident segments.

        The population sampler keeps the live set on the device; each
        dispatch walks a population AND consumes its harvest into the
        live set (argmin-replace scan), returning one record per walker
        row. The host replays the records: vectorized counter advance
        (:meth:`MultiCounter.passing_segment`), tree append, region
        mirror updates, insertion-rank test — and truncates the replay
        at the first insertion where the classic loop would have stopped
        (strategy decided, plateau, budget, width boundary). Returns the
        number of consumed nodes.
        """
        ss = self.stepsampler if self.stepsampler is not None \
            else self.fused_sampler
        ex = st.explorer
        mi = st.main_iterator
        frac_remain = opts['frac_remain']
        Lepsilon = opts['Lepsilon']
        max_iters = opts['max_iters']
        max_ncalls = opts['max_ncalls']
        uivlf = log(opts['update_interval_volume_fraction'])
        zst = opts['insertion_test_zscore_threshold']
        win = opts['insertion_test_window']

        nlive = len(ex.active_node_values)
        seqL, seq_width = st.minimal_widths_sequence[0]
        minimal_width = max(seq_width, self.cluster_num_live_points
                            * self._n_multi_clusters)
        if nlive > minimal_width and st.it > 0:
            return 0
        if nlive < self.cluster_num_live_points * st.nclusters \
                and opts['improvement_it'] \
                < opts['max_num_improvement_loops']:
            return 0
        if not (mi.logZremain > mi.logZ
                or mi.remainder_fraction > frac_remain):
            return 0
        if (max_ncalls is not None and self.ncall >= max_ncalls) \
                or (max_iters is not None and st.it >= max_iters):
            return 0
        if mi._nlive is None:
            mi._nlive = np.ascontiguousarray(
                mi.rootids[:, ex.active_root_ids].sum(axis=1),
                dtype=np.int64)

        lr0 = -1.0 / nlive
        ll0 = np.log1p(-exp(lr0))
        it_test = np.isfinite(zst) and nlive > 1
        total = 0
        # dispatches kept in flight: segment batches chain on the DEVICE
        # live state, so deeper queues add no threshold staleness — only
        # discarded speculative work at segment exits (unbilled). Depth 4
        # is the reference's TPU-tuned value, to be measured again here.
        depth = 4
        if not hasattr(self, '_segment_exits'):
            from collections import Counter
            self._segment_exits = Counter()
        if not hasattr(self, '_segment_phase_s'):
            from collections import Counter
            # wall-clock per engine phase: 'fetch' = blocked on the
            # device (dispatch + transfer latency not hidden by the
            # queue), 'launch' = host cost of argument pack + dispatch,
            # 'replay' = host tree/counter/pointstore replay,
            # 'rebuild' = region refresh. Published via bench extras.
            self._segment_phase_s = Counter()
        phase_s = self._segment_phase_s
        tmark = time.perf_counter()

        def _phase(name):
            nonlocal tmark
            now = time.perf_counter()
            phase_s[name] += now - tmark
            tmark = now

        ss.segment_start(self.pointpile.getu(ex.active_node_ids),
                         ex.active_node_values,
                         ndraw=_next_pow2(max(int(st.ndraw), 16)))
        try:
            for _ in range(depth):
                ss.segment_launch(self.region, tregion=self.tregion)
            _phase('launch')
            while True:
                rec = ss.segment_fetch()
                _phase('fetch')
                self.ncall += rec['nc']
                self.ncall_region += rec['nc']
                idx = np.flatnonzero(rec['accept'])
                if idx.size == 0:
                    self._segment_exits['starved'] += 1
                    break          # walkers starved: classic path decides
                Li_seq = rec['Lmin'][idx]
                Lnew_seq = rec['L'][idx]
                w_seq = rec['worst'][idx]
                rank_seq = rec['rank'][idx]
                k = idx.size

                # ---- truncation scan: first insertion the classic loop
                # would have refused ----
                # f64 re-evaluation of the accepted rows (the classic
                # path's design): device f32 values collide at ~1e-7
                # relative rate, and collisions at the running minimum
                # masquerade as likelihood plateaus
                u_acc = rec['u'][idx]
                p_acc = self.transform(u_acc)
                L64 = self.loglike(p_acc)

                stop_at = k
                stop_why = None
                # true plateau detection in f64: an inserted value equal
                # to any other live/inserted value makes the replacement
                # rule invalid from that point on — hand over to the
                # classic loop's plateau handling (Fowlie+2020)
                cand = np.concatenate(
                    [ex.active_node_values[:nlive], L64])
                uq, cnt = np.unique(cand, return_counts=True)
                if (cnt > 1).any():
                    dupvals = uq[cnt > 1]
                    dup_i = np.flatnonzero(np.isin(L64, dupvals))
                    if dup_i.size:
                        stop_at, stop_why = int(dup_i[0]), 'plateau'
                if max_iters is not None \
                        and max_iters - st.it < stop_at:
                    stop_at, stop_why = max(max_iters - st.it, 0), 'maxiter'
                if np.isfinite(seqL):
                    bd = np.flatnonzero(Li_seq > seqL)
                    if bd.size and bd[0] < stop_at:
                        stop_at, stop_why = int(bd[0]), 'width-boundary'
                # main-counter prediction of the stopping criterion
                i_arr = np.arange(k)
                wi = ll0 + mi.logVolremaining + lr0 * i_arr + Li_seq
                logZ_seq = np.logaddexp.accumulate(
                    np.concatenate([[mi.logZ], wi]))[1:]
                Lcur = ex.active_node_values[:nlive]
                ref = max(float(Lcur.max()), float(Lnew_seq.max()))
                S0 = np.exp(Lcur - ref).sum()
                deltas = np.exp(Lnew_seq - ref) - np.exp(Li_seq - ref)
                S_before = S0 + np.concatenate(
                    [[0.0], np.cumsum(deltas)[:-1]])
                lse_seq = ref + np.log(np.maximum(S_before, 1e-300))
                logZremain_seq = mi.logVolremaining + lr0 * (i_arr + 1) \
                    + lse_seq - log(nlive)
                if k > 1:
                    rf = 1.0 / (1.0 + np.exp(logZ_seq - logZremain_seq))
                    undecided = (logZremain_seq[:-1] > logZ_seq[:-1]) \
                        | (rf[:-1] > frac_remain)
                    dec = np.flatnonzero(~undecided)
                    if dec.size and dec[0] + 1 < stop_at:
                        stop_at, stop_why = int(dec[0]) + 1, 'decided'
                Lmax_before = np.maximum.accumulate(np.concatenate(
                    [[float(Lcur.max())], Lnew_seq]))[:-1]
                eps = np.flatnonzero(Lmax_before - Li_seq < Lepsilon)
                if eps.size and eps[0] < stop_at:
                    stop_at, stop_why = int(eps[0]), 'Lepsilon'

                clean = stop_at == k
                if stop_at:
                    sl = slice(0, stop_at)
                    u_a = u_acc[sl]
                    p_a = p_acc[sl]
                    w_a = w_seq[sl]
                    # replay the f64 values through the slot mirror:
                    # the consumed value is whatever the slot held, and
                    # rare f32-boundary inversions (device accepted but
                    # f64 says not-above) are clamped one ulp above
                    vals = ex.active_node_values
                    Lnew_a = L64[sl].copy()
                    # distinct worst slots (the common case) have no
                    # within-batch chaining: the mirror update is one
                    # gather/scatter instead of a python loop
                    distinct_w = np.unique(w_a).size == stop_at
                    if distinct_w:
                        Li_a = vals[w_a].copy()
                        bad = ~(Lnew_a > Li_a)
                        if bad.any():
                            Lnew_a[bad] = np.nextafter(Li_a[bad], np.inf)
                        vals[w_a] = Lnew_a
                    else:
                        Li_a = np.empty(stop_at)
                        for j in range(stop_at):
                            w = int(w_a[j])
                            Li_a[j] = vals[w]
                            if not Lnew_a[j] > Li_a[j]:
                                Lnew_a[j] = np.nextafter(Li_a[j], np.inf)
                            vals[w] = Lnew_a[j]
                    mi.passing_segment(Li_a, ex.active_root_ids[w_a],
                                       lse_seq[sl], nlive0=nlive)
                    mi.Lmax = max(mi.Lmax, float(Lnew_a.max()))
                    nodes = ex.active_nodes
                    # batch point-pile append: ids are sequential from
                    # base, so the TreeNodes can be built up front
                    base = self.pointpile.add_many(u_a, p_a)
                    children = [TreeNode(value=float(Lnew_a[j]),
                                         id=base + j)
                                for j in range(stop_at)]
                    child_ids = np.arange(base, base + stop_at,
                                          dtype=np.int64)
                    if distinct_w:
                        st.saved_nodeids.extend(
                            ex.active_node_ids[w_a].tolist())
                    # hot replay loop: python-native scalars only (numpy
                    # scalar indexing costs more than the rest of the body)
                    slot_rows, slot_urows = [], []
                    region_slots = self._region_node_slots
                    clusterids = self.transformLayer.clusterids
                    zeroed = self._cluster_label_zeroed
                    saved_nodeids = st.saved_nodeids
                    for j, w in enumerate(w_a.tolist()):
                        node = nodes[w]
                        child = children[j]
                        node.children.append(child)
                        if not distinct_w:
                            saved_nodeids.append(node.id)
                        nodes[w] = child
                        slot = region_slots.pop(node.id, None)
                        if slot:
                            region_slots.setdefault(
                                child.id, []).extend(slot)
                            self.region_nodes[slot] = child.id
                            for s in slot:
                                zeroed(clusterids[s])
                            clusterids[slot] = 0
                            slot_rows.extend(slot)
                            slot_urows.extend([j] * len(slot))
                    if it_test:
                        self._insertion_test_batch(
                            st, rank_seq[:stop_at], nlive, zst, win)
                    observe = getattr(self.stepsampler,
                                      'observe_insertion_ranks', None)
                    if observe is not None:
                        # nsteps-governor feed (independent of the
                        # user-facing alarm above): the record carries
                        # its at-launch chain length so queued stale
                        # dispatches cannot compound a doubling
                        observe(rank_seq[:stop_at], nlive,
                                rec.get('nsteps'))
                    st.saved_logl.extend(Li_a.tolist())
                    ex.active_node_ids[w_a] = child_ids
                    if self.log_to_pointstore:
                        # this batch's chains ran at the at-launch
                        # nsteps (the governor may have changed it since)
                        quality = rec.get(
                            'nsteps',
                            getattr(self.stepsampler, 'nsteps', 0.0))
                        self.pointstore.add_many(np.column_stack([
                            Li_a, Lnew_a,
                            np.full(stop_at, float(quality)),
                            u_a, p_a]), self.ncall)
                        if self.store_segment_rejects:
                            self._log_segment_leftovers(
                                rec, idx, stop_at, u_acc, p_acc, L64,
                                Li_seq, quality)
                    if slot_rows:
                        self.region.u[slot_rows] = u_a[slot_urows]
                        self.region.unormed = \
                            self.transformLayer.transform(self.region.u)
                        self.region.ellipsoid_center = \
                            self.region.u.mean(axis=0)
                    st.it += stop_at
                    total += stop_at
                    self.Lmin = float(Li_a[-1])

                if not clean:
                    self._segment_exits[stop_why] += 1
                    break
                if (max_ncalls is not None
                        and self.ncall >= max_ncalls) \
                        or (max_iters is not None
                            and st.it >= max_iters):
                    self._segment_exits['budget'] += 1
                    break
                if mi.logVolremaining < st.next_update_interval_volume:
                    _phase('replay')
                    self.pointstore.flush()
                    active_u = self.pointpile.getu(ex.active_node_ids)
                    active_p = self.pointpile.getp(ex.active_node_ids)
                    self._refresh_region_if_due(
                        st, self.Lmin, active_u, active_p,
                        ex.active_node_ids, ex.active_root_ids,
                        ex.active_node_values, opts['viz_callback'],
                        uivlf)
                    _phase('rebuild')
                    if not self.live_points_healthy:
                        self._segment_exits['unhealthy'] += 1
                        break
                    # the rebuild changed cluster bookkeeping; recheck
                    minimal_width = max(
                        seq_width, self.cluster_num_live_points
                        * self._n_multi_clusters)
                    if nlive > minimal_width \
                            or (nlive < self.cluster_num_live_points
                                * st.nclusters
                                and opts['improvement_it']
                                < opts['max_num_improvement_loops']):
                        self._segment_exits['width'] += 1
                        break
                _phase('replay')
                ss.segment_launch(self.region, tregion=self.tregion)
                _phase('launch')
                if self.log and time.time() > st.last_status + 0.2:
                    self._emit_status(st, self.Lmin, np.nan, np.nan,
                                      nlive, True, opts['show_status'])
        except DeviceLostError as e:
            self._segment_exits['device-lost'] += 1
            self._degrade_to_host(e)
        finally:
            _phase('replay')
            ss.segment_stop()
        return total

    def _explore_pass(self, st, Llo, Lhi, strategy_stale, opts):
        """Walk all roots in likelihood order, expanding where needed.

        Consumes the tree via the breadth-first explorer; each visited
        node may receive a new child (sampled above its contour). Returns
        the updated (Llo, Lhi, strategy_stale) triple.
        """
        minimal_widths = opts['minimal_widths']
        target_min_num_children = opts['target_min_num_children']
        viz_callback = opts['viz_callback']
        uivlf = log(opts['update_interval_volume_fraction'])

        while True:
            # device segment fast path: consume whole dispatches of
            # iterations without touching the per-node machinery;
            # re-attempted periodically (entry conditions are O(nlive))
            if (st.it & 63) == 0 and self._segment_eligible(st, opts):
                if self._explore_segments(st, opts):
                    strategy_stale = True
            visit = st.explorer.next_node()
            if visit is None:
                break
            rootid, node, (_, active_rootids, active_values,
                           active_node_ids) = visit
            assert not isinstance(rootid, float)
            self.Lmin = Lmin = node.value
            nlive = len(active_node_ids)

            if strategy_stale or not (Lmin <= Lhi) or \
                    not np.isfinite(Lhi) or (active_values == Lmin).all():
                Llo, Lhi = self._adaptive_strategy_advice(
                    Lmin, active_values, st.main_iterator,
                    minimal_widths, opts['frac_remain'],
                    Lepsilon=opts['Lepsilon'])
                strategy_stale = Lhi - Llo < max(opts['Lepsilon'], 0.01)

            if self._should_node_be_expanded(
                    st.it, Llo, Lhi, st.minimal_widths_sequence,
                    target_min_num_children, node, active_values,
                    opts['max_ncalls'], opts['max_iters'],
                    self.live_points_healthy):
                active_u, active_p = self._live_coords_if_needed(
                    st, Lmin, active_node_ids)
                region_fresh = self._refresh_region_if_due(
                    st, node.value, active_u, active_p, active_node_ids,
                    active_rootids, active_values, viz_callback, uivlf)

                if nlive < self.cluster_num_live_points * st.nclusters \
                        and opts['improvement_it'] \
                        < opts['max_num_improvement_loops']:
                    # found an underpopulated cluster: ask for widening
                    if self.log:
                        self.logger.info(
                            "Found %d clusters, but only have %d live "
                            "points, want %d.",
                            self.region.transformLayer.nclusters, nlive,
                            self.cluster_num_live_points * st.nclusters)
                    break

                u, p, L = self._create_point(
                    Lmin=Lmin, ndraw=st.ndraw, active_u=active_u,
                    active_values=active_values)
                child = self.pointpile.make_node(L, u, p)
                st.main_iterator.Lmax = max(st.main_iterator.Lmax, L)
                self._track_insertion_order(
                    st, L, nlive, active_values,
                    opts['insertion_test_zscore_threshold'],
                    opts['insertion_test_window'])
                observe = getattr(self.stepsampler,
                                  'observe_insertion_ranks', None)
                if observe is not None:
                    # nsteps-governor feed (classic path)
                    observe([int((active_values < L).sum())], nlive)
                self._swap_into_region(node, child, u, active_p)
                node.children.append(child)

                if self.log and (region_fresh
                                 or st.it % st.log_interval == 0
                                 or time.time() > st.last_status + 0.1):
                    self._emit_status(st, Lmin, Llo, Lhi, nlive,
                                      strategy_stale,
                                      opts['show_status'])
            else:
                # don't count non-working iterations towards efficiency
                st.it_at_first_region += 1

            st.saved_nodeids.append(node.id)
            st.saved_logl.append(Lmin)
            st.main_iterator.passing_node(rootid, node, active_rootids,
                                          active_values)
            if len(node.children) == 0 and self.region is not None:
                # nlive shrank: radius invalid, force a region rebuild
                self.region.maxradiussq = None
                st.next_update_interval_volume = 1
            st.it += 1
            st.explorer.expand_children_of(rootid, node)

        if self.log:
            self.logger.info("Explored until L=%.1g  ", node.value)
        self.pointstore.flush()
        return Llo, Lhi, strategy_stale

    def _live_coords_if_needed(self, st, Lmin, active_node_ids):
        """Gather the live point coordinate arrays only when they are used.

        The (nlive, dim) fancy-index copies cost host time at high
        iteration rates; iterations served from a step sampler's buffer
        skip them (``needs_live_points``).
        """
        due = st.main_iterator.logVolremaining \
            < st.next_update_interval_volume
        sampler = self.fused_sampler or self.stepsampler
        needs_live = getattr(sampler, 'needs_live_points', None)
        if due or needs_live is None or self.tregion is not None \
                or needs_live(Lmin):
            return (self.pointpile.getu(active_node_ids),
                    self.pointpile.getp(active_node_ids))
        return None, None

    def _plan_more_work(self, st, Llo, Lhi, opts):
        """Decide whether (and where) another pass should explore.

        Returns None to stop, or (Llo, Lhi) for the next pass.
        Appends to opts['minimal_widths'] / opts['target_min_num_children']
        as side effects, mirroring the requirements the strategies raise.
        """
        if opts['max_ncalls'] is not None \
                and self.ncall >= opts['max_ncalls']:
            if self.log:
                self.logger.info(
                    'Reached maximum number of likelihood calls (%d > %d)...',
                    self.ncall, opts['max_ncalls'])
            return None

        opts['improvement_it'] += 1
        if 0 <= opts['max_num_improvement_loops'] \
                < opts['improvement_it']:
            if self.log:
                self.logger.info(
                    'Reached maximum number of improvement loops.')
            return None

        if st.ncall_at_run_start == self.ncall \
                and opts['improvement_it'] > 1:
            if self.log:
                self.logger.info(
                    'No changes made. Probably the strategy was to '
                    'explore in the remainder, but it is irrelevant '
                    'already; try decreasing frac_remain.')
            return None

        minimal_widths = opts['minimal_widths']
        target_min_num_children = opts['target_min_num_children']

        if len(st.region_sequence) > 0:
            Lmin, nlive, nclusters, Lhi_seq = st.region_sequence[-1]
            nnodes_needed = self.cluster_num_live_points * nclusters
            if nlive < nnodes_needed:
                Llo_new, _, plan = self._expand_nodes_before(
                    Lmin, nnodes_needed,
                    opts['update_interval_ncall'] or nlive)
                target_min_num_children.update(plan)
                minimal_widths.append((Llo_new, Lhi_seq, nnodes_needed))
                return -np.inf, np.inf

        if self.log:
            self.logger.info('  logZ = %.4g +- %.4g',
                             st.main_iterator.logZ_bs,
                             st.main_iterator.logZerr_bs)

        saved_logl = np.asarray(st.saved_logl)
        Nlive_min, (Llo_KL, Lhi_KL), (Llo_ess, Lhi_ess) = \
            self._find_strategy(saved_logl, st.main_iterator,
                                dlogz=opts['dlogz'], dKL=opts['dKL'],
                                min_ess=opts['min_ess'])
        Llo = min(Llo_ess, Llo_KL)
        Lhi = max(Lhi_ess, Lhi_KL)
        # numerical safety when all likelihood values are nearly equal
        Lhi = min(Lhi, saved_logl.max() - 0.001)

        if Nlive_min > self.min_num_live_points:
            self.min_num_live_points = Nlive_min
            self._widen_roots_beyond_initial_plateau(
                self.min_num_live_points,
                opts['widen_before_initial_plateau_num_warn'],
                opts['widen_before_initial_plateau_num_max'])
            return Llo, Lhi

        if Llo <= Lhi:
            parents, parent_weights = find_nodes_before(self.root, Llo)
            _, width = count_tree_between(self.root.children, Llo, Lhi)
            nnodes_needed = width * 2
            if self.log:
                self.logger.info(
                    'Widening from %d to %d live points before L=%.1g...',
                    len(parents), nnodes_needed, Llo)
            Llo = -np.inf if len(parents) == 0 \
                else min(n.value for n in parents)
            self.pointstore.reset()
            target_min_num_children.update(self._widen_nodes(
                parents, parent_weights, nnodes_needed,
                opts['update_interval_ncall']))
            minimal_widths.append((Llo, Lhi, nnodes_needed))
            return Llo, Lhi

        return None

    def run_iter(self, **run_options):
        """Iterate towards convergence, yielding results after each pass.

        Parameters are described in :meth:`run`.
        """
        opts = _resolve_run_options(run_options, interactive=True)
        max_iters = opts['max_iters']
        max_ncalls = opts['max_ncalls']
        log_interval = opts['log_interval']
        assert max_iters is None or max_iters > 0, (
            "Invalid value for max_iters: %s." % max_iters)
        assert max_ncalls is None or max_ncalls > 0, (
            "Invalid value for max_ncalls: %s." % max_ncalls)
        self._prepare_run(
            opts['dlogz'], opts['frac_remain'],
            opts['min_num_live_points'], opts['cluster_num_live_points'],
            opts['region_class'],
            opts['widen_before_initial_plateau_num_warn'],
            opts['widen_before_initial_plateau_num_max'])
        if opts['viz_callback'] == 'auto':
            opts['viz_callback'] = get_default_viz_callback()
        opts.update(minimal_widths=[], target_min_num_children={},
                    improvement_it=0)

        Llo, Lhi = -np.inf, np.inf
        Lmax = -np.inf
        strategy_stale = True
        self.results = None

        while True:
            st = self._begin_pass(Lmax, opts['minimal_widths'],
                                  log_interval)
            if self.log and (np.isfinite(Llo) or np.isfinite(Lhi)):
                self.logger.info(
                    "Exploring (in particular: L=%.2f..%.2f) ...", Llo, Lhi)
            Llo, Lhi, strategy_stale = self._explore_pass(
                st, Llo, Lhi, strategy_stale, opts)
            self._update_results(st.main_iterator, st.saved_logl,
                                 st.saved_nodeids)
            yield self.results

            Lmax = st.main_iterator.Lmax
            plan = self._plan_more_work(st, Llo, Lhi, opts)
            if plan is None:
                break
            Llo, Lhi = plan
        self._warn_if_chains_short()

    def _warn_if_chains_short(self):
        """Flag a step-sampler run whose chains did not decorrelate.

        The jump-distance criterion (Buchner+24): if fewer than half the
        chains travelled the region decorrelation scale, the samples are
        not independent and logZ is unreliable. Emits a warning naming
        ``nsteps``; with ``adaptive_nsteps`` only the dispatches at the
        final nsteps are judged.
        """
        ss = self.stepsampler
        try:
            frac = float(ss.far_enough_fraction)
            nsteps = int(ss.nsteps)
            labels = getattr(ss, 'logstat_labels', None) or []
            if 'nsteps' in labels and 'far_enough' in labels \
                    and ss.logstat:
                # adaptive samplers: judge only the dispatches at the
                # final nsteps
                arr = np.asarray(ss.logstat, float)
                cur = arr[:, labels.index('nsteps')] == nsteps
                if cur.any():
                    frac = float(np.nanmean(
                        arr[cur, labels.index('far_enough')]))
            elif getattr(ss, 'adaptive_nsteps', False):
                # no per-row nsteps record: the all-rows average includes
                # the pre-adaptation phase
                return
        except Exception:
            # diagnostics are best-effort (no step sampler, no records):
            # never fail a finished run over them
            return
        if not np.isfinite(frac) or frac >= 0.5:
            return
        msg = ('step sampler chains may be too short: only %.0f%% moved '
               'farther than the region scale (want >50%%) at nsteps=%d. '
               'logZ may be significantly overestimated. Double nsteps '
               '(or pass adaptive_nsteps=True to the fused sampler) and '
               'compare logZ.' % (100 * frac, nsteps))
        warnings.warn(msg)
        if self.log:
            self.logger.warning(msg)

    def _write_chain_files(self, sequence, results, saved_logl):
        """Persist posterior chains, the results schema and the run trace."""
        if self.log:
            self.logger.info("Writing samples and results to disk ...")
        colnames = self.paramnames + self.derivedparamnames
        ws = results['weighted_samples']
        logl_col = np.reshape(saved_logl, (-1, 1))
        wt_col = ws['weights'].reshape((-1, 1))

        np.savetxt(
            os.path.join(self.logs['chains'], 'equal_weighted_post.txt'),
            results['samples'],
            header=' '.join(colnames), comments='')
        for fname, cols in (
                ('weighted_post.txt', ws['points']),
                ('weighted_post_untransformed.txt', ws['upoints'])):
            np.savetxt(
                os.path.join(self.logs['chains'], fname),
                np.hstack((wt_col, logl_col, cols)),
                header=' '.join(['weight', 'logl'] + colnames),
                comments='')

        scalar_results = {k: v for k, v in results.items()
                          if k not in ('weighted_samples', 'samples')}
        with open(os.path.join(self.logs['info'], 'results.json'),
                  'w') as f:
            json.dump(scalar_results, f, indent=4,
                      default=lambda x: x.tolist()
                      if isinstance(x, np.ndarray)
                      else float(x) if isinstance(x, np.floating)
                      else int(x))

        stats = ('mean', 'stdev', 'median', 'errlo', 'errup')
        np.savetxt(
            os.path.join(self.logs['info'], 'post_summary.csv'),
            [[results['posterior'][k][i] for i in range(self.num_params)
              for k in stats]],
            header=','.join(
                ','.join('"%s_%s"' % (name, s) for s in stats)
                for name in colnames),
            delimiter=',', comments='')

        trace_keys = ('logz', 'logzerr', 'logvol', 'nlive', 'logl',
                      'logwt', 'insert_order')
        np.savetxt(
            os.path.join(self.logs['chains'], 'run.txt'),
            np.hstack([np.reshape(sequence[k], (-1, 1))
                       for k in trace_keys]),
            header=' '.join(trace_keys), comments='')
        if self.log:
            self.logger.info("Writing samples and results to disk ... done")

    def _update_results(self, main_iterator, saved_logl, saved_nodeids):
        """Assemble the results dict; replay the tree for the trace."""
        if self.log:
            self.logger.info('Likelihood function evaluations: %d',
                             self.ncall)
        if not hasattr(self, '_segment_phase_s'):
            from collections import Counter
            self._segment_phase_s = Counter()
        t_assembly = time.perf_counter()

        results = combine_results(saved_logl, saved_nodeids, self.pointpile,
                                  main_iterator, mpi_comm=None)
        results['ncall'] = int(self.ncall)
        results['paramnames'] = self.paramnames + self.derivedparamnames
        results['logzerr_single'] = (
            main_iterator.all_H[0] / self.min_num_live_points) ** 0.5

        # replay trace + insertion-order test only: the expensive
        # posterior assembly (combine_results) already ran above on the
        # run's own iterator; replaying it a second time for the fresh
        # counter would roughly double the results-assembly cost.
        replayed = replay_sequence(self.root, self.pointpile,
                                   random=True, check_insertion_order=True)
        if replayed is None:
            sequence, replay_iterator = None, None
        else:
            sequence, replay_iterator = replayed[0], replayed[1]
            results['insertion_order_MWW_test'] = dict(
                independent_iterations=(
                    replay_iterator.insertion_order_runlength),
                converged=replay_iterator.insertion_order_converged,
            )

        # 'results' phase: combine_results + trace replay (the chain
        # files are I/O, not assembly) — published via bench extras so
        # the host results-assembly floor is measured, not asserted
        self._segment_phase_s['results'] += time.perf_counter() - t_assembly
        if self.log_to_disk and sequence is not None:
            self._write_chain_files(sequence, results, saved_logl)
        self.results = results
        self.run_sequence = sequence

    def store_tree(self):
        """Store the exploration tree to results/tree.hdf5."""
        if self.log_to_disk:
            dump_tree(os.path.join(self.logs['results'], 'tree.hdf5'),
                      self.root.children, self.pointpile)

    def _marginal_line(self, name, column, lo_limit, hi_limit,
                       use_unicode):
        """One posterior summary line, with a sparkline histogram."""
        sigma = column.std()
        med = column.mean()
        digits = 3 if sigma == 0 \
            else max(0, int(-np.floor(np.log10(sigma))) + 1)
        fmt = '%%.%df' % digits
        glyphs = ' ▁▂▃▄▅▆▇██'
        try:
            if not use_unicode:
                raise UnicodeEncodeError('ascii', '', 0, 1,
                                         'unicode disabled')
            glyphs.encode(sys.stdout.encoding)
            counts, edges = np.histogram(column, bins=40)
            pad = 2 * (edges[1] - edges[0])
            lo = max(lo_limit, edges[0] - pad)
            hi = min(hi_limit, edges[-1] + pad)
            counts, edges = np.histogram(column,
                                         bins=np.linspace(lo, hi, 40))
            levels = np.ceil(counts * 7 / counts.max()).astype(int)
            spark = ''.join(glyphs[k] for k in levels)
            return '    %-20s: %-6s│%s│%-6s    %s +- %s' % (
                name, fmt % edges[0], spark, fmt % edges[-1],
                fmt % med, fmt % sigma)
        except Exception:
            return ('    %-20s' + fmt + ' +- ' + fmt) % (name, med, sigma)

    def print_results(self, use_unicode=True):
        """Print a summary of evidence and parameter posteriors."""
        if not self.log:
            return
        print()
        print('logZ = %(logz).3f +- %(logzerr).3f' % self.results)
        print('  single instance: logZ = %(logz_single).3f '
              '+- %(logzerr_single).3f' % self.results)
        print('  bootstrapped   : logZ = %(logz_bs).3f '
              '+- %(logzerr_bs).3f' % self.results)
        print('  tail           : logZ = +- %(logzerr_tail).3f'
              % self.results)
        print('insert order U test : converged: %(converged)s correlation: '
              '%(independent_iterations)s iterations'
              % self.results['insertion_order_MWW_test'])
        if self.stepsampler and hasattr(self.stepsampler,
                                        'print_diagnostic'):
            self.stepsampler.print_diagnostic()
        print()
        for i, name in enumerate(self.paramnames + self.derivedparamnames):
            print(self._marginal_line(
                name, self.results['samples'][:, i],
                self.transform_limits[i, 0], self.transform_limits[i, 1],
                use_unicode))
        print()

    def _render_figure(self, kind):
        """Draw one diagnostic figure and save it under plots/<kind>.pdf."""
        import matplotlib.pyplot as plt

        from . import plot as _plotmod
        if self.log:
            self.logger.debug('Making %s plot ...', kind)
        if kind == 'corner':
            _plotmod.cornerplot(
                self.results, logger=self.logger if self.log else None)
        elif kind == 'trace':
            _plotmod.traceplot(results=self.run_sequence,
                               labels=self.paramnames
                               + self.derivedparamnames)
        else:
            _plotmod.runplot(results=self.run_sequence, logplot=True)
        if self.log_to_disk:
            plt.savefig(os.path.join(self.logs['plots'], kind + '.pdf'),
                        bbox_inches='tight')
            plt.close()
            self.logger.debug('Making %s plot ... done', kind)

    def plot(self):
        """Make corner, run and trace plots."""
        for kind in ('corner', 'run', 'trace'):
            self._render_figure(kind)

    def plot_corner(self):
        """Write a corner plot to the plots directory."""
        self._render_figure('corner')

    def plot_trace(self):
        """Write a trace plot to the plots directory."""
        self._render_figure('trace')

    def plot_run(self):
        """Write a run diagnostic plot to the plots directory."""
        self._render_figure('run')


def read_file(log_dir, x_dim, num_bootstraps=20, random=True, verbose=False,
              check_insertion_order=True):
    """Read a stored run and recompute the logZ sequence.

    Parameters
    ----------
    log_dir: str
        run directory containing ``results/points.hdf5``
    x_dim: int
        dimensionality
    num_bootstraps: int
        number of bootstrap estimators
    random: bool
        randomize volume estimates
    verbose: bool
        show progress
    check_insertion_order: bool
        run the MWW insertion-order convergence test

    Returns
    -------
    sequence: dict
        per-iteration logz/logzerr/logvol/samples_n/logwt/logl arrays
    final: dict
        results dictionary as from :meth:`ReactiveNestedSampler.run`
    """
    stored, _, _ = _load_stored_run(log_dir, x_dim)
    pointpile = PointPile(x_dim, stored.num_params)

    roots = [pointpile.make_node(logl, u, v)
             for u, v, logl in stored.pop_initial()]
    root = TreeNode(id=-1, value=-np.inf, children=roots)

    def attach_children(node, main_iterator):
        """Graft all stored children of *node* during replay."""
        while True:
            _, row = stored.pop(node.value)
            if row is None:
                return
            u, v, logl = stored.unpack(row)
            assert logl > node.value, (logl, node.value)
            main_iterator.Lmax = max(main_iterator.Lmax, logl)
            node.children.append(pointpile.make_node(logl, u, v))

    return logz_sequence(root, pointpile, nbootstraps=num_bootstraps,
                         random=random, onNode=attach_children,
                         verbose=verbose,
                         check_insertion_order=check_insertion_order)
