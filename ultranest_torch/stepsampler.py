# noqa: D400 D205
"""
MCMC-like step sampling
-----------------------

Single-chain step samplers making one likelihood call per iteration:
Metropolis-Hastings random walks and slice samplers with a family of
direction proposals, proposal-scale and step-count adaptation, and
jump-distance diagnostics (Buchner+24, arxiv:2402.11936).

The port's own copy of the reference package's ``stepsampler.py``: numpy
on the host, the same random draws in the same order, so a seeded chain
is the reference's chain. These samplers are inherently sequential; the
region they walk in is built on the sampler's device (its bootstrap
radius runs in kernel K2 there, and ``region.inside``, ``region.sample``
and ``region.compute_mean_pair_distance`` run on ``region.device``), and
every array that crosses this module's interface is a numpy array. For
device-batched sampling use :mod:`ultranest_torch.popstepsampler` or the
fused :mod:`ultranest_torch.popfused`, which advance whole walker
populations per device call. This module exists for API parity and for
likelihoods that cannot be vectorized.
"""

from warnings import warn

import numpy as np

from .utils import listify as _listify

__all__ = [
    'generate_random_direction', 'generate_cube_oriented_direction',
    'generate_cube_oriented_differential_direction',
    'generate_differential_direction',
    'generate_partial_differential_direction',
    'generate_region_oriented_direction', 'generate_region_random_direction',
    'generate_mixture_random_direction', 'generate_region_sample_direction',
    'StepSampler', 'MHSampler', 'CubeMHSampler', 'RegionMHSampler',
    'SliceSampler', 'CubeSliceSampler', 'RegionSliceSampler',
    'BallSliceSampler', 'RegionBallSliceSampler',
    'RegionSequentialSliceSampler', 'SpeedVariableRegionSliceSampler',
    'SequentialDirectionGenerator', 'SequentialRegionDirectionGenerator',
    'OrthogonalDirectionGenerator', 'SpeedVariableGenerator',
    'select_random_livepoint', 'IslandPopulationRandomLivepointSelector',
    'ellipsoid_bracket', 'crop_bracket_at_unit_cube',
]


def _random_unit_vector(ndim):
    v = np.random.standard_normal(ndim)
    return v / np.linalg.norm(v)


def _distinct_pair(n):
    """Two distinct random indices below *n*."""
    first = np.random.randint(n)
    second = np.random.randint(n - 1)
    return first, second + (second >= first)


def generate_random_direction(ui, region, scale=1):
    """Draw an isotropic direction vector of length *scale* (hit-and-run)."""
    del region
    return _random_unit_vector(len(ui)) * scale


def generate_cube_oriented_direction(ui, region, scale=1):
    """Draw a unit-cube axis direction (slice sampling on one parameter)."""
    del region
    v = np.zeros(len(ui))
    v[np.random.randint(len(ui))] = scale
    return v


def _live_pair_span(region, axis, scale):
    """Live-point pair difference on one axis; redrawn until nonzero."""
    nlive = len(region.u)
    span = 0.0
    while span == 0.0:
        a, b = _distinct_pair(nlive)
        span = (region.u[a, axis] - region.u[b, axis]) * scale
    return span


def generate_cube_oriented_differential_direction(ui, region, scale=1):
    """Axis direction with length from the live-point spread on that axis."""
    ndim = region.u.shape[1]
    v = np.zeros(ndim)
    axis = np.random.randint(ndim)
    v[axis] = _live_pair_span(region, axis, scale)
    return v


def generate_differential_direction(ui, region, scale=1):
    """Differential-evolution direction: difference of two live points."""
    a, b = _distinct_pair(len(region.u))
    return (region.u[a] - region.u[b]) * scale


def generate_partial_differential_direction(ui, region, scale=1):
    """Differential direction with only ~10% of parameters varying."""
    nlive, ndim = region.u.shape
    a = np.random.randint(nlive)
    while True:
        _, b = _distinct_pair(nlive)
        delta = region.u[a] - region.u[b]
        keep = np.random.uniform(size=ndim) <= 0.1
        keep[np.random.randint(ndim)] = True
        delta = np.where(keep, delta, 0.0)
        if delta.any():
            return delta


def generate_region_oriented_direction(ui, region, scale=1):
    """Direction along a random whitened-space principal axis."""
    axes = region.transformLayer.axes
    return axes[np.random.randint(len(ui))] * scale


def generate_region_random_direction(ui, region, scale=1):
    """Random direction drawn from the region covariance (t-space ball)."""
    t = _random_unit_vector(len(ui)) * scale
    return region.transformLayer.axes @ t


def generate_mixture_random_direction(ui, region, scale=1):
    """50/50 mix of differential and region-oriented directions.

    The best general-purpose proposal according to arxiv:2211.09426.
    """
    pick = generate_differential_direction if np.random.uniform() < 0.5 \
        else generate_region_oriented_direction
    return pick(ui, region, scale=scale)


def generate_region_sample_direction(ui, region, scale=1):
    """Direction towards a fresh region sample."""
    while True:
        candidates = region.sample(nsamples=200)
        if len(candidates):
            return (candidates[0] - ui) * scale


def inside_region(region, unew, uold):
    """Check whether points *unew* are inside the region."""
    del uold
    return region.inside(unew)


def _chain_span_exceeds_radius(region, ustart, uend):
    """Whitened distance between two chain points vs the MLFriends radius."""
    ta, tb = region.transformLayer.transform(np.vstack((ustart, uend)))
    d2 = ((ta - tb) ** 2).sum()
    return d2 > region.maxradiussq, [d2 ** 0.5, region.maxradiussq ** 0.5]


def adapt_proposal_move_distances(region, history, mean_pair_distance, ndim):
    """Chain start-to-end distance must exceed the MLFriends radius.

    Returns (far_enough, [distance, radius]).
    """
    return _chain_span_exceeds_radius(region, history[0][0], history[-1][0])


def adapt_proposal_move_distances_midway(region, history, mean_pair_distance,
                                         ndim):
    """Start-to-middle distance must exceed the MLFriends radius."""
    mid = max(1, len(history) // 2)
    return _chain_span_exceeds_radius(region, history[0][0], history[mid][0])


def _proposal_track(region, history):
    return region.transformLayer.transform(
        np.asarray([u for u, _ in history]))


def adapt_proposal_total_distances(region, history, mean_pair_distance, ndim):
    """Check jump distance (deprecated)."""
    warn('adapt_proposal_total_distances is deprecated.',
         DeprecationWarning, stacklevel=2)
    track = _proposal_track(region, history)
    total = np.linalg.norm(track - track[0], axis=1).sum()
    return total > mean_pair_distance / ndim, [total, mean_pair_distance]


def adapt_proposal_total_distances_NN(region, history, mean_pair_distance,
                                      ndim):
    """Check jump distance (deprecated)."""
    warn('adapt_proposal_total_distances_NN is deprecated.',
         DeprecationWarning, stacklevel=2)
    track = _proposal_track(region, history)
    total = np.linalg.norm(track - track[0], axis=1).sum()
    radius = region.maxradiussq ** 0.5
    return total > radius, [total, radius]


def adapt_proposal_summed_distances(region, history, mean_pair_distance,
                                    ndim):
    """Check jump distance (deprecated)."""
    warn('adapt_proposal_summed_distances is deprecated.',
         DeprecationWarning, stacklevel=2)
    track = _proposal_track(region, history)
    total = np.linalg.norm(np.diff(track, axis=0), axis=1).sum()
    return total > mean_pair_distance / ndim, [total, mean_pair_distance]


def adapt_proposal_summed_distances_NN(region, history, mean_pair_distance,
                                       ndim):
    """Check jump distance (deprecated)."""
    warn('adapt_proposal_summed_distances_NN is deprecated.',
         DeprecationWarning, stacklevel=2)
    track = _proposal_track(region, history)
    total = np.linalg.norm(np.diff(track, axis=0), axis=1).sum()
    radius = region.maxradiussq ** 0.5
    return total > radius, [total, radius]


def select_random_livepoint(us, Ls, Lmin):
    """Pick a random live point as chain start."""
    return np.random.randint(len(Ls))


class IslandPopulationRandomLivepointSelector:
    """Chain-start selector keeping live point islands isolated.

    Chains are started from the island (contiguous index chunk of size
    ``island_size``) of the dead point, preventing run-away clumping while
    letting modes die out naturally.
    """

    def __init__(self, island_size, exchange_probability=0):
        """Set up islands of *island_size* with optional migration."""
        assert island_size > 0
        assert 0 <= exchange_probability <= 1
        self.island_size = island_size
        self.exchange_probability = exchange_probability

    def __call__(self, us, Ls, Lmin):
        """Select a live point index to start the next chain from."""
        dead = np.flatnonzero(Ls == Lmin)
        migrate = self.exchange_probability > 0 and \
            np.random.uniform() < self.exchange_probability
        if len(dead) == 0 or migrate:
            return np.random.randint(len(Ls))
        island_start = (dead[0] // self.island_size) * self.island_size
        island_end = min(len(Ls), island_start + self.island_size)
        return np.random.randint(island_start, island_end)


# registry of the chain-length criteria, keyed by their public names
_nsteps_check_options = {False: None}
_nsteps_check_options.update(zip(
    ('move-distance', 'move-distance-midway',
     'proposal-total-distances', 'proposal-total-distances-NN',
     'proposal-summed-distances', 'proposal-summed-distances-NN'),
    (adapt_proposal_move_distances, adapt_proposal_move_distances_midway,
     adapt_proposal_total_distances, adapt_proposal_total_distances_NN,
     adapt_proposal_summed_distances, adapt_proposal_summed_distances_NN)))


class StepSampler:
    """Base class: a chain staggering around, one likelihood call per step.

    The proposal scale adapts towards a 50% acceptance rate; the number of
    steps can be checked or adapted with jump-distance criteria.
    """

    def __init__(self, nsteps, generate_direction, scale=1.0,
                 check_nsteps='move-distance', adaptive_nsteps=False,
                 max_nsteps=1000, region_filter=False, log=False,
                 starting_point_selector=select_random_livepoint):
        """Initialise sampler.

        Parameters
        ----------
        nsteps: int
            number of accepted steps until a sample counts as independent
        generate_direction: function
            direction proposal (see module-level generators); when in
            doubt use :func:`generate_mixture_random_direction`
        scale: float
            initial proposal size
        check_nsteps: False or str
            chain diagnostic: 'move-distance' (recommended),
            'move-distance-midway', 'proposal-total-distances[-NN]',
            'proposal-summed-distances[-NN]'
        adaptive_nsteps: False or str
            adapt nsteps with the same criteria (may bias results)
        max_nsteps: int
            upper bound for adaptive nsteps
        region_filter: bool
            reject proposals outside the region before likelihood calls
        log: file or False
            file to log chain statistics to
        starting_point_selector: function
            (us, Ls, Lmin) -> index of the chain starting live point
        """
        for label, choice in (('check_nsteps', check_nsteps),
                              ('adaptive_nsteps', adaptive_nsteps)):
            if choice not in _nsteps_check_options:
                raise ValueError(
                    "%s must be one of: %s, not '%s'"
                    % (label, list(_nsteps_check_options), choice))
        if adaptive_nsteps and nsteps > max_nsteps:
            raise AssertionError(
                'Invalid adapting configuration: provided nsteps=%d exceeds '
                'provided max_nsteps=%d' % (nsteps, max_nsteps))

        self.nsteps = nsteps
        self.max_nsteps = max_nsteps
        self.scale = scale
        self.next_scale = scale
        self.nudge = 1.1 ** (1.0 / nsteps)
        self.nsteps_nudge = 1.01
        self.generate_direction = generate_direction
        self.check_nsteps = check_nsteps
        self.check_nsteps_function = _nsteps_check_options[check_nsteps]
        self.adaptive_nsteps = adaptive_nsteps
        self.adaptive_nsteps_function = _nsteps_check_options[adaptive_nsteps]
        needs_mpd = ('proposal-total-distances',
                     'proposal-summed-distances')
        self.adaptive_nsteps_needs_mean_pair_distance = \
            adaptive_nsteps in needs_mpd or check_nsteps in needs_mpd
        self.mean_pair_distance = np.nan
        self.starting_point_selector = starting_point_selector
        self.region_filter = region_filter
        if log:
            assert hasattr(log, 'write'), (
                'log argument should be a file, use log=open(filename, "w")')
        self.log = log

        self.history = []
        self.nrejects = 0
        self.logstat = []
        self.logstat_labels = ['rejection_rate', 'scale', 'steps']
        if adaptive_nsteps or check_nsteps:
            self.logstat_labels += ['jump-distance', 'reference-distance']

    def __str__(self):
        """Return string representation."""
        kind = type(self).__name__
        if self.adaptive_nsteps:
            return '%s(adaptive_nsteps=%s, generate_direction=%s)' % (
                kind, self.adaptive_nsteps, self.generate_direction)
        return '%s(nsteps=%d, generate_direction=%s)' % (
            kind, self.nsteps, self.generate_direction)

    def _log_row(self, rejection_rate):
        row = [rejection_rate, self.scale, self.nsteps]
        if self.adaptive_nsteps or self.check_nsteps:
            row += [np.nan, np.nan]
        self.logstat.append(row)

    def plot(self, filename):
        """Plot sampler statistics to *filename* (+ data to .txt.gz)."""
        if not self.logstat:
            return
        import matplotlib.pyplot as plt
        stats = np.asarray(
            [row[:len(self.logstat_labels)] for row in self.logstat], float)
        plt.figure(figsize=(10, 1 + 3 * len(self.logstat_labels)))
        for i, label in enumerate(self.logstat_labels):
            series = stats[:, i]
            plt.subplot(len(self.logstat_labels), 1, 1 + i)
            plt.ylabel(label)
            plt.plot(series)
            # block-averaged trend line
            nfull = (len(series) // 20) * 20
            if nfull:
                trend = series[:nfull].reshape((-1, 20)).mean(axis=1)
                plt.plot(np.arange(len(trend)) * 20, trend)
            if np.nanmin(series) > 0:
                plt.yscale('log')
        plt.savefig(filename, bbox_inches='tight')
        np.savetxt(filename + '.txt.gz', stats,
                   header=','.join(self.logstat_labels), delimiter=',')
        plt.close()

    def _jump_and_reference_distances(self):
        if not self.logstat or 'jump-distance' not in self.logstat_labels:
            return None, None
        cols = (self.logstat_labels.index('jump-distance'),
                self.logstat_labels.index('reference-distance'))
        rows = np.asarray([[row[c] if len(row) > c else np.nan
                            for c in cols] for row in self.logstat])
        return rows[:, 0], rows[:, 1]

    @property
    def mean_jump_distance(self):
        """Geometric mean relative jump distance."""
        jumps, refs = self._jump_and_reference_distances()
        if jumps is None:
            return np.nan
        return np.exp(np.nanmean(np.log(jumps / refs + 1e-10)))

    @property
    def far_enough_fraction(self):
        """Fraction of jumps exceeding the reference distance."""
        jumps, refs = self._jump_and_reference_distances()
        if jumps is None:
            return np.nan
        return np.nanmean(jumps > refs)

    def get_info_dict(self):
        """Return performance diagnostics (rates, scales, jump distances)."""
        stats = np.asarray([row[:3] for row in self.logstat], float) \
            if self.logstat else np.full((0, 3), np.nan)
        last = dict(zip(self.logstat_labels, self.logstat[-1])) \
            if len(self.logstat) > 1 else \
            dict.fromkeys(self.logstat_labels, np.nan)
        with np.errstate(all='ignore'):
            return dict(
                num_logs=len(self.logstat),
                rejection_rate=np.nanmean(stats[:, 0]) if len(stats) else np.nan,
                mean_scale=np.nanmean(stats[:, 1]) if len(stats) else np.nan,
                mean_nsteps=np.nanmean(stats[:, 2]) if len(stats) else np.nan,
                mean_distance=self.mean_jump_distance,
                frac_far_enough=self.far_enough_fraction,
                last_logstat=last,
            )

    def print_diagnostic(self):
        """Print the jump-distance diagnostic with advice."""
        if not self.logstat:
            print("diagnostic unavailable, no recorded steps found")
            return
        if 'jump-distance' not in self.logstat_labels:
            print("turn on check_nsteps in the step sampler for diagnostics")
            return
        frac = self.far_enough_fraction
        if frac < 0.5:
            advice = (': very fishy. Double nsteps and see if fraction and '
                      'lnZ change)')
        elif frac < 0.66:
            advice = ': fishy. Double nsteps and see if fraction and lnZ change)'
        else:
            advice = ' (should be >50%)'
        print('step sampler diagnostic: jump distance %.2f (should be >1), '
              'far enough fraction: %.2f%% %s'
              % (self.mean_jump_distance, frac * 100, advice))

    def plot_jump_diagnostic_histogram(self, filename, **kwargs):
        """Plot the relative jump distance histogram to *filename*."""
        jumps, refs = self._jump_and_reference_distances()
        if jumps is None:
            return
        import matplotlib.pyplot as plt
        plt.hist(np.log10(jumps / refs + 1e-10), **kwargs)
        ylo, yhi = plt.ylim()
        plt.vlines(np.log10(self.mean_jump_distance), ylo, yhi)
        plt.ylim(ylo, yhi)
        plt.ylabel('Frequency')
        plt.xlabel('log(relative step distance)')
        plt.title(str(self.check_nsteps or self.adaptive_nsteps))
        plt.savefig(filename, bbox_inches='tight')
        plt.close()

    def move(self, ui, region, ndraw=1, plot=False):
        """Propose a move from *ui* (implemented by subclasses)."""
        raise NotImplementedError()

    def adjust_outside_region(self):
        """Shrink the proposal after landing outside the region."""
        print("ineffective proposal scale (%g). shrinking..." % self.scale)
        shrink = self.nudge ** 10
        self.scale /= shrink
        self.next_scale /= shrink
        assert self.scale > 0 and self.next_scale > 0
        self._log_row(-1.0)

    def adjust_accept(self, accepted, unew, pnew, Lnew, nc):
        """Update scale and history after a proposal outcome."""
        if accepted:
            self.next_scale *= self.nudge
            self.history.append((unew.copy(), Lnew.copy()))
        else:
            self.nrejects += 1
            self.next_scale /= self.nudge ** 10
            self.history.append(self.history[-1])
        assert self.next_scale > 0, self.next_scale

    def adapt_nsteps(self, region):
        """Check and possibly adapt the number of steps per chain."""
        if not (self.adaptive_nsteps or self.check_nsteps):
            return
        if len(self.history) < self.nsteps:
            print("not adapting/checking nsteps, incomplete history",
                  len(self.history), self.nsteps)
            return
        if self.adaptive_nsteps_needs_mean_pair_distance:
            assert np.isfinite(self.mean_pair_distance)
        ndim = region.u.shape[1]
        if self.check_nsteps:
            _, extra = self.check_nsteps_function(
                region, self.history, self.mean_pair_distance, ndim)
            self.logstat[-1][-2:] = extra
        if not self.adaptive_nsteps:
            return
        far_enough, extra = self.adaptive_nsteps_function(
            region, self.history, self.mean_pair_distance, ndim)
        self.logstat[-1][-2:] = extra
        if far_enough:
            proposal = min(self.nsteps - 1,
                           int(self.nsteps / self.nsteps_nudge))
        else:
            proposal = max(self.nsteps + 1,
                           int(self.nsteps * self.nsteps_nudge))
        self.nsteps = int(np.clip(proposal, 1, self.max_nsteps))

    def finalize_chain(self, region=None, Lmin=None, Ls=None):
        """Record chain statistics, adapt the scale, reset the chain."""
        self._log_row(self.nrejects / self.nsteps)
        if self.log:
            self._write_chain_log(region, Lmin, Ls)
        if self.adaptive_nsteps or self.check_nsteps:
            self.adapt_nsteps(region=region)
        # the scale may move at most nudge^10 per chain
        cap = self.nudge ** 10
        self.scale = float(np.clip(self.next_scale, self.scale / cap,
                                   self.scale * cap))
        self.next_scale = self.scale
        self.history = []
        self.nrejects = 0

    def _write_chain_log(self, region, Lmin, Ls):
        ustart, Lstart = self.history[0]
        uend, Lend = self.history[-1]
        tstart, tend = region.transformLayer.transform(
            np.vstack((ustart, uend)))
        nn_start = np.argmin(((region.unormed - tstart) ** 2).sum(axis=1))
        nn_end = np.argmin(((region.unormed - tend) ** 2).sum(axis=1))
        np.savetxt(self.log, [_listify(
            [Lmin], ustart, uend, tstart, tend,
            [self.nsteps, region.maxradiussq ** 0.5,
             self.mean_pair_distance,
             np.sum(Ls > Lstart), np.sum(Ls > Lend), nn_start, nn_end])])
        self.log.flush()

    def new_chain(self, region=None):
        """Start a new chain, resetting statistics."""
        self.history = []
        self.nrejects = 0

    def region_changed(self, Ls, region):
        """React to a region rebuild."""
        if self.adaptive_nsteps_needs_mean_pair_distance:
            self.mean_pair_distance = region.compute_mean_pair_distance()

    def _resume_or_start_chain(self, region, Lmin, us, Ls):
        """Truncate the chain at the threshold; start fresh if empty."""
        cut = next((j for j, (_, Lj) in enumerate(self.history)
                    if not Lj > Lmin), None)
        if cut is not None:
            self.history = self.history[:cut]
        if self.history:
            return self.history[-1]
        self.new_chain(region)
        self.starti = self.starting_point_selector(us, Ls, Lmin)
        ui = us[self.starti, :]
        Li = Ls[self.starti]
        self.history.append((ui.copy(), Li.copy()))
        return ui, Li

    def _acceptable_proposal(self, ui, region, transform, tregion, ndraw,
                             plot):
        """Generate proposals until one passes the geometric filters."""
        while True:
            candidates = self.move(ui, region, ndraw=ndraw, plot=plot)
            in_cube = np.logical_and(candidates > 0,
                                     candidates < 1).all(axis=1)
            if not in_cube.any():
                self.adjust_outside_region()
                continue
            candidates = candidates[in_cube]
            if self.region_filter:
                ok = inside_region(region, candidates, ui)
                if not ok.any():
                    print("rejected by region")
                    self.adjust_outside_region()
                    continue
                candidates = candidates[ok]
                if tregion is not None:
                    phys = transform(candidates)
                    ok = tregion.inside(phys)
                    candidates = candidates[ok]
            if len(candidates):
                return candidates[0]

    def __next__(self, region, Lmin, us, Ls, transform, loglike, ndraw=10,
                 plot=False, tregion=None):
        """Advance the chain; return the next independent point when ready.

        Returns (u, p, L, nc); the first three are None while the chain is
        still running.
        """
        ui, Li = self._resume_or_start_chain(region, Lmin, us, Ls)
        unew = self._acceptable_proposal(ui, region, transform, tregion,
                                         ndraw, plot)
        pnew = transform(unew.reshape((1, -1)))
        Lnew = loglike(pnew)[0]
        self.adjust_accept(Lnew > Lmin, unew, pnew, Lnew, 1)

        if len(self.history) > self.nsteps:
            u, L = self.history[-1]
            p = transform(u.reshape((1, -1)))[0]
            self.finalize_chain(region=region, Lmin=Lmin, Ls=Ls)
            return u, p, L, 1
        return None, None, None, 1


class MHSampler(StepSampler):
    """Gaussian random walk."""

    def move(self, ui, region, ndraw=1, plot=False):
        """Propose Gaussian jitter along the generated direction."""
        direction = self.generate_direction(ui, region, scale=self.scale)
        amplitudes = np.random.standard_normal((min(10, ndraw), 1))
        return ui[None, :] + direction[None, :] * amplitudes


def CubeMHSampler(*args, **kwargs):
    """Gaussian Metropolis-Hastings sampler in the unit cube."""
    kwargs.setdefault('generate_direction', generate_random_direction)
    return MHSampler(*args, **kwargs)


def RegionMHSampler(*args, **kwargs):
    """Gaussian Metropolis-Hastings sampler in whitened space."""
    kwargs.setdefault('generate_direction',
                      generate_region_random_direction)
    return MHSampler(*args, **kwargs)


class SliceSampler(StepSampler):
    """Slice sampler with stepping-out and shrinking, respecting the region.

    The per-step state machine has three phases: expand the left end by
    doubling until it leaves the slice, then the right end, then shrink
    on the established bracket until a point above the threshold is
    found. Each likelihood evaluation advances the machine by one
    transition.
    """

    # phases of one slice step
    _GROW_LEFT, _GROW_RIGHT, _SHRINK = 0, 1, 2

    def new_chain(self, region=None):
        """Start a new chain and reset the slice state."""
        self._slice = None
        self.history = []
        self.nrejects = 0

    def _begin_slice(self, ui, region):
        self._slice = dict(
            v=self.generate_direction(ui, region),
            lo=-self.scale, hi=self.scale, t=0.0,
            phase=SliceSampler._GROW_LEFT)

    def _end_expansion(self):
        """Right end established: adapt the scale to the bracket size."""
        s = self._slice
        if max(-s['lo'], s['hi']) > self.next_scale:
            self.next_scale *= 1.1
        else:
            self.next_scale /= 1.1

    def adjust_accept(self, accepted, unew, pnew, Lnew, nc):
        """Advance the slice state machine on an evaluation outcome."""
        s = self._slice
        phase = s['phase']
        if phase == SliceSampler._GROW_LEFT:
            if accepted:
                s['lo'] *= 2
            else:
                s['phase'] = SliceSampler._GROW_RIGHT
        elif phase == SliceSampler._GROW_RIGHT:
            if accepted:
                s['hi'] *= 2
            else:
                s['phase'] = SliceSampler._SHRINK
                self._end_expansion()
        else:
            if accepted:
                self._slice = None
                self.history.append((unew.copy(), Lnew.copy()))
            else:
                self.nrejects += 1
                t = s['t']
                if t < 0:
                    s['lo'] = t
                elif t > 0:
                    s['hi'] = t

    def adjust_outside_region(self):
        """Treat an out-of-region proposal as a rejection."""
        self.adjust_accept(False, unew=None, pnew=None, Lnew=None, nc=0)

    def _passes_filter(self, region, x, ui):
        return not self.region_filter or \
            inside_region(region, x.reshape((1, -1)), ui)

    def move(self, ui, region, ndraw=1, plot=False):
        """Return the next slice evaluation point."""
        if self._slice is None:
            self._begin_slice(ui, region)
        s = self._slice

        while s['phase'] == SliceSampler._GROW_LEFT:
            x = ui + s['v'] * s['lo']
            if self._passes_filter(region, x, ui):
                return x.reshape((1, -1))
            s['phase'] = SliceSampler._GROW_RIGHT

        while s['phase'] == SliceSampler._GROW_RIGHT:
            x = ui + s['v'] * s['hi']
            if self._passes_filter(region, x, ui):
                return x.reshape((1, -1))
            s['phase'] = SliceSampler._SHRINK
            self._end_expansion()

        while True:
            t = np.random.uniform(s['lo'], s['hi'])
            x = ui + s['v'] * t
            s['t'] = t
            if self._passes_filter(region, x, ui):
                return x.reshape((1, -1))
            # geometric rejection also shrinks the bracket
            if t < 0:
                s['lo'] = t
            else:
                s['hi'] = t


def CubeSliceSampler(*args, **kwargs):
    """Slice sampler iterating unit-cube axes."""
    kwargs.setdefault('generate_direction', SequentialDirectionGenerator())
    return SliceSampler(*args, **kwargs)


def RegionSliceSampler(*args, **kwargs):
    """Slice sampler along random whitened-space axes."""
    kwargs.setdefault('generate_direction',
                      generate_region_oriented_direction)
    return SliceSampler(*args, **kwargs)


def BallSliceSampler(*args, **kwargs):
    """Hit-and-run sampler with isotropic directions."""
    kwargs.setdefault('generate_direction', generate_random_direction)
    return SliceSampler(*args, **kwargs)


def RegionBallSliceSampler(*args, **kwargs):
    """Hit-and-run sampler with region-covariance directions."""
    kwargs.setdefault('generate_direction',
                      generate_region_random_direction)
    return SliceSampler(*args, **kwargs)


class SequentialDirectionGenerator:
    """Cycles deterministically through the unit-cube axes."""

    def __init__(self):
        """Initialise at axis 0."""
        self.axis_index = 0

    def __call__(self, ui, region, scale=1):
        """Return the next axis direction, scaled by a live-point pair."""
        ndim = region.u.shape[1]
        axis = self.axis_index % ndim
        self.axis_index = axis + 1
        v = np.zeros(ndim)
        v[axis] = _live_pair_span(region, axis, scale)
        return v

    def __str__(self):
        """Create string representation."""
        return type(self).__name__ + '()'


class SequentialRegionDirectionGenerator:
    """Cycles deterministically through the whitened-space axes."""

    axis_index = 0

    def __call__(self, ui, region, scale=1):
        """Return the next whitened axis as a u-space direction."""
        ndim = len(ui)
        axis = self.axis_index % ndim
        self.axis_index = axis + 1
        # displace by a small whitened step and renormalize in u-space
        ti = region.transformLayer.transform(ui)
        probe = np.zeros(ndim)
        probe[axis] = 1e-3
        delta = region.transformLayer.untransform(ti + probe) - ui
        return delta * (scale / np.linalg.norm(delta))

    def __str__(self):
        """Create string representation."""
        return type(self).__name__ + '()'


def RegionSequentialSliceSampler(*args, **kwargs):
    """Slice sampler cycling through whitened-space axes."""
    kwargs.setdefault('generate_direction',
                      SequentialRegionDirectionGenerator())
    return SliceSampler(*args, **kwargs)


class OrthogonalDirectionGenerator:
    """Orthogonalizes batches of proposed directions via QR."""

    def __init__(self, generate_direction):
        """Wrap *generate_direction* with Gram-Schmidt orthogonalization."""
        self.axis_index = 0
        self.generate_direction = generate_direction
        self.directions = None

    def __str__(self):
        """Return string representation."""
        return type(self).__name__ + '(generate_direction=%s)' \
            % self.generate_direction

    def __call__(self, ui, region, scale=1):
        """Return the next orthogonalized direction."""
        ndim = len(ui)
        if self.directions is None or self.axis_index >= ndim:
            batch = np.vstack([
                self.generate_direction(ui, region, scale=scale)
                for _ in range(ndim)])
            q, r = np.linalg.qr(batch)
            self.directions = q * np.diag(r)[None, :]
            self.axis_index = 0
        v = self.directions[self.axis_index]
        self.axis_index += 1
        return v


class SpeedVariableGenerator:
    """Varies only subsets of parameters per step (fast/slow parameters).

    *step_matrix* is either a (nsteps, ndim) bool matrix or a list of
    slices, each row/entry giving the parameters allowed to vary.
    """

    def __init__(self, step_matrix,
                 generate_direction=generate_region_random_direction):
        """Initialise with the update pattern *step_matrix*."""
        self.step_matrix = step_matrix
        self.nsteps = len(step_matrix)
        self.axis_index = 0
        self.generate_direction = generate_direction

    def __call__(self, ui, region, scale=1):
        """Return a direction restricted to the active dimensions."""
        full = self.generate_direction(ui=ui, region=region, scale=scale)
        row = self.axis_index % self.nsteps
        self.axis_index = row + 1
        active = self.step_matrix[row]
        restricted = np.zeros(len(ui))
        restricted[active] = full[active]
        return restricted


def SpeedVariableRegionSliceSampler(step_matrix, *args, **kwargs):
    """Slice sampler varying user-defined parameter subsets per step."""
    generate_direction = kwargs.pop('generate_direction',
                                    generate_region_random_direction)
    nsteps = kwargs.pop('nsteps', len(step_matrix))
    return SliceSampler(
        *args, **kwargs, nsteps=nsteps,
        generate_direction=SpeedVariableGenerator(
            step_matrix=step_matrix, generate_direction=generate_direction))


def ellipsoid_bracket(ui, v, ellipsoid_center, ellipsoid_inv_axes,
                      ellipsoid_radius_square):
    """Line-ellipsoid intersection interval along direction *v* from *ui*.

    Returns (left, right) with left <= 0 <= right.
    """
    # solve |(x0 + t v)|^2 = r^2 in the ellipsoid's whitened frame
    vw = v @ ellipsoid_inv_axes
    xw = (ui - ellipsoid_center) @ ellipsoid_inv_axes
    a = vw @ vw
    half_b = vw @ xw
    c = xw @ xw - ellipsoid_radius_square
    assert c <= 0, ("outside ellipsoid", c)
    disc = half_b * half_b - a * c
    assert disc >= 0, ("no intersection", disc, c)
    root = disc ** 0.5
    t1 = (-half_b - root) / a
    t2 = (-half_b + root) / a
    return min(0, t1, t2), max(0, t1, t2)


def _crop_end(ui, v, t, epsilon):
    """Pull one bracket end inside the unit cube; returns (t, cropped)."""
    cropped = False
    for bound in (0.0, 1.0):
        x = ui + t * v
        beyond = (x <= 0) if bound == 0.0 else (x >= 1)
        if beyond.any():
            tlimits = (bound - ui[beyond]) / v[beyond]
            t = (tlimits.max() if t < 0 else tlimits.min()) * (1 - epsilon)
            cropped = True
    return t, cropped


def crop_bracket_at_unit_cube(ui, v, left, right, epsilon=1e-6):
    """Truncate the segment ui + t*v, t in [left, right], to the unit cube.

    Returns (left, right, cropped_left, cropped_right).
    """
    assert ((ui > 0) & (ui < 1)).all(), ui
    left, cropped_left = _crop_end(ui, v, left, epsilon)
    right, cropped_right = _crop_end(ui, v, right, epsilon)
    assert left <= 0 <= right, (left, right)
    xl = ui + left * v
    xr = ui + right * v
    assert ((xl >= 0) & (xl <= 1)).all(), xl
    assert ((xr >= 0) & (xr <= 1)).all(), xr
    return left, right, cropped_left, cropped_right
