# noqa: D400 D205
"""
Vectorized population step samplers
-----------------------------------

Carried over unchanged from ``ultranest_tpu/popstepsampler.py`` (host
numpy). Whole populations of walkers advance with one batched
likelihood call per step. The per-walker state machines live in
:mod:`ultranest_torch.ops.stepfuncs`, and the device-resident engine in
:mod:`ultranest_torch.popfused`, which also takes its jump-distance
diagnostics from here.
"""

import numpy as np
import scipy.stats

from .ops.stepfuncs import (evolve, generate_cube_oriented_direction,
                            generate_cube_oriented_direction_scaled,
                            generate_differential_direction,
                            generate_mixture_random_direction,
                            generate_random_direction,
                            generate_region_oriented_direction,
                            generate_region_random_direction, int_dtype,
                            step_back, update_vectorised_slice_sampler)
from .utils import submasks

__all__ = [
    'generate_cube_oriented_direction',
    'generate_cube_oriented_direction_scaled',
    'generate_random_direction', 'generate_region_oriented_direction',
    'generate_region_random_direction', 'generate_differential_direction',
    'generate_mixture_random_direction',
    'PopulationRandomWalkSampler', 'PopulationSliceSampler',
    'PopulationSimpleSliceSampler', 'unitcube_line_intersection',
    'diagnose_move_distances', 'slice_limit_to_unitcube',
    'slice_limit_to_scale',
]


def unitcube_line_intersection(ray_origin, ray_direction):
    r"""Intersections of rays with the unit cube.

    Returns (tleft, tright): negative and positive line coordinates where
    each ray ``origin + t * direction`` crosses the cube boundary.
    """
    assert ((ray_origin >= 0) & (ray_origin <= 1)).all(), ray_origin
    norms = np.linalg.norm(ray_direction, axis=1)
    assert (norms > 1e-200).all(), ray_direction
    with np.errstate(divide='ignore', invalid='ignore'):
        t_at_zero = (0.0 - ray_origin) / ray_direction
        t_at_one = (1.0 - ray_origin) / ray_direction
    lo = np.fmin(t_at_zero, t_at_one)
    hi = np.fmax(t_at_zero, t_at_one)
    return np.nanmax(lo, axis=1), np.nanmin(hi, axis=1)


def reference_sqdistance(region):
    """Squared decorrelation scale of *region* in whitened space.

    The MLFriends bootstrapped radius where available (reference
    popstepsampler.py:64-95). Ellipsoid-only regions
    (RobustEllipsoidRegion/SimpleRegion) carry no meaningful radius
    (``maxradiussq`` is a 1e300 sentinel, making every jump "too
    short"); for those the live-point cloud radius — the whitened
    per-axis variance sum, i.e. half the mean squared pair distance —
    is used instead: a chain has decorrelated when its end point is
    about one cloud radius from its start, which a fresh independent
    draw achieves with probability >~60% in any dimension.
    """
    r2, _ = reference_sqdistance_info(region)
    return r2


def reference_sqdistance_info(region):
    """(squared decorrelation scale, used-the-cloud-variance flag).

    The flag tells the nsteps governor which criterion applies: the
    MLFriends ball radius carries the reference's own "jumped beyond
    one ball" semantics, while the cloud-variance fallback admits a
    sharper, dimension-aware decorrelation test
    (:func:`decorrelation_gm_target`).
    """
    r2 = region.maxradiussq
    if r2 is not None and r2 < 1e50:
        return float(r2), False
    return float(np.var(region.unormed, axis=0).sum()), True


def decorrelation_gm_target(ndim):
    r"""Geometric-mean relative jump of a *decorrelated* chain endpoint.

    When the reference scale is the live-point cloud variance
    (``ref2 = sum_k var_k``), an endpoint drawn independently of its
    start has ``E[d2] = 2 ref2``, and ``d2/ref2 ~ (2/ndim) chi2(ndim)``
    for a roughly gaussian whitened cloud. Its geometric mean is
    ``2 exp(psi(ndim/2) - log(ndim/2))`` (Jensen gap of the log),
    so the GM relative jump of well-mixed chains concentrates at::

        sqrt(2) * exp(0.5 * (psi(ndim/2) - log(ndim/2)))

    ~1.41 in high dimension, ~1.06 at ndim=2. A chain whose GM sits
    below this still carries start-to-end correlation
    ``rho ~ 1 - gm^2/2`` — measured on the 100-d sigma=0.01 gaussian
    with the device cloud normalizer, gm 1.31 (rho~0.14) still biases
    logZ by +2.8 while the far-enough fraction is already saturated at
    1.0 (evaluate/governor_signal_study.py,
    evaluate/records/governor_signal_r5_2026-08-19.json).
    """
    from scipy.special import digamma
    h = ndim / 2.0
    return float(np.sqrt(2.0) * np.exp(0.5 * (digamma(h) - np.log(h))))


def diagnose_move_distances(region, ustart, ufinal):
    """Compare walker travel distances to the region decorrelation scale.

    Returns (far_enough, [move_distance, reference_distance]) in whitened
    space; the reference distance is :func:`reference_sqdistance`.
    """
    assert ustart.shape == ufinal.shape, (ustart.shape, ufinal.shape)
    delta = region.transformLayer.transform(ufinal) \
        - region.transformLayer.transform(ustart)
    d2 = np.einsum('ij,ij->i', delta, delta)
    ref2 = reference_sqdistance(region)
    return d2 > ref2, [np.sqrt(d2), ref2 ** 0.5]


def _relative_jump_stats(region, ustart, ufinal):
    """(far_enough fraction, geometric mean relative jump)."""
    if len(ustart) == 0:
        return 0.0, 0.0
    far_enough, (dist, ref) = diagnose_move_distances(region, ustart,
                                                      ufinal)
    return float(np.mean(far_enough)), \
        float(np.exp(np.mean(np.log(dist / ref + 1e-10))))


class GenericPopulationSampler:
    """Shared diagnostics for population samplers."""

    def _stat_column(self, i):
        return np.asarray([row[i] for row in self.logstat], float)

    def plot(self, filename):
        """Plot sampler statistics to *filename* (+ data to .txt.gz)."""
        if not self.logstat:
            return
        import matplotlib.pyplot as plt
        nlabels = len(self.logstat_labels)
        plt.figure(figsize=(10, 1 + 3 * nlabels))
        for i, label in enumerate(self.logstat_labels):
            series = self._stat_column(i)
            plt.subplot(nlabels, 1, 1 + i)
            plt.ylabel(label)
            plt.plot(series)
            nfull = (len(series) // 20) * 20
            if nfull:
                trend = series[:nfull].reshape((-1, 20)).mean(axis=1)
                plt.plot(np.arange(len(trend)) * 20, trend)
            if np.nanmin(series) > 0:
                plt.yscale('log')
        plt.savefig(filename, bbox_inches='tight')
        np.savetxt(filename + '.txt.gz', self.logstat,
                   header=','.join(self.logstat_labels), delimiter=',')
        plt.close()

    @property
    def mean_jump_distance(self):
        """Geometric mean relative jump distance (acceptance weighted)."""
        if not self.logstat:
            return np.nan
        jumps = np.log(self._stat_column(-1) + 1e-10)
        return np.exp(np.average(jumps, weights=self._stat_column(0)))

    @property
    def far_enough_fraction(self):
        """Fraction of jumps exceeding the reference distance."""
        if not self.logstat:
            return np.nan
        return np.average(self._stat_column(-2),
                          weights=self._stat_column(0))

    def _labeled_column(self, *names):
        """Column by logstat label, trying *names* in order (NaN if absent)."""
        for name in names:
            if name in self.logstat_labels:
                return self._stat_column(self.logstat_labels.index(name))
        return np.asarray([np.nan])

    def get_info_dict(self):
        """Return performance diagnostics (rates, scales, jump distances)."""
        have = bool(self.logstat)
        last = dict(zip(self.logstat_labels, self.logstat[-1])) \
            if len(self.logstat) > 1 else \
            dict.fromkeys(self.logstat_labels, np.nan)
        return dict(
            num_logs=len(self.logstat),
            rejection_rate=1 - np.nanmean(self._stat_column(0))
            if have else np.nan,
            mean_scale=np.nanmean(self._labeled_column('scale'))
            if have else np.nan,
            mean_nsteps=np.nanmean(self._labeled_column('nsteps', 'steps'))
            if have else np.nan,
            mean_distance=self.mean_jump_distance,
            frac_far_enough=self.far_enough_fraction,
            last_logstat=last,
        )

    def print_diagnostic(self):
        """Print the jump-distance diagnostic with advice."""
        if not self.logstat:
            print("diagnostic unavailable, no recorded steps found")
            return
        frac = self.far_enough_fraction
        if frac >= 0.66:
            advice = ' (should be >50%)'
        elif frac >= 0.5:
            advice = ': fishy. Double nsteps and see if fraction and lnZ change)'
        else:
            advice = (': very fishy. Double nsteps and see if fraction and '
                      'lnZ change)')
        print('step sampler diagnostic: jump distance %.2f (should be >1), '
              'far enough fraction: %.2f%% %s'
              % (self.mean_jump_distance, frac * 100, advice))

    def plot_jump_diagnostic_histogram(self, filename, **kwargs):
        """Plot the relative jump distance histogram to *filename*."""
        if not self.logstat:
            return
        import matplotlib.pyplot as plt
        plt.hist(np.log10(self._stat_column(-1) + 1e-10), **kwargs)
        ylo, yhi = plt.ylim()
        plt.vlines(self.mean_jump_distance, ylo, yhi)
        plt.ylim(ylo, yhi)
        plt.ylabel('Frequency')
        plt.xlabel('log(relative step distance)')
        plt.savefig(filename, bbox_inches='tight')
        plt.close()

    def region_changed(self, Ls, region):
        """React to a region rebuild (no-op by default)."""
        pass


class PopulationRandomWalkSampler(GenericPopulationSampler):
    """Vectorized gaussian random walk over a walker population.

    All walkers advance together; one batched likelihood call per step.
    The proposal scale adapts towards the optimal 23.4% acceptance rate.
    """

    # Gelman-Roberts optimal acceptance rate for random walks
    TARGET_ACCEPTANCE = 0.234

    def __init__(self, popsize, nsteps, generate_direction, scale,
                 scale_adapt_factor=0.9, scale_min=1e-20, scale_max=20,
                 log=False, logfile=None):
        """Initialise.

        Parameters
        ----------
        popsize: int
            number of walkers (should be fairly large, ~100)
        nsteps: int
            steps per walker until a point counts as independent
        generate_direction: function
            batched proposal kernel shape (see
            :mod:`ultranest_torch.ops.stepfuncs` generators)
        scale: float
            initial proposal scale
        scale_adapt_factor: float
            adaptation strength (1 disables; <1 adapts towards 23.4%)
        scale_min, scale_max: float
            adaptation bounds
        log, logfile:
            diagnostics output
        """
        assert scale_adapt_factor <= 1
        self.popsize = popsize
        self.nsteps = nsteps
        self.generate_direction = generate_direction
        self.scale = scale
        self.scale_adapt_factor = scale_adapt_factor
        self.scale_min = scale_min
        self.scale_max = scale_max
        self.log = log
        self.logfile = logfile
        self.ncalls = 0
        self.nrejects = 0
        self.prepared_samples = []
        self.logstat = []
        self.logstat_labels = ['accept_rate', 'efficiency', 'scale',
                               'far_enough', 'mean_rel_jump']

    def __str__(self):
        """Return string representation."""
        return 'PopulationRandomWalkSampler(popsize=%d, nsteps=%d, ' \
            'generate_direction=%s, scale=%.g)' % (
                self.popsize, self.nsteps, self.generate_direction,
                self.scale)

    def _walk_population(self, allu, allL, region, Lmin, transform, loglike):
        """Advance all walkers nsteps times; returns (u, p, L, last_mask)."""
        allp = None
        mask_accept = np.zeros(len(allu), bool)
        for _ in range(self.nsteps):
            v = self.generate_direction(allu, region, self.scale)
            # truncated-normal step length inside the cube along v
            lo, hi = unitcube_line_intersection(allu, v)
            amp = scipy.stats.truncnorm.rvs(lo, hi, loc=0, scale=1)
            candidate_u = allu + v * amp[:, None]
            assert np.logical_and(candidate_u > 0,
                                  candidate_u < 1).all(), candidate_u
            candidate_p = transform(candidate_u)
            candidate_L = loglike(candidate_p)
            mask_accept = candidate_L > Lmin
            self.nrejects += int((~mask_accept).sum())
            if allp is None:
                allp = np.full_like(candidate_p, np.nan)
            allu[mask_accept] = candidate_u[mask_accept]
            allp[mask_accept] = candidate_p[mask_accept]
            allL[mask_accept] = candidate_L[mask_accept]
        return allu, allp, allL, mask_accept

    def __next__(self, region, Lmin, us, Ls, transform, loglike, ndraw=10,
                 plot=False, tregion=None, log=False):
        """Return the next prepared sample (u, p, L, nc).

        Refills by advancing a fresh population of walkers nsteps times
        (one batched likelihood call each) when the buffer is empty.
        """
        nc = 0
        if not self.prepared_samples:
            nbatch = self.nsteps * self.popsize
            nc = nbatch
            rejects_before = self.nrejects
            start = np.random.randint(0, len(us), size=self.popsize)
            allu, allp, allL, last_accept = self._walk_population(
                us[start].copy(), Ls[start].copy(), region, Lmin,
                transform, loglike)
            assert np.isfinite(allp).all(), (
                'some walkers never moved! Double nsteps of '
                'PopulationRandomWalkSampler.')
            rejects_here = self.nrejects - rejects_before
            frac_far, rel_jump = _relative_jump_stats(
                region, us[start[last_accept]], allu[last_accept])
            self.prepared_samples = list(zip(allu, allp, allL))
            self.logstat.append([
                last_accept.mean(),
                1 - rejects_here / nbatch,
                self.scale, self.nsteps, frac_far, rel_jump])
            if self.logfile:
                self.logfile.write("rescale\t%.4f\t%.4f\t%g\t%.4f%g\n"
                                   % tuple(self.logstat[-1][:5]))
            # nudge the scale towards the target acceptance rate
            rejects_wanted = nbatch * (1 - self.TARGET_ACCEPTANCE)
            if rejects_here > rejects_wanted:
                if self.scale > self.scale_min:
                    self.scale *= self.scale_adapt_factor
            elif self.scale < self.scale_max:
                self.scale /= self.scale_adapt_factor

        u, p, L = self.prepared_samples.pop(0)
        return u, p, L, nc


class PopulationSliceSampler(GenericPopulationSampler):
    """Vectorized slice/hit-and-run sampler with per-walker generations.

    Walkers at different chain depths advance together; completed chains
    are harvested through a ring buffer, and chains revert when the
    threshold overtakes earlier steps.
    """

    def __init__(self, popsize, nsteps, generate_direction, scale=1.0,
                 scale_adapt_factor=0.9, log=False, logfile=None):
        """Initialise.

        Parameters
        ----------
        popsize: int
            number of walkers
        nsteps: int
            steps per walker until a point counts as independent
        generate_direction: function
            batched slice direction generator ``(u, region, scale) -> v``
        scale: float
            initial slice length guess
        scale_adapt_factor: float
            smoothing for the slice length guess (near 1: slow updates)
        log, logfile:
            diagnostics output
        """
        self.popsize = popsize
        self.nsteps = nsteps
        self.generate_direction = generate_direction
        self.scale = scale
        self.scale_adapt_factor = scale_adapt_factor
        self.log = log
        self.logfile = logfile
        self.nrejects = 0
        self.ringindex = 0
        self.allu = []
        self.allL = []
        self.currentp = []
        self.logstat = []
        self.logstat_labels = ['accept_rate', 'efficiency', 'scale',
                               'far_enough', 'mean_rel_jump']

    def __str__(self):
        """Return string representation."""
        return 'PopulationSliceSampler(popsize=%d, nsteps=%d, ' \
            'generate_direction=%s, scale=%.g)' % (
                self.popsize, self.nsteps, self.generate_direction,
                self.scale)

    def region_changed(self, Ls, region):
        """React to a region rebuild (diagnostics only)."""
        if self.logfile:
            self.logfile.write("region-update\t%g\t%g\n" % (
                self.scale, region.u.std(axis=1).mean()))

    def _setup(self, ndim):
        P = self.popsize
        self.allu = np.full((P, self.nsteps + 1, ndim), np.nan)
        self.allL = np.full((P, self.nsteps + 1), np.nan)
        self.currentt = np.full(P, np.nan)
        self.currentv = np.full((P, ndim), np.nan)
        self.generation = np.full(P, -1, dtype=int_dtype)
        self.current_left = np.zeros(P)
        self.current_right = np.zeros(P)
        self.searching_left = np.zeros(P, dtype=bool)
        self.searching_right = np.zeros(P, dtype=bool)

    def setup_start(self, us, Ls, starting):
        """Start the walkers marked in *starting* from random live points."""
        if self.log:
            print("setting up:", starting)
        picks = np.random.randint(len(us), size=starting.sum())
        if not starting.all():
            # never leave the harvest pointer waiting on a fresh walker
            while starting[self.ringindex]:
                self.shift()
        self.allu[starting, 0] = us[picks]
        self.allL[starting, 0] = Ls[picks]
        self.generation[starting] = 0

    @property
    def status(self):
        """Compact string representation of the walker states."""
        gens = ''.join('%d' % g if g >= 0 else '_'
                       for g in self.generation)
        phases = ''.join(
            'S' if not np.isfinite(self.currentt[i])
            else 'L' if self.searching_left[i]
            else 'R' if self.searching_right[i] else 'B'
            for i in range(self.popsize))
        return 'G:%s  S:%s' % (gens, phases)

    def setup_brackets(self, mask_starting, region):
        """Pick fresh slice directions and brackets for *mask_starting*."""
        if self.log:
            print("starting brackets:", mask_starting)
        idx = np.flatnonzero(mask_starting)
        self.currentt[idx] = 0
        self.current_left[idx] = -self.scale
        self.current_right[idx] = self.scale
        self.searching_left[idx] = True
        self.searching_right[idx] = True
        self.currentv[idx, :] = self.generate_direction(
            self.allu[idx, self.generation[idx]], region)

    def _walker_state(self, movable):
        """The evolve() argument vector for the movable walkers."""
        if movable.all():
            rows = np.arange(self.popsize)
            return [self.allu[rows, self.generation],
                    self.allL[rows, self.generation],
                    self.currentt, self.currentv,
                    self.current_left, self.current_right,
                    self.searching_left, self.searching_right]
        gen = self.generation[movable]
        return [self.allu[movable, gen], self.allL[movable, gen],
                self.currentt[movable], self.currentv[movable],
                self.current_left[movable], self.current_right[movable],
                self.searching_left[movable], self.searching_right[movable]]

    def _scatter_state(self, movable, state):
        (self.currentt[movable], self.currentv[movable],
         self.current_left[movable], self.current_right[movable],
         self.searching_left[movable],
         self.searching_right[movable]) = state

    def advance(self, transform, loglike, Lmin, region):
        """Advance the population by one batched likelihood call."""
        movable = self.generation < self.nsteps
        if self.log:
            print("evolve will advance:", movable)
        args = self._walker_state(movable)
        ustart = args[0].copy()
        state, (success, unew, pnew, Lnew), nc = evolve(
            transform, loglike, Lmin, *args)

        if success.any():
            frac_far, rel_jump = _relative_jump_stats(
                region, ustart[success, :], unew)
            self.logstat.append([success.mean(), self.scale, self.nsteps,
                                 frac_far, rel_jump])
            if self.logfile:
                self.logfile.write("rescale\t%.4f\t%.4f\t%g\t%.4f%g\n"
                                   % tuple(self.logstat[-1]))

        moved = submasks(movable, success)
        if self.log:
            print("evolve moved:", moved)
        self.generation[moved] += 1
        if len(pnew):
            if len(self.currentp) == 0:
                self.currentp = np.full((self.popsize, pnew.shape[1]),
                                        np.nan)
            self.currentp[moved, :] = pnew
        self.allu[moved, self.generation[moved]] = unew
        self.allL[moved, self.generation[moved]] = Lnew
        if not movable.all():
            self._scatter_state(movable, state)
        else:
            self._scatter_state(slice(None), state)
        return nc

    def shift(self):
        """Advance the harvest ring buffer pointer."""
        self.ringindex = (self.ringindex + 1) % self.popsize

    def _harvest_ready(self):
        """Pop the ring walker's completed chain, or None."""
        i = self.ringindex
        if self.generation[i] != self.nsteps:
            return None
        u = self.allu[i, self.nsteps, :].copy()
        p = self.currentp[i, :].copy()
        L = self.allL[i, self.nsteps].copy()
        assert np.isfinite(u).all() and np.isfinite(p).all(), (u, p)
        # recycle the slot
        self.generation[i] = -1
        self.currentt[i] = np.nan
        self.allu[i] = np.nan
        self.allL[i] = np.nan
        # smooth the slice length guess with this walker's last bracket
        bracket = (self.current_right[i] - self.current_left[i]) / 2
        self.scale += 0.1 * (bracket - self.scale)
        self.shift()
        return u, p, L

    def __next__(self, region, Lmin, us, Ls, transform, loglike, ndraw=10,
                 plot=False, tregion=None, log=False):
        """Return the next completed chain point (u, p, L, nc) or Nones."""
        if len(self.allu) == 0:
            self._setup(us.shape[1])

        # revert steps invalidated by the raised threshold
        step_back(Lmin, self.allL, self.generation, self.currentt)

        fresh = self.generation < 0
        if fresh.any():
            alive = Ls > Lmin
            self.setup_start(us[alive], Ls[alive], fresh)
        assert (self.generation >= 0).all(), self.generation

        bracketless = ~np.isfinite(self.currentt)
        if bracketless.any():
            self.setup_brackets(bracketless, region)

        if self.log:
            print(str(self), "(before)")
        nc = self.advance(transform, loglike, Lmin, region)
        if self.log:
            print(str(self), "(after)")

        ready = self._harvest_ready()
        if ready is None:
            return None, None, None, nc
        u, p, L = ready
        return u, p, L, nc


def slice_limit_to_unitcube(tleft, tright):
    """Initial slice limits: the intersection with the unit cube."""
    return tleft.copy(), tright.copy()


def slice_limit_to_scale(tleft, tright):
    """Initial slice limits: -1..+1, or the cube intersection if shorter."""
    return np.fmax(tleft, -1.0), np.fmin(tright, 1.0)


class PopulationSimpleSliceSampler(GenericPopulationSampler):
    """Vectorized shrink-only slice sampler (no stepping out).

    Every batched likelihood call evaluates exactly *popsize* points:
    finished chains lend their worker slots to still-running ones. With
    ``scale=None`` semantics (slice_limit_to_unitcube) detailed balance is
    preserved; a restricted scale trades rigor for speed.
    """

    def __init__(self, popsize, nsteps, generate_direction,
                 scale_adapt_factor=1.0, adapt_slice_scale_target=2.0,
                 scale=1.0, scale_jitter_func=None,
                 slice_limit=slice_limit_to_unitcube, max_it=100,
                 shrink_factor=1.0):
        """Initialise.

        Parameters
        ----------
        popsize: int
            number of walkers
        nsteps: int
            steps per walker until a point counts as independent
        generate_direction: function
            batched slice direction generator
        scale: float
            initial slice width
        scale_jitter_func: function or None
            multiplies the scale by a random factor per step
        scale_adapt_factor: float
            scale adaptation (1 disables)
        adapt_slice_scale_target: float
            target ratio of final slice width to scale
        slice_limit: function
            initial slice bounds: :func:`slice_limit_to_unitcube`
            (default, rigorous) or :func:`slice_limit_to_scale`
        max_it: int
            maximum shrink iterations per step
        shrink_factor: float
            >1 accelerates shrinking beyond the rejected point
        """
        assert shrink_factor >= 1.0, \
            "The shrink factor should be greater than 1.0 to be efficient"
        self.popsize = popsize
        self.nsteps = nsteps
        self.generate_direction = generate_direction
        self.scale = float(scale)
        self.scale_adapt_factor = scale_adapt_factor
        self.adapt_slice_scale_target = adapt_slice_scale_target
        self.scale_jitter_func = scale_jitter_func or (lambda: 1.0)
        self.slice_limit = slice_limit
        self.max_it = max_it
        self.shrink_factor = shrink_factor
        self.ncalls = 0
        self.nrejects = 0
        self.discarded = 0
        self.prepared_samples = []
        self.logstat = []
        self.logstat_labels = ['accept_rate', 'efficiency', 'scale',
                               'far_enough', 'mean_rel_jump']

    def __str__(self):
        """Return string representation."""
        return 'PopulationSimpleSliceSampler(popsize=%d, nsteps=%d, ' \
            'generate_direction=%s, scale=%.g)' % (
                self.popsize, self.nsteps, self.generate_direction,
                self.scale)

    def _one_slice_step(self, allu, allL, allp, region, Lmin, transform,
                        loglike):
        """One shrink-only slice step for the whole population.

        Returns (ncalls, ndiscarded, final_interval_median); the walker
        arrays are updated in place by the vectorized state machine.
        """
        v = self.generate_direction(allu, region, scale=1.0) \
            * (self.scale * self.scale_jitter_func())
        cube_lo, cube_hi = unitcube_line_intersection(allu, v)
        tleft, tright = self.slice_limit(cube_lo, cube_hi)
        worker_lo, worker_hi = self.slice_limit(cube_lo, cube_hi)
        workers = np.arange(self.popsize, dtype=int_dtype)
        status = np.zeros(self.popsize, dtype=int_dtype)
        nc = 0
        ndiscarded = 0
        for _ in range(self.max_it):
            draw = np.random.uniform(size=self.popsize)
            t = worker_lo + (worker_hi - worker_lo) * draw
            candidate_u = allu[workers, :] + t[:, None] * v[workers, :]
            candidate_p = transform(candidate_u)
            candidate_L = loglike(candidate_p)
            nc += self.popsize
            (tleft, tright, workers, status, allu, allL, allp,
             discarded_now) = update_vectorised_slice_sampler(
                t, tleft, tright, candidate_L, candidate_u, candidate_p,
                workers, status, Lmin, self.shrink_factor,
                allu, allL, allp, self.popsize)
            ndiscarded += discarded_now
            worker_lo = tleft[workers]
            worker_hi = tright[workers]
            if (status != 0).all():
                break
        return nc, ndiscarded, float(np.median(tright - tleft))

    def __next__(self, region, Lmin, us, Ls, transform, loglike, ndraw=10,
                 plot=False, tregion=None, log=False, test=False):
        """Return the next prepared sample (u, p, L, nc)."""
        nc = 0
        if not self.prepared_samples:
            nlive, ndim = us.shape
            start = np.random.randint(0, nlive, size=self.popsize)
            allu = np.array(us if test else us[start, :])
            allL = np.array(Ls[start])
            allp = np.full((self.popsize, ndim), np.nan)
            interval_total = 0.0
            ndiscarded = 0
            for _ in range(self.nsteps):
                dnc, dnd, interval = self._one_slice_step(
                    allu, allL, allp, region, Lmin, transform, loglike)
                nc += dnc
                ndiscarded += dnd
                interval_total += interval
            self.ncalls += nc
            self.discarded += ndiscarded
            assert np.isfinite(allp).all(), (
                'some walkers never moved! Double nsteps of '
                'PopulationSimpleSliceSampler.')
            frac_far, rel_jump = _relative_jump_stats(
                region, us[start, :], allu)
            self.prepared_samples = list(zip(allu, allp, allL))
            self.logstat.append([self.popsize / nc, self.scale, self.nsteps,
                                 frac_far, rel_jump])
            # adapt the scale towards final interval ~ scale/target
            if interval_total / self.nsteps \
                    >= 1.0 / self.adapt_slice_scale_target:
                self.scale /= self.scale_adapt_factor
            else:
                self.scale *= self.scale_adapt_factor

        u, p, L = self.prepared_samples.pop(0)
        return u, p, L, nc
