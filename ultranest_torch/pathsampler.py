# noqa: D400 D205
"""
Step samplers walking reflected trajectories
--------------------------------------------

Adapters exposing the clocked trajectory machines
(:mod:`ultranest_torch.flatnuts`) through the integrator's step-sampler
protocol (one likelihood evaluation per ``__next__`` call). Functional
equivalent of the reference's `ultranest/pathsampler.py`, redesigned:
each sampler here is an explicit three-phase machine (start a ray,
drive the clocked walk, finalize the jump) instead of an inheritance
web over the scalar MCMC base class.

A copy of ``ultranest_tpu/pathsampler.py``: numpy on the host; the
regions it walks in are the port's, built on the sampler's device.
"""

import numpy as np

from .flatnuts import ClockedBisectSampler, ClockedStepSampler, DirectJumper
from .samplingpath import ContourSamplingPath, SamplingPath

__all__ = ['SamplingPathSliceSampler', 'SamplingPathStepSampler',
           'OtherSamplerProxy']


def _random_path_direction(region, ui, scale, rng=np.random):
    """Draw a travel velocity: a unit whitened direction, region-scaled."""
    layer = region.transformLayer
    t = rng.normal(size=len(ui))
    t /= np.linalg.norm(t)
    axes = np.asarray(layer.axes)
    if axes.ndim == 1:
        axes = np.diag(axes)
    v = t @ axes
    return v * scale


class _TrajectoryStepSamplerBase:
    """Shared machinery: chain bookkeeping + the clocked driving loop."""

    # subclass hooks: _make_clocked(contourpath) and jump scheduling
    clocked_class = ClockedStepSampler

    def __init__(self, nsteps, nresets=2, scale=1.0, log=False):
        """Set up a sampler doing *nsteps*-step jumps per sample.

        *nresets* bounds how many fresh directions are tried when the
        trajectory dies early (both travel directions rejected).
        """
        self.nsteps = nsteps
        self.nresets = nresets
        self.scale = float(scale)
        self.log = log
        self.nrejects = 0
        self.ncalls = 0
        self.logstat = []
        self.logstat_labels = ['acceptance_rate', 'scale']
        self._clear_chain()

    def __str__(self):
        """Short description including the step count."""
        return '%s(nsteps=%d, nresets=%d)' % (
            type(self).__name__, self.nsteps, self.nresets)

    def _clear_chain(self):
        self._machine = None
        self._jumper = None
        self._resets_used = 0
        self._start = None

    def region_changed(self, Ls, region):
        """Region rebuilt: current trajectories remain valid; no-op."""
        pass

    def plot(self, filename=None):
        """Chain statistics plot stub (statistics are in ``logstat``)."""
        pass

    def get_info_dict(self):
        """Diagnostics for the live status display."""
        recent = self.logstat[-10:]
        return dict(
            num_logs=len(self.logstat),
            mean_acceptance_rate=float(np.mean([r[0] for r in recent]))
            if recent else np.nan,
            scale=self.scale,
        )

    def _begin_chain(self, region, Lmin, us, Ls, rng=np.random):
        i = rng.randint(len(us))
        ui, Li = us[i], Ls[i]
        v = _random_path_direction(region, ui, self.scale, rng)
        path = ContourSamplingPath(SamplingPath(ui, v, Li), region)
        self._machine = self.clocked_class(path)
        self._jumper = DirectJumper(self._machine, self.nsteps)
        self._jumper.prepare_jump()
        self._start = (ui, Li)
        self._chain_calls = 0
        self._chain_accepts = 0
        self._pending_L = None

    def _finish_chain(self, transform, loglike):
        unew, Lnew = self._jumper.make_jump()
        acc = self._chain_accepts / max(self._chain_calls, 1)
        self.logstat.append([acc, self.scale])
        # adapt the travel scale towards ~50% step acceptance
        if acc < 0.5:
            self.scale *= 0.98
        else:
            self.scale *= 1.02
        self._clear_chain()
        if Lnew is None:
            return None
        pnew = transform(unew.reshape((1, -1)))
        return unew, pnew[0], Lnew

    def __next__(self, region, Lmin, us, Ls, transform, loglike, ndraw=10,
                 plot=False, tregion=None, log=False):
        """One likelihood evaluation of the trajectory walk.

        Returns ``(None, None, None, nc)`` while the jump is under way
        and ``(u, p, L, nc)`` when a sample is ready.
        """
        if self._machine is None:
            self._begin_chain(region, Lmin, us, Ls)

        u, _ = self._machine.next(self._pending_L)
        self._pending_L = None
        if u is not None:
            u = np.clip(u, 1e-10, 1 - 1e-10)
            inside = np.logical_and(u > 0, u < 1).all()
            if inside:
                p = transform(u.reshape((1, -1)))
                L = float(loglike(p)[0])
                self.ncalls += 1
                self._chain_calls += 1
                if L > Lmin:
                    self._pending_L = L
                    self._chain_accepts += 1
                else:
                    self.nrejects += 1
            return None, None, None, 1 if inside else 0

        if not self._machine.is_done():
            return None, None, None, 0

        if self._machine.naccepted == 0 \
                and self._resets_used < self.nresets:
            # trajectory died immediately: try a fresh direction from
            # the same starting point
            self._resets_used += 1
            ui, Li = self._start
            v = _random_path_direction(region, ui, self.scale)
            path = ContourSamplingPath(SamplingPath(ui, v, Li), region)
            self._machine = self.clocked_class(path)
            self._jumper = DirectJumper(self._machine, self.nsteps)
            self._jumper.prepare_jump()
            return None, None, None, 0

        out = self._finish_chain(transform, loglike)
        if out is None:
            return None, None, None, 0
        u, p, L = out
        return u, p, L, 0


class SamplingPathStepSampler(_TrajectoryStepSamplerBase):
    """Reflected-ray walk with unit steps (flatnuts 'clocked' walk).

    Each jump advances ``nsteps`` path indices; rejected indices bounce
    off the estimated contour normal before giving up on a direction.
    """

    clocked_class = ClockedStepSampler


class SamplingPathSliceSampler(_TrajectoryStepSamplerBase):
    """Reflected-ray walk using bisection jumps (slice-like).

    Long jumps straight to the target index, with interval bisection
    locating the contour on rejection — fewer evaluations per jump on
    smooth contours than the unit-step walk.
    """

    clocked_class = ClockedBisectSampler

    def __init__(self, nsteps, nresets=2, scale=1.0, log=False):
        """See :class:`_TrajectoryStepSamplerBase`."""
        _TrajectoryStepSamplerBase.__init__(self, nsteps, nresets=nresets,
                                            scale=scale, log=log)


class OtherSamplerProxy:
    """Expose a clocked trajectory machine as a step sampler.

    Generic adapter: supply factories for the machine and the jumper
    and get an object satisfying the integrator's step-sampler
    protocol. The concrete samplers above are specializations; this
    proxy exists for experiments with custom clocked machines
    (e.g. :class:`ultranest_torch.flatnuts.ClockedNUTSSampler`).
    """

    def __init__(self, make_machine, make_jumper=None, nsteps=8,
                 scale=1.0):
        """Build from factories.

        Parameters
        ----------
        make_machine: function
            ``(contourpath) -> clocked sampler``
        make_jumper: function or None
            ``(machine, nsteps) -> jumper``; DirectJumper by default
        nsteps: int
            jump length
        scale: float
            initial travel scale
        """
        self.make_machine = make_machine
        self.make_jumper = make_jumper or \
            (lambda machine, nsteps: DirectJumper(machine, nsteps))
        self.nsteps = nsteps
        self.scale = float(scale)
        self.ncalls = 0
        self._inner = _TrajectoryStepSamplerBase(nsteps, scale=scale)
        self._inner.clocked_class = None

    def region_changed(self, Ls, region):
        """No-op; trajectories stay valid across rebuilds."""
        pass

    def __next__(self, region, Lmin, us, Ls, transform, loglike, ndraw=10,
                 plot=False, tregion=None, log=False):
        """Delegate to the inner driver with the custom factories."""
        inner = self._inner

        class _Custom:
            def __init__(custom_self, path):
                pass

        if inner._machine is None:
            i = np.random.randint(len(us))
            ui, Li = us[i], Ls[i]
            v = _random_path_direction(region, ui, self.scale)
            path = ContourSamplingPath(SamplingPath(ui, v, Li), region)
            inner._machine = self.make_machine(path)
            inner._jumper = self.make_jumper(inner._machine, self.nsteps)
            inner._jumper.prepare_jump()
            inner._start = (ui, Li)
            inner._chain_calls = 0
            inner._chain_accepts = 0
            inner._pending_L = None
        out = _TrajectoryStepSamplerBase.__next__(
            inner, region, Lmin, us, Ls, transform, loglike, ndraw=ndraw,
            tregion=tregion)
        self.ncalls = inner.ncalls
        return out
