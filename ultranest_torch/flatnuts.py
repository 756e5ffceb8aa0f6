# noqa: D400 D205
"""
Clocked trajectory samplers with contour reflections
----------------------------------------------------

Constrained-likelihood samplers that travel on integer-indexed
reflected rays (:mod:`ultranest_torch.samplingpath`) and treat the
likelihood threshold as a mirror: rejected moves trigger a reflection
off the estimated contour normal, and only if the reflected move is
also rejected does the walk turn around. Functional equivalent of the
reference's `ultranest/flatnuts.py` family, redesigned as explicit
state machines.

The **clocked protocol** decouples the sampler from likelihood
evaluation so callers control batching::

    u, is_to_evaluate = sampler.next(Llast)   # Llast: result of the
                                              # previous u, or None if
                                              # it was below the
                                              # threshold / first call
    # caller evaluates L(u) when is_to_evaluate is falsy... see next()

Jumpers (:class:`SingleJumper`, :class:`DirectJumper`,
:class:`IntervalJumper`) schedule how many path steps make one MCMC
jump and extract the resulting point.

A copy of ``ultranest_tpu/flatnuts.py``: numpy on the host.
"""

import numpy as np

from .samplingpath import angle, reflect

__all__ = ['SingleJumper', 'DirectJumper', 'IntervalJumper',
           'ClockedSimpleStepSampler', 'ClockedStepSampler',
           'ClockedBisectSampler', 'ClockedNUTSSampler']


class ClockedSimpleStepSampler:
    """Base state machine walking an integer-indexed reflected path.

    Subclasses decide which index to evaluate next (:meth:`_plan`).
    The machine tracks, per direction, whether travel is still
    possible; a direction dies when both the direct and the reflected
    continuation are rejected.
    """

    def __init__(self, contourpath, plot=False, log=False):
        """Walk on *contourpath* (a ContourSamplingPath)."""
        self.contourpath = contourpath
        self.plot = plot
        self.log = log
        self.reset()

    def reset(self):
        """Forget all exploration state (keeps the path object)."""
        self.goal = 0
        self.reached = 0
        self.pending = None       # (index, x, v, stage)
        self.fwd_alive = True
        self.rwd_alive = True
        self.done = False
        self.naccepted = 0
        self.nrejected = 0

    def set_nsteps(self, i):
        """Declare the target step index of the current jump."""
        self.goal = int(i)
        self.done = self.goal == 0

    def is_done(self):
        """Whether the jump target was reached or travel is exhausted."""
        return self.done

    def expand_onestep(self, fwd=True):
        """Ask for one more step in the given direction (jumper hook)."""
        self.goal = self.reached + (1 if fwd else -1)
        self.done = False

    def _direction(self):
        return 1 if self.goal >= self.reached else -1

    def _alive(self, s):
        return self.fwd_alive if s > 0 else self.rwd_alive

    def _kill(self, s):
        if s > 0:
            self.fwd_alive = False
            self.contourpath.samplingpath.fwd_possible = False
        else:
            self.rwd_alive = False
            self.contourpath.samplingpath.rwd_possible = False

    def _turn_around(self, s):
        """Reverse the remaining travel budget onto the other side."""
        remaining = abs(self.goal - self.reached)
        self.goal = self.reached - s * remaining
        if not self._alive(-s):
            self.done = True

    def _accept(self, j, x, v, L):
        self.contourpath.add(j, x, v, L)
        self.reached = j
        self.naccepted += 1

    def _issue(self, j, x, v, stage):
        self.pending = (j, np.asarray(x, float), np.asarray(v, float),
                        stage)
        return x, False

    def _feed(self, Llast):
        """Process the evaluation result of the pending point.

        Returns an issued follow-up request ``(u, False)`` (e.g. the
        reflected retry of a rejected move) or None when the walk can
        re-plan normally.
        """
        j, x, v, stage = self.pending
        self.pending = None
        s = 1 if j > self.reached else -1
        if Llast is not None:
            self._accept(j, x, v, Llast)
            return None
        self.nrejected += 1
        if stage == 'direct':
            # blocked: bounce off the contour normal estimated at the
            # rejected position and retry the same index
            normal = self.contourpath.gradient(x)
            _, xc, vc, _ = self._point_at(self.reached)
            if normal is not None and vc is not None:
                vr = reflect(vc * s, normal) * s
                from .samplingpath import linear_steps_with_reflection
                xr, vrr = linear_steps_with_reflection(xc, vr * s, 1)
                return self._issue(self.reached + s, xr, vrr * s,
                                   'reflected')
        # reflected move also failed (or no normal): direction is dead
        self._kill(s)
        self._turn_around(s)
        return None

    def _point_at(self, i):
        for p in self.contourpath.points:
            if p[0] == i:
                return p
        x, v, L, _ = self.contourpath.interpolate(i)
        return (i, x, v, L)

    def next(self, Llast=None):
        """Advance the state machine.

        Returns ``(u, flag)``: when ``u`` is a position, the caller must
        evaluate the likelihood there and pass it back on the following
        call (or None if below the threshold). ``(None, True)`` signals
        the jump is complete.
        """
        if self.pending is not None:
            out = self._feed(Llast)
            if out is not None:
                return out
        if self.nrejected + self.naccepted > 50 * max(abs(self.goal), 8):
            # runaway walk (pathological contour): stop where we are
            self.done = True
        while not self.done:
            if self.reached == self.goal:
                self.done = True
                break
            s = self._direction()
            if not self._alive(s):
                self._turn_around(s)
                continue
            plan = self._plan(s)
            if plan is None:
                self.done = True
                break
            j = plan
            x, v, L, onpath = self.contourpath.interpolate(j)
            if L is not None:
                self.reached = j
                continue
            return self._issue(j, x, v, 'direct')
        return None, True

    def _plan(self, s):
        """Next index to secure (subclass policy)."""
        raise NotImplementedError()


class ClockedStepSampler(ClockedSimpleStepSampler):
    """Walks towards the goal one step at a time."""

    def _plan(self, s):
        return self.reached + s


class ClockedBisectSampler(ClockedStepSampler):
    """Jumps straight to the goal; bisects when the jump is rejected.

    The first rejection between the last accepted index and the goal
    starts an interval bisection to locate the contour crossing; the
    crossing point supplies the reflection surface.
    """

    def reset(self):
        """Also clear the bisection interval."""
        ClockedStepSampler.reset(self)
        self.bisect_hi = None

    def _plan(self, s):
        if self.bisect_hi is not None:
            gap = abs(self.bisect_hi - self.reached)
            if gap <= 1:
                self.bisect_hi = None
                return self.reached + s
            return self.reached + s * (gap // 2)
        return self.goal

    def _feed(self, Llast):
        j, x, v, stage = self.pending
        s = 1 if j > self.reached else -1
        if Llast is None and stage == 'direct' \
                and abs(j - self.reached) > 1:
            # long jump failed: remember the far rejected end and
            # bisect towards the crossing instead of reflecting here
            self.pending = None
            self.nrejected += 1
            self.bisect_hi = j
            return None
        return ClockedStepSampler._feed(self, Llast)


class ClockedNUTSSampler(ClockedBisectSampler):
    """No-U-Turn exploration of the reflected path.

    The explored interval doubles in a random direction until either a
    rejection clips that side or the path ends point back at each other
    (U-turn); the jump result is drawn uniformly from the accepted
    interior points (slice-uniform, as all accepted points satisfy the
    likelihood constraint).
    """

    def reset(self):
        """Also reset the doubling state."""
        ClockedBisectSampler.reset(self)
        self.epoch = 0
        self.max_epochs = 10
        self.rng = np.random

    def next_epoch(self):
        """Pick the next doubling target from the explored interval."""
        lo = min(p[0] for p in self.contourpath.points)
        hi = max(p[0] for p in self.contourpath.points)
        width = max(hi - lo, 1)
        if self.rng.uniform() < 0.5:
            self.goal = hi + width
        else:
            self.goal = lo - width
        self.epoch += 1
        self.done = False

    def _uturn(self):
        pts = self.contourpath.points
        _, xlo, vlo, _ = pts[0]
        _, xhi, vhi, _ = pts[-1]
        span = xhi - xlo
        return angle(span, vlo) < 0 or angle(span, vhi) < 0

    def next(self, Llast=None):
        """Advance; epochs keep doubling until U-turn or both ends die."""
        u, flag = ClockedSimpleStepSampler.next(self, Llast)
        if u is not None:
            return u, flag
        # epoch finished
        if (self.fwd_alive or self.rwd_alive) \
                and self.epoch < self.max_epochs and not self._uturn():
            self.next_epoch()
            return ClockedSimpleStepSampler.next(self, None)
        self.done = True
        return None, True


class SingleJumper:
    """Jump scheduler: one path step per MCMC step, *nsteps* times."""

    def __init__(self, stepsampler, nsteps=0):
        """Schedule *nsteps* single steps on *stepsampler*."""
        self.stepsampler = stepsampler
        self.nsteps = nsteps
        self.isteps = 0
        self.currenti = 0

    def prepare_jump(self):
        """Begin the first step."""
        self.stepsampler.expand_onestep(fwd=True)

    def check_gaps(self, gaps):
        """Compatibility hook (gap bookkeeping is automatic here)."""
        pass

    def make_jump(self, gaps={}):
        """Run remaining steps eagerly; return the end point ``(x, L)``."""
        sampler = self.stepsampler
        while self.isteps < self.nsteps:
            if sampler.is_done():
                self.isteps += 1
                self.currenti = sampler.reached
                if self.isteps < self.nsteps:
                    sampler.expand_onestep(fwd=True)
            else:
                break
        p = sampler._point_at(sampler.reached)
        return p[1], p[3]


class DirectJumper:
    """Jump scheduler: one straight target of *nsteps* path steps."""

    def __init__(self, stepsampler, nsteps, log=False):
        """Schedule a jump of *nsteps* steps on *stepsampler*."""
        self.stepsampler = stepsampler
        self.nsteps = nsteps
        self.log = log

    def prepare_jump(self):
        """Set the jump target."""
        self.stepsampler.set_nsteps(self.nsteps)

    def check_gaps(self, gaps):
        """Compatibility hook."""
        pass

    def make_jump(self, gaps={}):
        """Return the reached end point ``(x, L)``."""
        sampler = self.stepsampler
        i = sampler.reached
        p = sampler._point_at(i)
        if p[3] is None:
            # walk back to the nearest evaluated point
            evaluated = [q for q in sampler.contourpath.points
                         if q[3] is not None]
            p = min(evaluated, key=lambda q: abs(q[0] - i))
        return p[1], p[3]


class IntervalJumper:
    """Jump scheduler: explore both directions, pick uniformly."""

    def __init__(self, stepsampler, nsteps):
        """Explore ``[-nsteps, +nsteps]`` on *stepsampler*."""
        self.stepsampler = stepsampler
        self.nsteps = nsteps

    def prepare_jump(self):
        """Set the forward half-target; backward runs on turn-around."""
        self.stepsampler.set_nsteps(self.nsteps)

    def check_gaps(self, gaps):
        """Compatibility hook."""
        pass

    def make_jump(self, gaps={}):
        """Draw uniformly among accepted non-start points ``(x, L)``."""
        pts = [p for p in self.stepsampler.contourpath.points
               if p[3] is not None and p[0] != 0]
        if not pts:
            pts = [self.stepsampler.contourpath.points[0]]
        p = pts[np.random.randint(len(pts))]
        return p[1], p[3]
