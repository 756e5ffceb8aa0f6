# noqa: D400 D205
"""
Spans of a sampler's run
------------------------

Where the host's time goes in :meth:`ReactiveNestedSampler.run`: one
:class:`Spans` record a sampler (``sampler._segment_phase_s``), cleared
when a run starts. It is a flat dict, key -> seconds, with each key's
count under the key and ``#`` (``'fetch/wait#'``).

A span is a bracket, entered and left; a span entered inside another is
its child, and its key is the parent's key, ``/``, its own name
(``'rebuild/radius'``). The run's top-level spans follow one another
and cover its wall:

- ``prepare``: the first live points through the first region;
- ``classic``: each unbroken run of the per-point iterations (its region
  rebuilds are ``classic/rebuild``);
- ``launch``, ``fetch``, ``replay`` and ``rebuild``: the segment loop's
  dispatch (with ``segment_start``), waiting for and parsing a
  dispatch's records, replaying them into the tree, and the region
  rebuilds it makes;
- ``results`` (``results/combine``, ``results/replay``): the results
  of a pass, without writing the chain files;
- ``plan``: deciding on another pass, and the chains' check at the end;
- ``improve``: in a pass after the first (an improvement pass, which
  widens the tree where the reactive strategy asks for more live
  points), each unbroken run of the per-point iterations, in the place
  that ``classic`` has in the first pass (its region rebuilds are
  ``improve/rebuild``).

Inside them: ``*/wait``, the host blocked on the device
(:func:`ultranest_torch.parallel.launch.wait_ready`); ``fetch/parse``
and ``fetch/diagnose`` (the population walks' diagnostics);
``launch/capture``, CUDA graph captures; ``replay/chained``, a
dispatch whose rows replace one live point more than once, and
``replay/serial``, such a dispatch resolved row by row; and
``rebuild/layer``, ``rebuild/radius`` (the bootstrapped radius, kernel K2),
``rebuild/ellipsoid`` (with the new region's acceptance) and
``rebuild/tregion``, also under ``classic/rebuild``,
``prepare/rebuild`` and ``improve/rebuild``; inside ``layer``,
``graph`` where kernel K8 built the clusters and the local centring
(:func:`ultranest_torch.ops.cluster.radius_graphs`) and
``graph_host`` where the host path did;
``improve/draw``, each
batch of candidates that the per-point iterations of an improvement
pass ask of the fused region sampler (the dispatch, the wait, which is
``improve/draw/wait``, and the copy back; a first pass's batches keep
``classic/wait``); ``improve/walk``, each refill that they ask of a
step sampler instead (its ``__next__``: a population walk's launch, the
harvest with its float64 re-evaluation, and the wait, which is
``improve/walk/wait``), and inside it the counts of the walk's points
(no seconds, a count each): ``improve/walk/harvested``, the walkers that
finished above their dispatch's threshold, ``improve/walk/dropped``,
those thrown away below a later threshold (at the harvest or in the
per-point loop), ``improve/walk/taken``, those taken into the tree, and
``improve/walk/stale``, buffered ones thrown away because a new pass
started below the threshold they were drawn above (the population
walks' ``point_counts``); ``plan/strategy``, the reactive strategy's verdict
(``_find_strategy``), and ``plan/widen``, widening the tree for the
next pass (``_expand_nodes_before``, ``_widen_nodes`` with the search
for their parents, or ``_widen_roots_beyond_initial_plateau``).

The parts of a dispatch under ``launch``, each exclusive of the others
and of ``launch/wait`` and ``launch/capture``: on the population path
(:mod:`ultranest_torch.popfused`) ``load`` (the live set's upload at a
segment's start; a dispatch's region upload, the walk's set-up and the
copy of its inputs into the walk's buffers), ``banks`` (seeding and
drawing the walk's banks), ``rounds`` (the walk's rounds: the graph
replays or the host loop, and the flag reads) and ``tail`` (from the
walk's end through the records' ``start_fetch``); on the region path
(:mod:`ultranest_torch.fused`) ``load`` (the live set's upload),
``geometry`` (the region's geometry, the mask and the whitened live
points), ``draw`` (seeding and drawing the candidates), ``filter``
(``filter_stage``: membership, transform, likelihood) and ``tail``
(compaction, K3, the pack and ``start_fetch``). The parts of the
per-point iterations (``_explore_pass``), under ``classic``,
``improve`` or, before the first region, ``prepare``, exclusive of
their ``rebuild``, ``draw`` and ``wait``: ``advice`` (the reactive
strategy's advice), ``tree`` (the explorer's next node, the expansion
decision, the saved lists and the children's expansion), ``count``
(``passing_node``), ``point`` (``_create_point`` and the node),
``insert`` (the insertion test, the governor's feed, the swap into the
region and the child's append) and ``coords`` (the live points'
coordinates). Each part's count is the number of intervals it sums.

Three keys overlap the spans and are never summed
with them: ``segment``, one for each visit of the segment loop,
``gc``, Python's garbage collector, and ``passes``, booked once at the
end of a run that made improvement passes: the seconds from the start
of the second pass to the end of the last pass's ``plan`` (the segment
visits, per-point iterations, rebuilds, results and plans of the passes
after the first; a run of one pass books none).

Each span costs one clock read at each edge. While torch's profiler
records (checked once when a run starts), the spans ``prepare``,
``classic``, ``improve``, ``segment``, ``rebuild``, ``results`` and
``plan``, and their children ``*/rebuild``, ``results/combine`` and
``results/replay``, are also ``torch.profiler.record_function`` ranges
named by their keys, on the profiler's timeline beside the device's
work; and ``gc`` is counted from ``gc.callbacks``. The other spans are
counted only, so that a run makes about as many ranges as it rebuilds
its region: ``segment`` holds ``launch``, ``fetch``, ``replay`` and
``rebuild`` on the timeline, while their keys stay at the top level.

Code below the sampler (:mod:`ultranest_torch.parallel.launch`,
:mod:`ultranest_torch.fused`, :mod:`ultranest_torch.popfused`) books
into the run in progress with :func:`book` and :func:`count`, under
its innermost open span, and books consecutive parts of that span with
:func:`lap` where the sampler runs :meth:`Spans.laps`. No part is a
span: a part costs one clock read, and never changes the key of what is
booked inside it.
"""

import contextlib
import gc
import time

import torch

__all__ = ['Spans', 'book', 'count', 'lap']

# the record of the run in progress (Spans.running)
_current = None


class _Edge:
    """``with``: a span of a :class:`Spans` entered and left."""

    __slots__ = ('spans', 'name', 'ranged')

    def __init__(self, spans, name, ranged):
        self.spans, self.name, self.ranged = spans, name, ranged

    def __enter__(self):
        self.spans.open(self.name, self.ranged)

    def __exit__(self, *exc):
        self.spans.close()


class Spans(dict):
    """One run's spans and counters; see the module's description."""

    def __init__(self):
        super().__init__()
        # open spans: (key, children's key prefix, start, profiler range)
        self._open = []
        # seconds booked under each open span so far (inner_s)
        self._inner = []
        # inside laps(): the end of the last part, and inner_s then
        self._mark = None
        self.ranges = False       # whether spans are profiler ranges
        self._gc_t0 = None

    def reset(self):
        """Clear the record for a new run; ranges from here on where
        torch's profiler records now."""
        self.unwind()
        self.clear()
        self.ranges = torch.autograd._profiler_enabled()

    @property
    def innermost(self):
        """Key of the innermost open span, or None."""
        return self._open[-1][0] if self._open else None

    def _key(self, name):
        prefix = self._open[-1][1] if self._open else None
        return prefix + '/' + name if prefix else name

    def _range(self, key):
        if not self.ranges:
            return None
        rf = torch.profiler.record_function(key)
        rf.__enter__()
        return rf

    @property
    def inner_s(self):
        """Seconds booked so far under the innermost open span: its
        closed children and what :meth:`book` added there (0 where none
        is open)."""
        return self._inner[-1] if self._inner else 0.0

    def _add(self, key, seconds, n=1):
        self[key] = self.get(key, 0.0) + seconds
        self[key + '#'] = self.get(key + '#', 0) + n

    def _push(self, name, ranged, nests, now):
        key = self._key(name)
        prefix = key if nests else (self._open[-1][1] if self._open
                                    else None)
        rf = self._range(key) if ranged else None
        self._open.append((key, prefix, now, rf))
        self._inner.append(0.0)

    def _pop(self, now):
        key, _, t0, rf = self._open.pop()
        self._inner.pop()
        self._add(key, now - t0)
        if self._inner:
            self._inner[-1] += now - t0
        if rf is not None:
            rf.__exit__(None, None, None)

    def open(self, name, ranged=True, nests=True):
        """Enter span *name* inside the innermost open one; a profiler
        range too where *ranged* and the profiler records. Where not
        *nests*, the spans inside it take their keys as if it were not
        open (``segment``)."""
        self._push(name, ranged, nests, time.perf_counter())

    def close(self):
        """Leave the innermost open span."""
        self._pop(time.perf_counter())

    def switch(self, name, ranged=True):
        """Leave the innermost open span and enter its sibling *name*, at
        one clock read."""
        now = time.perf_counter()
        self._pop(now)
        self._push(name, ranged, True, now)

    def unwind(self, depth=0):
        """Leave open spans until *depth* remain."""
        while len(self._open) > depth:
            self.close()

    def span(self, name):
        """``with``: a span, a profiler range while the profiler records."""
        return _Edge(self, name, True)

    def count(self, name):
        """``with``: a span that is never a profiler range."""
        return _Edge(self, name, False)

    def book(self, name, seconds, n=1):
        """Add *seconds*, measured by the caller, and *n* to the count of
        *name* under the innermost open span."""
        self._add(self._key(name), seconds, n)
        if self._inner:
            self._inner[-1] += seconds

    @contextlib.contextmanager
    def laps(self):
        """``with``: consecutive parts of the innermost open span, each
        booked by :meth:`lap`, the first from here."""
        previous, self._mark = self._mark, (time.perf_counter(),
                                            self.inner_s)
        try:
            yield
        finally:
            self._mark = previous

    def lap(self, name):
        """Inside :meth:`laps`, book the seconds since the last part
        ended as part *name* of the innermost open span, less what was
        booked under that span meanwhile (its ``wait``, ``capture``);
        elsewhere nothing."""
        if self._mark is None:
            return
        now = time.perf_counter()
        t, inner = self._mark
        self.book(name, now - t - (self.inner_s - inner))
        self._mark = (now, self.inner_s)

    def _gc(self, phase, info):
        if phase == 'start':
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            self._add('gc', time.perf_counter() - self._gc_t0)
            self._gc_t0 = None

    @contextlib.contextmanager
    def running(self):
        """Make this the run in progress that :func:`book` and
        :func:`count` book into; while the profiler records, count the
        garbage collector too. Every span left open is left on exit."""
        global _current
        previous, _current = _current, self
        hook = self._gc if self.ranges else None
        if hook is not None:
            gc.callbacks.append(hook)
        try:
            yield self
        finally:
            self.unwind()
            if hook is not None:
                gc.callbacks.remove(hook)
                self._gc_t0 = None
            _current = previous


def book(name, seconds, n=1):
    """Book *seconds* and a count of *n* under *name* in the run in
    progress, if any."""
    rec = _current
    if rec is not None:
        rec.book(name, seconds, n)


def count(name):
    """``with``: a counted span *name* of the run in progress, if any."""
    rec = _current
    return rec.count(name) if rec is not None else contextlib.nullcontext()


def lap(name):
    """Book part *name* of the innermost open span in the run in
    progress, if any, inside its :meth:`Spans.laps`."""
    rec = _current
    if rec is not None:
        rec.lap(name)
