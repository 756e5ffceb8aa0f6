"""The spans of a run (``ultranest_torch.tracing``), on the CPU: a small
eggbox fit on the segment path and a small spec-walk fit. The record
keeps the segment loop's five phases, nests every span in its parent,
covers ``run()``'s wall, and becomes ``torch.profiler`` ranges named by
its keys only while the profiler records. The parts of a dispatch and
of the per-point iterations (an eggbox fit with one improvement pass)
sum to their span, and booking them changes no fit. A spec-walk fit
under upstream's run() defaults books the walk of its improvement
passes, what became of the walk's points and the passes' clock; a run
of one pass books none of them."""

import gc
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import ultranest_torch
import ultranest_torch.mlfriends as tml
import ultranest_torch.popfused as tpop
from ultranest_torch import tracing
from ultranest_torch.models import problems
from ultranest_torch.parallel import launch

RUN = dict(viz_callback=False, show_status=False,
           max_num_improvement_loops=0, frac_remain=0.5)
PHASES = ('launch', 'fetch', 'replay', 'rebuild', 'results')
# the spans that follow one another through run(); 'segment' and 'gc'
# overlap them
TOP = PHASES + ('prepare', 'classic', 'plan')
# the spans that are profiler ranges while the profiler records
RANGED = ('prepare', 'classic', 'segment', 'rebuild', 'results', 'plan',
          'results/combine', 'results/replay', 'prepare/rebuild',
          'classic/rebuild')


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _eggbox(loglike=None):
    prob = problems.eggbox()
    kw = prob.sampler_kwargs(use_torch=True)
    if loglike is not None:
        kw['torch_loglike'] = loglike
    s = ultranest_torch.ReactiveNestedSampler(seed=1, device='cpu', **kw)
    s.fused_sampler.segment_enabled = True
    return s, dict(RUN, min_num_live_points=100, max_ncalls=200000)


def _spec(loglike=None):
    prob = problems.asymgauss(ndim=8, sigma_min=0.01)
    s = ultranest_torch.ReactiveNestedSampler(
        prob.param_names, prob.loglike, vectorized=True, seed=2,
        device='cpu')
    s.transform_layer_class = tml.ScalingLayer
    s.stepsampler = tpop.FusedPopulationSliceSampler(
        popsize=128, nsteps=16, spec_depth=8, engine='spec', seed=2,
        torch_loglike=loglike or prob.torch_loglike, device='cpu')
    return s, dict(RUN, min_num_live_points=100, region_class=tml.SimpleRegion,
                   cluster_num_live_points=0)


FITS = dict(eggbox=_eggbox, spec=_spec)


def _run(fit, loglike=None):
    """(sampler, run()'s wall) of fit *fit*."""
    sampler, kw = FITS[fit](loglike)
    t0 = time.perf_counter()
    sampler.run(**kw)
    return sampler, time.perf_counter() - t0


def _calls_of_record_function(monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counted(name, *args):
        calls.append(name)
        return real(name, *args)
    monkeypatch.setattr(torch.profiler, 'record_function', counted)
    return calls


@pytest.fixture(scope='module')
def runs():
    """fit -> (sampler, run()'s wall, the names record_function was
    called with, whether gc.callbacks came out as they went in)."""
    out = {}
    for fit in FITS:
        with pytest.MonkeyPatch.context() as mp:
            calls = _calls_of_record_function(mp)
            before = list(gc.callbacks)
            out[fit] = _run(fit) + (calls, gc.callbacks == before)
    return out


def _seconds(rec):
    return {k: v for k, v in rec.items() if not k.endswith('#')}


@pytest.mark.parametrize('fit', sorted(FITS))
def test_phases_keep_their_keys_and_children_their_parents(runs, fit):
    sampler = runs[fit][0]
    rec = sampler._segment_phase_s
    assert isinstance(rec, tracing.Spans) and isinstance(rec, dict)
    for key in PHASES + ('prepare', 'classic', 'plan', 'segment',
                         'fetch/wait', 'fetch/parse', 'results/combine',
                         'results/replay', 'rebuild/layer', 'rebuild/radius',
                         'rebuild/ellipsoid', 'rebuild/tregion'):
        assert rec.get(key + '#', 0) >= 1, key
    secs = _seconds(rec)
    for key, v in secs.items():
        assert v >= 0 and rec[key + '#'] >= 1
        if '/' in key:
            parent = key.rsplit('/', 1)[0]
            assert v <= secs[parent] + 1e-9, (key, v, secs[parent])
    # one parse for every fetch, which waits for its records (and the
    # walk's counts)
    assert rec['fetch/parse#'] == rec['fetch#']
    assert rec['fetch/wait#'] == rec['fetch#'] * (2 if fit == 'spec' else 1)
    if fit == 'spec':
        # the walk's flag reads wait under 'launch'; the diagnostics
        assert rec['launch/wait#'] >= 1
        assert rec['fetch/diagnose#'] == rec['fetch#']


@pytest.mark.parametrize('fit', sorted(FITS))
def test_top_level_spans_cover_the_run(runs, fit):
    sampler, wall = runs[fit][:2]
    rec = sampler._segment_phase_s
    top = sum(v for k, v in _seconds(rec).items() if '/' not in k
              and k not in ('segment', 'gc'))
    assert top == pytest.approx(sum(rec.get(k, 0.0) for k in TOP))
    assert 0.95 * wall <= top <= wall
    # 'segment' holds launch, fetch, replay and rebuild, and no more
    inner = rec['launch'] + rec['fetch'] + rec['replay'] + rec['rebuild']
    assert inner <= rec['segment'] + 1e-9
    assert rec['segment'] <= inner + 0.02 * wall


def _annotations(prof):
    """(start, end, name) of the user annotations on the host."""
    from torch._C._autograd import DeviceType
    return [(e.start_ns(), e.end_ns(), e.name())
            for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation() and e.device_type() == DeviceType.CPU]


@pytest.mark.parametrize('fit', sorted(FITS))
def test_ranges_under_the_profiler_are_named_and_nested_by_key(
        fit, monkeypatch):
    calls = _calls_of_record_function(monkeypatch)
    before = list(gc.callbacks)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sampler, _ = _run(fit)
    assert gc.callbacks == before
    rec = sampler._segment_phase_s
    spans = [a for a in _annotations(prof) if a[2] in rec]
    names = [a[2] for a in spans]
    assert sorted(names) == sorted(calls)
    for key in RANGED:
        assert names.count(key) == rec.get(key + '#', 0), key
    assert set(names) <= set(RANGED)
    # 'segment' holds the segment loop's top-level spans on the timeline
    # and adds nothing to their keys
    for a0, a1, key in spans:
        outer = [s for s in spans if s[0] <= a0 and a1 <= s[1]
                 and s != (a0, a1, key)]
        keyed = [s for s in outer if s[2] != 'segment']
        if '/' in key:
            parent = min(keyed, key=lambda s: s[1] - s[0])
            assert parent[2] == key.rsplit('/', 1)[0], key
        else:
            assert not keyed, (key, keyed[:3])
            assert not outer or key == 'rebuild', (key, outer[:3])


@pytest.mark.parametrize('fit', sorted(FITS))
def test_no_range_and_no_gc_hook_without_a_profiler(runs, fit):
    sampler, _, calls, gc_hooks_kept = runs[fit]
    assert calls == []
    assert gc_hooks_kept
    assert 'gc' not in sampler._segment_phase_s


def test_gc_is_counted_while_the_profiler_records():
    prob = problems.asymgauss(ndim=8, sigma_min=0.01)
    collected = []

    def loglike(x):
        # one collection with something to collect, inside run()
        if not collected:
            a = []
            a.append(a)
            del a
            collected.append(gc.collect())
        return prob.torch_loglike(x)
    before = list(gc.callbacks)
    with profile(activities=[ProfilerActivity.CPU]):
        sampler, _ = _run('spec', loglike)
    assert gc.callbacks == before
    rec = sampler._segment_phase_s
    assert collected and rec['gc#'] >= 1 and rec['gc'] > 0


class _SlowEvent:
    """A CUDA event's stand-in that completes after a few queries."""

    def __init__(self, queries):
        self.queries = queries

    def query(self):
        self.queries -= 1
        time.sleep(0.002)
        return self.queries < 0

    def synchronize(self):
        time.sleep(0.01)


def test_wait_ready_books_wait_under_the_innermost_span(monkeypatch):
    monkeypatch.delenv('ULTRANEST_TORCH_DISPATCH_DEADLINE', raising=False)
    rec = tracing.Spans()
    rec.reset()
    launch.wait_ready(_SlowEvent(3))          # no run in progress
    assert rec == {}
    with rec.running():
        rec.open('fetch', ranged=False)
        launch.wait_ready(_SlowEvent(3))
        launch.wait_ready(None)
        rec.switch('launch', ranged=False)
        launch.wait_ready(_SlowEvent(1), deadline=0)   # synchronize()
    assert rec['fetch/wait#'] == 2 and rec['launch/wait#'] == 1
    assert 0.006 <= rec['fetch/wait'] <= rec['fetch']
    assert 0.01 <= rec['launch/wait'] <= rec['launch']
    assert tracing._current is None


def test_spans_nest_switch_and_unwind():
    rec = tracing.Spans()
    rec.reset()
    rec.open('prepare')
    with rec.count('layer'):
        rec.book('wait', 0.5)
    rec.switch('classic')
    assert rec.innermost == 'classic'
    rec.unwind()
    rec.open('segment', nests=False)
    rec.open('launch', ranged=False)
    with rec.count('capture'):
        pass
    rec.switch('fetch', ranged=False)
    rec.unwind()
    assert rec.innermost is None
    assert set(_seconds(rec)) == {
        'prepare', 'prepare/layer', 'prepare/layer/wait', 'classic',
        'segment', 'launch', 'launch/capture', 'fetch'}
    assert rec['prepare/layer/wait'] == 0.5
    assert all(rec[k + '#'] == 1 for k in _seconds(rec))
    rec.reset()
    assert rec == {} and rec.ranges is False


# the parts of 'launch' on each path and of the per-point iterations,
# with the keys booked inside them that they leave out
SPEC_LAUNCH = ('banks', 'load', 'rounds', 'tail')
REGION_LAUNCH = ('geometry', 'draw', 'filter', 'tail')
LAUNCH_INNER = ('wait', 'capture')
LOOP = ('advice', 'tree', 'count', 'point', 'insert', 'coords')
IMPROVE_INNER = ('draw', 'rebuild', 'wait')


def _improving():
    """The eggbox fit with one improvement pass: a segment pass, then the
    per-point iterations of the pass that widens."""
    prob = problems.eggbox()
    kw = prob.sampler_kwargs(use_torch=True)
    kw.update(ndraw_min=256, ndraw_max=4096)
    s = ultranest_torch.ReactiveNestedSampler(seed=1, device='cpu', **kw)
    s.fused_sampler.segment_enabled = True
    return s, dict(RUN, max_num_improvement_loops=1, min_num_live_points=100,
                   max_ncalls=200000)


def _walking():
    """The spec-walk fit under upstream's run() defaults at the 64 live
    points that dlogz 0.5 asks at least: a segment pass, then
    improvement passes whose per-point iterations ask the walk for
    their points."""
    s, _ = _spec()
    return s, dict(viz_callback=False, show_status=False,
                   min_num_live_points=64, region_class=tml.SimpleRegion)


PARTS = dict(spec=_spec, improving=_improving, walking=_walking)


def _result(sampler):
    return sampler.ncall, sampler.results['niter'], sampler.results['logz']


@pytest.fixture(scope='module')
def parted():
    """fit -> (sampler, the advice calls' innermost spans, the fit's
    ncall, niter and logZ with every booking patched out)."""
    out = {}
    for fit, make in PARTS.items():
        with pytest.MonkeyPatch.context() as mp:
            advice = []
            real = ultranest_torch.ReactiveNestedSampler.\
                _adaptive_strategy_advice

            def counted(self, *args, **kw):
                advice.append(self._segment_phase_s.innermost)
                return real(self, *args, **kw)
            mp.setattr(ultranest_torch.ReactiveNestedSampler,
                       '_adaptive_strategy_advice', counted)
            sampler, kw = make()
            sampler.run(**kw)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tracing.Spans, 'book', lambda *a, **k: None)
            mp.setattr(tracing, 'lap', lambda name: None)
            bare, kw = make()
            bare.run(**kw)
            assert not any(k.endswith(('/wait', '/tail', '/advice'))
                           for k in bare._segment_phase_s)
        out[fit] = sampler, advice, _result(bare)
    return out


def _parts_within(rec, parent, parts, inner):
    """The parts of *parent* and the keys booked inside them: each booked,
    and together at most *parent* and at least 80% of it."""
    for part in parts:
        assert rec.get(parent + '/' + part + '#', 0) >= 1, (parent, part)
    total = sum(rec.get(parent + '/' + k, 0.0) for k in parts + inner)
    assert 0.8 * rec[parent] <= total <= rec[parent] + 1e-9, \
        (parent, total, rec[parent])


def test_a_spec_dispatch_books_its_parts(parted):
    rec = parted['spec'][0]._segment_phase_s
    assert rec['launch#'] >= 1
    _parts_within(rec, 'launch', SPEC_LAUNCH, LAUNCH_INNER)
    # one of each a dispatch ('load' also a segment's start); a
    # segment's last dispatches are never fetched
    assert rec['launch/banks#'] == rec['launch/rounds#'] == \
        rec['launch/tail#'] >= rec['fetch/parse#']
    # the walks outside a dispatch (the classic mode) book no part
    assert not any(k.startswith(('classic/', 'prepare/')) and
                   k.split('/')[1].rstrip('#') in SPEC_LAUNCH
                   for k in rec)


def test_a_region_dispatch_books_its_parts(parted):
    rec = parted['improving'][0]._segment_phase_s
    assert rec['launch#'] >= 1
    _parts_within(rec, 'launch', REGION_LAUNCH, LAUNCH_INNER + ('load',))
    assert rec['launch/geometry#'] == rec['launch/draw#'] == \
        rec['launch/filter#'] == rec['launch/tail#'] >= rec['fetch/parse#']


def test_the_improvement_pass_books_the_per_point_parts(parted):
    sampler, advice = parted['improving'][:2]
    rec = sampler._segment_phase_s
    for key in ('improve/draw', 'improve/rebuild'):
        assert rec.get(key + '#', 0) >= 1, key
    _parts_within(rec, 'improve', LOOP, IMPROVE_INNER)
    assert rec['improve/advice#'] == advice.count('improve')
    assert sum(rec.get(span + '/advice#', 0) for span in
               ('prepare', 'classic', 'improve')) == len(advice)
    assert rec['improve/point#'] == rec['improve/insert#'] \
        == rec['improve/coords#']


def test_the_first_pass_books_the_per_point_parts(parted):
    rec = parted['spec'][0]._segment_phase_s
    _parts_within(rec, 'classic', LOOP, ('rebuild', 'wait', 'capture'))
    assert rec['classic/advice#'] == parted['spec'][1].count('classic')


@pytest.mark.parametrize('fit', sorted(PARTS))
def test_booking_the_parts_changes_no_fit(parted, fit):
    sampler, _, bare = parted[fit]
    assert _result(sampler) == bare


# what the passes after the first book beside the per-point parts
WALK_COUNTS = ('harvested', 'taken', 'dropped', 'stale')


@pytest.mark.parametrize('fit', sorted(FITS))
def test_a_one_pass_run_books_nothing_of_the_passes(runs, fit):
    rec = runs[fit][0]._segment_phase_s
    assert rec['plan#'] == 1
    assert not [k for k in rec if k.startswith(('improve', 'passes'))]


def test_the_passes_book_the_walk_its_points_and_their_clock(parted):
    rec = parted['walking'][0]._segment_phase_s
    assert rec['plan/widen#'] >= 1 and rec['improve#'] >= 1
    # the refills that the passes asked of the walk, inside 'improve'
    assert rec['improve/walk#'] >= 1
    assert rec['improve/walk'] <= rec['improve']
    # the runs of counting-only visits consumed in C are a part too
    _parts_within(rec, 'improve', LOOP + ('sweep',),
                  ('walk', 'rebuild', 'wait'))
    # the counts book no seconds; each point the passes made came from
    # the walk, and no point is both taken and dropped
    n = {k: rec.get('improve/walk/%s#' % k, 0) for k in WALK_COUNTS}
    assert all(rec.get('improve/walk/' + k, 0.0) == 0.0 for k in n)
    assert n['taken'] == rec['improve/point#'] >= 1
    assert n['harvested'] >= n['taken'] + n['dropped']
    # one clock a run, over every 'improve' and within the run's spans
    assert rec['passes#'] == 1
    top = sum(rec[k] for k in TOP + ('improve',) if k in rec)
    assert rec['improve'] <= rec['passes'] < top


def test_laps_book_parts_less_what_was_booked_inside():
    rec = tracing.Spans()
    rec.reset()
    tracing.lap('load')                        # no run in progress
    with rec.running():
        rec.open('launch', ranged=False)
        tracing.lap('load')                    # no laps: nothing
        assert 'launch/load' not in rec
        with rec.laps():
            time.sleep(0.01)
            tracing.lap('load')
            with rec.count('capture'):
                time.sleep(0.02)
            t0 = time.perf_counter()
            time.sleep(0.02)
            waited = time.perf_counter() - t0
            tracing.book('wait', waited, 3)
            time.sleep(0.01)
            tracing.lap('rounds')
        tracing.lap('tail')                    # the clock is gone
        rec.close()
    assert rec['launch/wait'] == waited and rec['launch/wait#'] == 3
    assert rec['launch/load'] >= 0.01
    # the capture and the booked wait are left out of the part
    assert 0.01 <= rec['launch/rounds'] < rec['launch/capture'] + waited
    assert 'launch/tail' not in rec
    parts = sum(rec['launch/' + k]
                for k in ('load', 'capture', 'wait', 'rounds'))
    assert parts <= rec['launch'] < parts + 0.01
    assert rec._mark is None
