"""The cell of upstream's default run() on the population walk,
``asymgauss50.upstream``: a run of it cut for the CPU goes on to
improvement passes, reads ``correct`` and gives the three readers of the
passes and their walk a number; every fit of the timed path, on the CPU
cut and on the card at the cell's own size (marked ``cuda``), agrees
with the plain nested-sampling integral (``reference/nested_integral.py``)
over its own tree. The readers on synthetic records read their keys and
nothing where no fit booked them (the parent's records, a one-pass
fit's)."""

import copy
import types

import pytest
import torch

from portbench import harness
from portbench.tests.test_portbench_upstream import assert_agrees

CELL = 'asymgauss50.upstream'
READERS = ('improve_passes_s', 'improve_walk_s', 'improve_walk_yield_pct')


def _small():
    """The cell cut for the CPU: d 8, 128 walkers of 16 steps (as
    ``_small.py`` cuts ``asymgauss50``), at 64 live points, the least that
    upstream's dlogz 0.5 allows (at d 8 a fit with 100 meets every target
    in its first pass), one fit in the pool and one after the window."""
    workload, config = harness.load_cell(CELL)
    workload, config = copy.deepcopy(workload), copy.deepcopy(config)
    workload['run']['min_num_live_points'] = 64
    workload['fit_pool'] = dict(workload['fit_pool'], size=1)
    workload['check_fits'] = 1
    config['stepsampler']['kwargs'].update(popsize=128, nsteps=16)
    config['problem_args'] = dict(config['problem_args'], ndim=8)
    return workload, config


@pytest.fixture
def _captured(monkeypatch):
    """(sampler, result) of every run() in the test."""
    import ultranest_torch
    runs = []
    real = ultranest_torch.ReactiveNestedSampler.run

    def run(self, **kw):
        res = real(self, **kw)
        runs.append((self, res))
        return res
    monkeypatch.setattr(ultranest_torch.ReactiveNestedSampler, 'run', run)
    return runs


@pytest.fixture
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_a_traced_cpu_run_widens_reads_correct_and_its_readers_read(
        _one_thread, _captured):
    workload, config = _small()
    # run() at upstream's defaults: nothing but the live points and the
    # guard is set
    assert set(config['run']) == {'max_ncalls'}
    assert set(workload['run']) == {'min_num_live_points'}
    result, rows, _ = harness.run_cell(
        CELL, workload, config, harness.benchmark_spec(), 2 ** 31 + 21,
        0.5, 1, device='cpu')
    assert result['correct'] and result['failed'] == 0, rows
    assert sorted(result['metrics']) == sorted(READERS)
    assert all(m['value'] > 0 for m in result['metrics'].values())
    assert result['metrics']['improve_walk_yield_pct']['value'] <= 100
    # the warm-up fit, the window's and the one after it: each widened
    # and ran an improvement pass on the walk, and agrees with the
    # integral over its tree
    assert len(_captured) == 3
    for sampler, res in _captured:
        phases = sampler._segment_phase_s
        assert phases['plan/widen#'] >= 1 and phases['improve#'] >= 1
        assert phases['improve/walk'] < phases['improve'] \
            <= phases['passes']
        assert_agrees(sampler, res)


def _read(metric, fits):
    run = types.SimpleNamespace(fits=fits, trace=None, config={},
                                workload={})
    return harness.load_module('metrics', metric).read(run)


def _fit(**phases):
    return dict(phases={k.replace('__', '/'): v for k, v in phases.items()})


# two fits with improvement passes on the walk, and one of one pass
FITS = [_fit(passes=2.0, improve=1.5, improve__walk=0.5,
             **{'improve/walk/harvested#': 300, 'improve/walk/taken#': 12,
                'improve/walk/dropped#': 250}),
        _fit(passes=1.0, improve=0.75, improve__walk=0.25,
             **{'improve/walk/harvested#': 100, 'improve/walk/taken#': 8}),
        _fit(classic=0.5, launch=1.0, plan=0.125)]


@pytest.mark.parametrize('metric,value', [
    ('improve_passes_s', 3.0 / 3),
    ('improve_walk_s', 0.75 / 3),
    ('improve_walk_yield_pct', 100.0 * 20 / 400)])
def test_readers_read_their_keys_over_the_fits(metric, value):
    assert _read(metric, FITS) == pytest.approx(value)


@pytest.mark.parametrize('metric', READERS)
def test_readers_give_none_where_no_fit_booked_their_keys(metric):
    # the parent's records of an upstream fit: the passes without the
    # new keys, and a one-pass fit
    fits = [_fit(improve=1.0, improve__draw=0.25, improve__rebuild=0.25,
                 plan=0.125, **{'plan/widen#': 1}),
            _fit(classic=0.5, launch=1.0)]
    assert _read(metric, fits) is None
    assert _read(metric, []) is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')


@pytest.mark.cuda
def test_every_timed_fit_agrees_with_the_integral_on_the_card(
        card, _captured):
    """One cycle of the cell's pool at its own size (d 50, 4096 walkers,
    400 live points), as the window makes it, and its fits after the
    window: each made an improvement pass on the walk."""
    from ultranest_torch.ops import kernels
    kernels.build()
    workload, config = harness.load_cell(CELL)
    fitter = harness.Fitter(workload, config)
    fits, attempted, failed, _ = harness.run_window(
        fitter, 2 ** 31 + 29, 0.5)
    for s in harness.check_seeds(2 ** 31 + 29, workload['check_fits']):
        fits.append(fitter.fit(s))
    assert not failed and len(_captured) == len(fits) >= 2
    for sampler, result in _captured:
        phases = sampler._segment_phase_s
        assert phases['improve#'] >= 1
        assert phases['improve/walk/taken#'] >= 1
        print('niter %d, ncall %d, logz %.6f, passes %d: %s' % (
            result['niter'], result['ncall'], result['logz'],
            phases['plan#'], assert_agrees(sampler, result)))
