"""The readers of the parts of the port's dispatch and per-point spans
(``walk_rounds_s``, ``dispatch_prep_s``, ``dispatch_tail_s``,
``improve_advice_s``, ``improve_count_s``) on synthetic fit records,
and the dispatch's on small traced CPU runs."""

import types

import pytest
import torch

from portbench import harness, trace
from portbench.tests._small import small_cell

READERS = ('walk_rounds_s', 'dispatch_prep_s', 'dispatch_tail_s',
           'improve_advice_s', 'improve_count_s')


def _read(metric, fits):
    run = types.SimpleNamespace(fits=fits, trace=None, config={},
                                workload={})
    return harness.load_module('metrics', metric).read(run)


def _fit(**phases):
    return dict(phases={k.replace('__', '/'): v for k, v in phases.items()})


# a population fit, a region fit with an improvement pass, and a fit
# that booked none of the parts
FITS = [_fit(launch=1.0, launch__wait=0.0625, launch__capture=0.125,
             launch__banks=0.0625, launch__load=0.125, launch__rounds=0.25,
             launch__tail=0.25, **{'launch/rounds#': 4}),
        _fit(launch=0.5, launch__load=0.03125, launch__geometry=0.0625,
             launch__draw=0.0625, launch__filter=0.125, launch__tail=0.125,
             improve=1.0, improve__advice=0.25, improve__count=0.125,
             improve__tree=0.125, improve__draw=0.0625,
             **{'improve/advice#': 9}),
        _fit(classic=0.5, classic__advice=0.25, classic__count=0.125)]


@pytest.mark.parametrize('metric,value', [
    ('walk_rounds_s', 0.25 / 3),
    ('dispatch_prep_s', (0.0625 + 0.125 + 0.03125 + 0.0625 + 0.0625) / 3),
    ('dispatch_tail_s', (0.25 + 0.125) / 3),
    ('improve_advice_s', 0.25 / 3),
    ('improve_count_s', 0.125 / 3)])
def test_readers_sum_their_parts_over_the_fits(metric, value):
    assert _read(metric, FITS) == pytest.approx(value)


@pytest.mark.parametrize('metric', READERS)
def test_readers_give_none_where_no_fit_booked_their_keys(metric):
    # the parent's records: the phases without their parts
    fits = [_fit(launch=1.0, launch__wait=0.25, launch__capture=0.125,
                 fetch=0.5, improve=1.0, improve__draw=0.25,
                 improve__rebuild=0.25, classic__advice=0.125,
                 **{'launch#': 3})]
    assert _read(metric, fits) is None
    assert _read(metric, []) is None


@pytest.fixture
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize('cell,metrics', [
    ('asymgauss50.live400', ('walk_rounds_s', 'dispatch_prep_s',
                             'dispatch_tail_s')),
    ('eggbox2d.live400', ('dispatch_prep_s', 'dispatch_tail_s'))])
def test_a_traced_cpu_run_reads_the_dispatch_parts(cell, metrics,
                                                   _one_thread):
    workload, config = small_cell(cell)
    fitter = harness.Fitter(workload, config, device='cpu',
                            force_segment=True)
    profiler = trace.Profiler(on_card=False)
    with profiler:
        fits, _, failed, _ = harness.run_window(fitter, 2 ** 31 + 5, 0.5,
                                                spans=True)
    assert fits and not failed
    run = harness._Run(fits, profiler.result(), config, workload)
    for metric in metrics:
        v = harness.load_module('metrics', metric).read(run)
        assert v is not None and v > 0, metric
    # the parts stay inside their phase
    assert harness.load_module('metrics', 'dispatch_s').read(run) > \
        sum(harness.load_module('metrics', m).read(run) for m in metrics)
