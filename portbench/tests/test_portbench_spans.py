"""The readers of the port's spans (``device_wait_s``, ``classic_loop_s``,
``gc_s``) on synthetic fit records and on a small traced CPU run, and
the idle gaps of a trace whose program ranges sit inside ``fit.run``."""

import types

import pytest
import torch

from portbench import harness, trace
from portbench.tests._small import small_cell
from portbench.tests.test_portbench_harness import _Ev

READERS = ('device_wait_s', 'classic_loop_s', 'gc_s')


def _read(metric, fits):
    run = types.SimpleNamespace(fits=fits, trace=None, config={},
                                workload={})
    return harness.load_module('metrics', metric).read(run)


def _fit(**phases):
    return dict(phases={k.replace('__', '/'): v for k, v in phases.items()})


FITS = [_fit(launch=1.0, fetch=0.5, fetch__wait=0.25, launch__wait=0.125,
             prepare=0.5, classic=0.25, plan=0.125, gc=0.0625,
             rebuild__radius__wait=0.0625, **{'fetch__wait#': 7}),
        _fit(launch=1.0, fetch=0.5, classic__wait=0.5, classic=1.0,
             **{'gc#': 0})]


@pytest.mark.parametrize('metric,value', [
    ('device_wait_s', (0.25 + 0.125 + 0.0625 + 0.5) / 2),
    ('classic_loop_s', (0.5 + 0.25 + 0.125 + 1.0) / 2),
    ('gc_s', 0.0625 / 2)])
def test_readers_sum_over_the_fits_and_divide_by_them(metric, value):
    assert _read(metric, FITS) == pytest.approx(value)


@pytest.mark.parametrize('metric', READERS)
def test_readers_give_none_where_no_fit_holds_their_keys(metric):
    fits = [_fit(launch=1.0, fetch=0.5, replay=0.25, rebuild=0.125,
                 results=0.0625, **{'launch#': 3})]
    assert _read(metric, fits) is None
    assert _read(metric, []) is None


def test_program_ranges_inside_fit_run_take_its_idle_time():
    events = [_Ev(0, 1000, trace.WINDOW_SPAN, False, True),
              _Ev(0, 800, 'fit.run', False, True),
              _Ev(100, 500, 'segment', False, True),
              _Ev(400, 500, 'rebuild', False, True),
              _Ev(600, 800, 'results', False, True),
              _Ev(650, 700, 'results/replay', False, True),
              _Ev(800, 1000, 'fit.results', False, True),
              _Ev(150, 200, 'scan_chain_warp', True),
              _Ev(450, 460, 'bootstrap_radius_kernel', True)]
    tr = trace.Trace(events, None, {})
    gaps = dict(tr.idle_gaps())
    assert gaps['fit.run'] == pytest.approx(200e-9)     # [0,100) + [500,600)
    assert gaps['segment'] == pytest.approx(250e-9)
    assert gaps['rebuild'] == pytest.approx(90e-9)
    assert gaps['results'] == pytest.approx(150e-9)
    assert gaps['results/replay'] == pytest.approx(50e-9)
    assert gaps['fit.results'] == pytest.approx(200e-9)
    assert sum(gaps.values()) == pytest.approx(tr.window_s - tr.busy_s)


@pytest.fixture
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_a_traced_cpu_run_reads_the_spans(_one_thread):
    workload, config = small_cell('asymgauss50.live400')
    fitter = harness.Fitter(workload, config, device='cpu',
                            force_segment=True)
    profiler = trace.Profiler(on_card=False)
    with profiler:
        fits, _, failed, _ = harness.run_window(fitter, 2 ** 31 + 5, 0.5,
                                                spans=True)
    tr = profiler.result()
    assert fits and not failed
    run = harness._Run(fits, tr, config, workload)
    for metric in READERS:
        v = harness.load_module('metrics', metric).read(run)
        assert v is not None and v > 0, metric
    # no card: the whole window is idle, and the program's ranges name
    # all but a sliver of what fit.run holds
    gaps = dict(tr.idle_gaps(top=100))
    assert gaps.get('fit.run', 0.0) <= 0.1 * sum(gaps.values())
    program = [s for s in tr.spans if not s[2].startswith('fit.')]
    assert 0 < len(program) / len(fits) <= 125
