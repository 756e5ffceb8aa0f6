"""The port's dispatch watchdog, on the CPU, against the JAX package's.

Mirrors ``tests/test_watchdog.py``: a device read that misses the
dispatch deadline raises ``DeviceLostError``; the integrator swaps in
the host samplers and the run finishes inside the reference test's logZ
gate, 3 max(logzerr, 0.5). A CPU tensor has no CUDA event, so the tests
simulate a device that stops answering through the watchdog's one query,
``launch.is_ready`` (the reference's tests patch ``fetch_replicated``).
The population walk reads its done flag from the device before any
result fetch; its flag read carries the deadline too.
"""
import time

import numpy as np
import pytest
import torch

import ultranest_tpu.parallel.launch as jlaunch
from ultranest_torch import ReactiveNestedSampler
from ultranest_torch import popfused
from ultranest_torch.models import problems
from ultranest_torch.ops import cluster
from ultranest_torch.parallel import launch

CPU = 'cpu'
RUN = dict(min_num_live_points=100, viz_callback=False, show_status=False,
           max_num_improvement_loops=0, min_ess=0, dlogz=2.0,
           frac_remain=0.1)


def _hang_device_after(monkeypatch, nreads, deadline='0.3'):
    """After *nreads* device reads, the device never answers again."""
    state = {'n': 0}

    def hanging(event):
        if state['n'] >= nreads:
            return False
        state['n'] += 1
        return True

    monkeypatch.setattr(launch, 'is_ready', hanging)
    monkeypatch.setenv('ULTRANEST_TORCH_DISPATCH_DEADLINE', deadline)
    return state


def test_deadline_is_the_reference_default(monkeypatch):
    assert launch.DEFAULT_DISPATCH_DEADLINE == \
        jlaunch.DEFAULT_DISPATCH_DEADLINE == 900.0
    monkeypatch.delenv('ULTRANEST_TORCH_DISPATCH_DEADLINE', raising=False)
    assert launch.dispatch_deadline() == 900.0
    monkeypatch.setenv('ULTRANEST_TORCH_DISPATCH_DEADLINE', '2.5')
    assert launch.dispatch_deadline() == 2.5
    assert issubclass(launch.DeviceLostError, RuntimeError)


@pytest.mark.parametrize('reader', ['fetch', 'flag', 'cluster'])
def test_blocking_reads_raise_past_the_deadline(monkeypatch, reader):
    """Each kind of blocking read raises, as the reference's
    ``fetch_with_deadline`` does behind a fetch that never returns."""
    monkeypatch.setattr(jlaunch, 'fetch_replicated',
                        lambda x: time.sleep(3600))
    with pytest.raises(jlaunch.DeviceLostError):
        jlaunch.fetch_with_deadline(np.zeros(3), deadline=0.3)
    _hang_device_after(monkeypatch, 0)
    t0 = time.monotonic()
    with pytest.raises(launch.DeviceLostError, match='deadline'):
        if reader == 'fetch':
            launch.fetch_with_deadline(torch.zeros(3))
        elif reader == 'flag':
            popfused._drive_rounds(lambda n: torch.zeros((), dtype=bool),
                                   100, 8, 0)
        else:
            cluster.label_propagation_components(
                np.random.RandomState(0).uniform(size=(20, 2)), 0.1,
                device=CPU)
    assert 0.3 <= time.monotonic() - t0 < 5


@pytest.mark.parametrize('deadline', ['5', '0'])
def test_slow_device_within_the_deadline(monkeypatch, deadline):
    """A read that completes late is no loss; with
    ULTRANEST_TORCH_DISPATCH_DEADLINE=0 no read ever raises."""
    polls = {'n': 0}

    def slow(event):
        polls['n'] += 1
        return polls['n'] > 100

    monkeypatch.setattr(launch, 'is_ready', slow)
    monkeypatch.setenv('ULTRANEST_TORCH_DISPATCH_DEADLINE', deadline)
    np.testing.assert_array_equal(
        launch.fetch_with_deadline(torch.arange(3)), [0, 1, 2])
    assert polls['n'] == (101 if deadline == '5' else 1)


@pytest.mark.parametrize('nreads', [3, 30])
def test_population_run_survives_device_loss(monkeypatch, nreads):
    """Lost at the third read (the classic hand-out, before segment mode
    starts) and at the thirtieth (inside a segment's walk)."""
    prob = problems.gauss(ndim=2, sigma=0.1)
    state = _hang_device_after(monkeypatch, nreads)
    sampler = ReactiveNestedSampler(seed=1, device=CPU,
                                    **prob.sampler_kwargs(use_torch=False))
    sampler.stepsampler = popfused.FusedPopulationSliceSampler(
        popsize=64, nsteps=8, torch_loglike=prob.torch_loglike, seed=1,
        device=CPU)
    np.random.seed(1)
    with pytest.warns(UserWarning, match='accelerator lost'):
        res = sampler.run(**RUN)
    assert state['n'] == nreads, 'the hang was never triggered'
    # the device sampler was swapped for the host slice sampler
    assert not isinstance(sampler.stepsampler,
                          popfused.FusedPopulationSliceSampler)
    assert sampler.stepsampler.nsteps == 8
    assert getattr(sampler, '_segment_exits', {}).get('device-lost', 0) \
        == int(nreads > 3)
    assert abs(res['logz'] - prob.logz) < 3 * max(res['logzerr'], 0.5), \
        (res['logz'], prob.logz)


@pytest.mark.parametrize('segment', [False, True])
def test_rejection_run_survives_device_loss(monkeypatch, segment):
    """Both catch sites: the classic fill and the segment loop."""
    prob = problems.gauss(ndim=2, sigma=0.1)
    state = _hang_device_after(monkeypatch, 3)
    sampler = ReactiveNestedSampler(seed=2, device=CPU,
                                    **prob.sampler_kwargs(use_torch=True))
    assert sampler.fused_sampler is not None
    sampler.fused_sampler.segment_enabled = segment
    with pytest.warns(UserWarning, match='accelerator lost'):
        res = sampler.run(**RUN)
    assert state['n'] == 3
    assert sampler.fused_sampler is None
    assert getattr(sampler, '_segment_exits', {}).get('device-lost', 0) \
        == int(segment)
    assert abs(res['logz'] - prob.logz) < 3 * max(res['logzerr'], 0.5), \
        (res['logz'], prob.logz)
