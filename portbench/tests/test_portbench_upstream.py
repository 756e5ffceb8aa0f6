"""The cell of upstream's default run(), ``eggbox2d.upstream``: a run of
it cut for the CPU goes on to improvement passes, reads ``correct`` and
gives the three readers of the improvement passes' spans a number; and
every fit of the timed path, on the CPU cut and on the card at the
cell's own size (marked ``cuda``), agrees with the plain nested-sampling
integral (``reference/nested_integral.py``) over its own tree."""

import copy

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.check import _rel_gap
from portbench.reference import nested_integral

CELL = 'eggbox2d.upstream'
READERS = ('improve_s', 'improve_rebuild_s', 'improve_draw_s')
# both sides are float64 and differ only in the order of summation
RTOL = 1e-9


def _small():
    """The cell cut for the CPU: its own 400 live points (with 200 a fit
    finds too few of the 18 modes to widen for, and with 100 its first
    pass reaches ``max_ncalls``), candidates drawn 256 to 4096 a batch,
    one fit in the pool and one after the window."""
    workload, config = harness.load_cell(CELL)
    workload, config = copy.deepcopy(workload), copy.deepcopy(config)
    config['sampler'] = dict(ndraw_min=256, ndraw_max=4096)
    workload['fit_pool'] = dict(workload['fit_pool'], size=1)
    workload['check_fits'] = 1
    return workload, config


def _tree(root):
    """(birth, logl) of every node below *root*: a node's birth is its
    parent's log-likelihood, minus infinity under the root."""
    birth, logl = [], []
    stack = [(-np.inf, n) for n in root.children]
    while stack:
        b, node = stack.pop()
        birth.append(b)
        logl.append(node.value)
        stack.extend((node.value, c) for c in node.children)
    return np.array(birth), np.array(logl)


def assert_agrees(sampler, result):
    """The run's logZ and normalised weights against the integral over
    its final tree; returns the widest relative gap of each and the
    most live points at a death."""
    ref = nested_integral.integrate(*_tree(sampler.root))
    ws = result['weighted_samples']
    logl = np.asarray(ws['logl'], float)
    np.testing.assert_array_equal(logl, ref['logl'])
    logw = np.asarray(ws['logw'], float) + logl - result['logz']
    out = dict(logz=_rel_gap(result['logz'], ref['logz']),
               logw=_rel_gap(logw, ref['logw']))
    assert out['logz'] <= RTOL and out['logw'] <= RTOL, out
    out['nlive_max'] = int(ref['nlive'].max())
    return out


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
    # the warm-up fit, the window's and the one after it: each widened
    # in a second pass and agrees with the integral over its tree
    assert len(_captured) == 3
    for sampler, res in _captured:
        phases = sampler._segment_phase_s
        assert phases['plan/strategy#'] >= 1 and phases['plan/widen#'] >= 1
        assert phases['improve/rebuild'] < phases['improve']
        assert phases['improve/draw'] < phases['improve']
        assert_agrees(sampler, res)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')


@pytest.mark.cuda
def test_every_timed_fit_agrees_with_the_integral_on_the_card(
        card, _captured):
    """One cycle of the cell's pool at its own size (400 live points), as
    the window makes it, and its fits after the window."""
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
        print('niter %d, ncall %d, logz %.6f: %s' % (
            result['niter'], result['ncall'], result['logz'],
            assert_agrees(sampler, result)))
