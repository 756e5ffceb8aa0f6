"""The port's host step samplers against the JAX package on the CPU.

``ultranest_torch.stepsampler`` is numpy on the host, and draws from the
global numpy stream in the reference's order. So every case here seeds
that stream, runs the same inputs (made from a seed with numpy) through
``ultranest_tpu.stepsampler`` and through the port, and compares
exactly: directions, brackets, chain criteria and selectors bit for bit
(no device code), whole seeded runs under ``ReactiveNestedSampler`` in
ncall, niter and logZ (equal draws; the regions' radius is float32 on
both sides and the bootstrap's plain version agrees with the
reference's on these sizes, so the tolerance on logZ is 1e-9, for the
host counters' libm), and inside the reference test's own gate
(``tests/test_stepsamplers.py:123-131``: |logZ - analytic| < 2).
The regions are built with ``device='cpu'``.
"""
import io

import numpy as np
import pytest
import torch

import ultranest_torch
import ultranest_tpu
from ultranest_torch import mlfriends as tml
from ultranest_torch import stepsampler as tss
from ultranest_tpu import mlfriends as jml
from ultranest_tpu import stepsampler as jss

CPU = torch.device('cpu')
PACKAGES = ((jss, jml, {}), (tss, tml, dict(device=CPU)))


def make_region(ml, dev, npts=100, ndim=2, seed=0):
    """The region of the reference's step sampler tests."""
    rng = np.random.RandomState(seed)
    u = rng.uniform(0.3, 0.7, size=(npts, ndim))
    tl = ml.AffineLayer()
    tl.optimize(u, u)
    region = ml.MLFriends(u, tl, **dev)
    region.maxradiussq, region.enlarge = region.compute_enlargement(
        nbootstraps=10, rng=np.random.RandomState(seed))
    region.create_ellipsoid()
    return region


def gauss_loglike(theta):
    return -0.5 * (((theta - 0.5) / 0.1) ** 2).sum(axis=1)


def transform_unit(x):
    return np.asarray(x)


GAUSS2D_ANALYTIC = np.log(2 * np.pi * 0.1**2)


def _signature(fn):
    """Parameter names and kinds, and the defaults that are plain values
    (a default that is a function differs by its address)."""
    import inspect
    return [(p.name, p.kind, p.default if not callable(p.default)
             else p.default.__name__)
            for p in inspect.signature(fn).parameters.values()]


def test_port_has_the_reference_names_and_signatures():
    assert tss.__all__ == jss.__all__
    for name in jss.__all__ + ['inside_region', 'adapt_proposal_move_distances',
                               'adapt_proposal_move_distances_midway',
                               'adapt_proposal_total_distances',
                               'adapt_proposal_summed_distances_NN']:
        a, b = getattr(jss, name), getattr(tss, name)
        assert b.__module__ == 'ultranest_torch.stepsampler'
        assert _signature(a) == _signature(b), name
    for cls in ('StepSampler', 'MHSampler', 'SliceSampler'):
        for meth in ('__init__', '__next__', 'move', 'adjust_accept',
                     'finalize_chain', 'region_changed', 'new_chain'):
            assert _signature(getattr(getattr(jss, cls), meth)) \
                == _signature(getattr(getattr(tss, cls), meth))


GENERATORS = [
    'generate_random_direction', 'generate_cube_oriented_direction',
    'generate_cube_oriented_differential_direction',
    'generate_differential_direction',
    'generate_partial_differential_direction',
    'generate_region_oriented_direction', 'generate_region_random_direction',
    'generate_mixture_random_direction', 'generate_region_sample_direction',
    'SequentialDirectionGenerator', 'SequentialRegionDirectionGenerator',
    'OrthogonalDirectionGenerator', 'SpeedVariableGenerator']


@pytest.mark.parametrize('ndim', [2, 5])
@pytest.mark.parametrize('name', GENERATORS)
def test_direction_generators_equal_the_reference(name, ndim):
    out = []
    for ss, ml, dev in PACKAGES:
        region = make_region(ml, dev, ndim=ndim, seed=ndim)
        gen = getattr(ss, name)
        if name == 'OrthogonalDirectionGenerator':
            gen = gen(ss.generate_region_random_direction)
        elif name == 'SpeedVariableGenerator':
            gen = gen([slice(0, 1), slice(1, ndim), slice(0, ndim)])
        elif isinstance(gen, type):
            gen = gen()
        np.random.seed(7)
        out.append(np.array([gen(region.u[i], region, scale=0.7)
                             for i in range(2 * ndim + 3)]))
    assert np.isfinite(out[1]).all() and (out[1] != 0).any(axis=1).all()
    np.testing.assert_array_equal(out[0], out[1])


def test_region_queries_of_the_step_sampler_run_on_the_regions_device():
    """``inside_region``, ``region.sample`` and the mean pair distance go
    through the region, which carries the device it was built with."""
    region = make_region(tml, dict(device=CPU))
    assert region.device == CPU
    pts = np.vstack([region.u[:5], [[0.01, 0.99]]])
    np.testing.assert_array_equal(
        tss.inside_region(region, pts, None),
        jss.inside_region(make_region(jml, {}), pts, None))
    assert tss.inside_region(region, pts, None).tolist() == [True] * 5 + [False]
    mpd = [make_region(ml, dev).compute_mean_pair_distance()
           for _, ml, dev in PACKAGES]
    np.testing.assert_allclose(mpd[1], mpd[0], rtol=1e-6)
    with pytest.raises(TypeError):
        tml.MLFriends(region.u, region.transformLayer)   # device is required


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_brackets_equal_the_reference(seed):
    rng = np.random.RandomState(seed)
    ndim = 4
    center = rng.uniform(0.4, 0.6, ndim)
    inv_axes = np.linalg.inv(rng.normal(size=(ndim, ndim)) * 0.2
                             + np.eye(ndim))
    ui = center + rng.normal(size=ndim) * 0.02
    v = rng.normal(size=ndim)
    a = jss.ellipsoid_bracket(ui, v, center, inv_axes, 1.0)
    b = tss.ellipsoid_bracket(ui, v, center, inv_axes, 1.0)
    assert a == b and b[0] <= 0 <= b[1]
    ca = jss.crop_bracket_at_unit_cube(ui, v, 10 * a[0], 10 * a[1])
    cb = tss.crop_bracket_at_unit_cube(ui, v, 10 * b[0], 10 * b[1])
    assert ca == cb and cb[2] and cb[3]
    with pytest.raises(AssertionError):
        tss.ellipsoid_bracket(center + 10, v, center, inv_axes, 1.0)


@pytest.mark.filterwarnings('ignore::DeprecationWarning')
@pytest.mark.parametrize('name', [
    'adapt_proposal_move_distances', 'adapt_proposal_move_distances_midway',
    'adapt_proposal_total_distances', 'adapt_proposal_total_distances_NN',
    'adapt_proposal_summed_distances', 'adapt_proposal_summed_distances_NN'])
def test_adapt_proposal_criteria_equal_the_reference(name):
    out = []
    for ss, ml, dev in PACKAGES:
        region = make_region(ml, dev, ndim=3, seed=3)
        rng = np.random.RandomState(5)
        track = region.u[0] + np.cumsum(rng.normal(size=(12, 3)) * 0.01,
                                        axis=0)
        history = [(u, np.float64(-i)) for i, u in enumerate(track)]
        mpd = region.compute_mean_pair_distance()
        far, extra = getattr(ss, name)(region, history, mpd, 3)
        out.append((bool(far), np.asarray(extra, float)))
    assert out[0][0] == out[1][0]
    # the radius is float32 on both sides; the pair distance is summed on
    # the region's device in the port (1e-6, another order of the sum)
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=1e-6)


@pytest.mark.parametrize('exchange', [0, 0.3])
def test_island_selector_equals_the_reference(exchange):
    Ls = np.arange(16).astype(float)
    us = np.zeros((16, 2))
    picks = []
    for ss, _, _ in PACKAGES:
        np.random.seed(5)
        sel = ss.IslandPopulationRandomLivepointSelector(
            island_size=4, exchange_probability=exchange)
        picks.append([sel(us, Ls, Lmin=5.0) for _ in range(40)]
                     + [sel(us, Ls, Lmin=-1.0) for _ in range(5)]
                     + [ss.select_random_livepoint(us, Ls, 5.0)])
    assert picks[0] == picks[1]
    if exchange == 0:
        assert all(4 <= i < 8 for i in picks[1][:40])


@pytest.mark.parametrize('kind', ['slice', 'slice_filtered', 'mh', 'log'])
def test_chain_protocol_equals_the_reference_step_by_step(kind):
    """``__next__`` on a fixed region: the same proposals, likelihood
    calls, scales and finished points, call by call."""
    traces = []
    for ss, ml, dev in PACKAGES:
        region = make_region(ml, dev, npts=60, ndim=3, seed=1)
        us = region.u.copy()
        Ls = gauss_loglike(us)
        Lmin = np.sort(Ls)[5]
        log = io.StringIO()
        if kind == 'mh':
            sampler = ss.RegionMHSampler(nsteps=4)
        else:
            sampler = ss.SliceSampler(
                nsteps=4, region_filter=kind == 'slice_filtered',
                generate_direction=ss.generate_mixture_random_direction,
                adaptive_nsteps='move-distance' if kind == 'log' else False,
                log=log if kind == 'log' else False)
        sampler.region_changed(Ls, region)
        np.random.seed(11)
        calls, trace = [], []

        def loglike(p):
            calls.append(p.copy())
            return gauss_loglike(p)

        for _ in range(120):
            u, p, L, nc = sampler.__next__(
                region, Lmin, us, Ls, transform_unit, loglike, ndraw=10)
            trace.append((None if u is None else u.copy(), L, nc,
                          sampler.scale, sampler.next_scale, sampler.nsteps,
                          len(sampler.history)))
        traces.append((np.vstack(calls), trace, sampler.logstat,
                       log.getvalue(), sampler.get_info_dict()['num_logs']))
    (ca, ta, la, loga, na), (cb, tb, lb, logb, nb) = traces
    np.testing.assert_array_equal(ca, cb)
    assert na == nb > 0 and loga == logb
    for a, b in zip(ta, tb):
        assert (a[0] is None) == (b[0] is None) and a[1:] == b[1:]
        if a[0] is not None:
            np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(np.asarray(la, float),
                                  np.asarray(lb, float))
    assert any(t[0] is not None for t in tb)


def run_sampler_on_gauss(pkg, sampler, dev, seed=4, nlive=100):
    """The run of ``tests/test_stepsamplers.py:123-131``."""
    np.random.seed(seed)
    rsampler = pkg.ReactiveNestedSampler(
        ['a', 'b'], gauss_loglike, transform=transform_unit,
        vectorized=True, seed=seed, **dev)
    rsampler.stepsampler = sampler
    return rsampler.run(min_num_live_points=nlive, viz_callback=False,
                        show_status=False, max_num_improvement_loops=0,
                        min_ess=0, dlogz=2.0, frac_remain=0.1), rsampler


SAMPLERS = {
    'region_slice': lambda ss: ss.RegionSliceSampler(nsteps=10),
    'cube_slice': lambda ss: ss.CubeSliceSampler(nsteps=10),
    'region_ball_slice': lambda ss: ss.RegionBallSliceSampler(nsteps=10),
    'cube_mh': lambda ss: ss.CubeMHSampler(nsteps=20, check_nsteps=False),
    'mixture_slice_filtered': lambda ss: ss.SliceSampler(
        nsteps=10, region_filter=True,
        generate_direction=ss.generate_mixture_random_direction),
    'adaptive_sequential': lambda ss: ss.RegionSequentialSliceSampler(
        nsteps=5, adaptive_nsteps='proposal-summed-distances',
        max_nsteps=40),
    'speed_variable': lambda ss: ss.SpeedVariableRegionSliceSampler(
        [slice(0, 1), slice(0, 2)]),
}


@pytest.mark.filterwarnings('ignore::DeprecationWarning')
@pytest.mark.parametrize('name', sorted(SAMPLERS))
def test_scalar_stepsampler_run_equals_the_reference(name, capsys):
    make = SAMPLERS[name]
    ref, _ = run_sampler_on_gauss(ultranest_tpu, make(jss), {})
    got, rsampler = run_sampler_on_gauss(ultranest_torch, make(tss),
                                         dict(device='cpu'))
    assert abs(got['logz'] - GAUSS2D_ANALYTIC) < 2.0, got['logz']
    assert (got['ncall'], got['niter']) == (ref['ncall'], ref['niter'])
    np.testing.assert_allclose(got['logz'], ref['logz'], rtol=0, atol=1e-9)
    np.testing.assert_allclose(got['logzerr'], ref['logzerr'], rtol=1e-9)
    np.testing.assert_allclose(got['samples'], ref['samples'], rtol=0,
                               atol=1e-12)
    # the hooks of the reactive sampler that only a host step sampler
    # exercises: the region hand-over, the info dict and the diagnostic
    ss = rsampler.stepsampler
    info = ss.get_info_dict()
    assert info['num_logs'] > 0 and 0 <= info['rejection_rate'] < 1000
    assert rsampler.region.device == torch.device('cpu')
    capsys.readouterr()
    rsampler.print_results()
    printed = capsys.readouterr().out
    assert 'logZ = ' in printed
    if ss.check_nsteps or ss.adaptive_nsteps:
        assert 'step sampler diagnostic' in printed
        assert np.isfinite(ss.mean_jump_distance)


def test_stepsampler_plots_and_strings(tmp_path):
    import matplotlib
    matplotlib.use('Agg')
    sampler = tss.RegionSliceSampler(nsteps=5)
    assert str(sampler).startswith('SliceSampler(nsteps=5')
    run_sampler_on_gauss(ultranest_torch, sampler, dict(device='cpu'),
                         nlive=50)
    sampler.plot(str(tmp_path / 'stats.pdf'))
    sampler.plot_jump_diagnostic_histogram(str(tmp_path / 'jumps.pdf'))
    for name in ('stats.pdf', 'stats.pdf.txt.gz', 'jumps.pdf'):
        assert (tmp_path / name).stat().st_size > 0
    with pytest.raises(ValueError):
        tss.SliceSampler(nsteps=5, check_nsteps='nonsense',
                         generate_direction=tss.generate_random_direction)
    with pytest.raises(AssertionError):
        tss.SliceSampler(nsteps=50, adaptive_nsteps='move-distance',
                         max_nsteps=10,
                         generate_direction=tss.generate_random_direction)
