"""The port's classic ``NestedSampler`` and its plots, against the JAX
package on the CPU.

The classic sampler's loop, draws and likelihood calls are host numpy in
both packages, and the port's regions are built with ``device='cpu'``,
where the bootstrap radius runs in K2's plain version. With the same
seed both packages make the same draws: ncall and niter are compared
exactly, logZ to 1e-9 (float32 radii equal on these sizes; the sum of
weights in another libm), and against the reference test's own
tolerance (``tests/test_run.py:79-90``: |logZ - analytic| < 1). The plot
functions are host code; they are held to writing their files and to
the reference's shapes.
"""
import inspect
import os

import matplotlib
import numpy as np
import pytest

import ultranest_torch
import ultranest_tpu
from ultranest_torch import plot as tplot
from ultranest_torch.ops import kernels
from ultranest_tpu import plot as jplot

matplotlib.use('Agg')

GAUSS2D_ANALYTIC = np.log(2 * np.pi * 0.1**2)


def gauss_loglike(theta):
    return -0.5 * (((theta - 0.5) / 0.1) ** 2).sum(axis=1)


def transform_unit(x):
    return x


def shifted_transform(x):
    """Two parameters and a derived one."""
    return np.hstack([x, x[:, :1] + x[:, 1:2]])


def _classic(pkg, log_dir, dev, nlive=200, seed=5, **kw):
    return pkg.NestedSampler(
        ['a', 'b'], gauss_loglike, transform=transform_unit, vectorized=True,
        num_live_points=nlive, log_dir=log_dir, seed=seed, **dev, **kw)


def test_exported_with_the_reference_signature():
    assert ultranest_torch.NestedSampler is \
        ultranest_torch.integrator.NestedSampler
    ref = inspect.signature(ultranest_tpu.NestedSampler.__init__).parameters
    got = inspect.signature(ultranest_torch.NestedSampler.__init__).parameters
    assert list(got) == list(ref) + ['device']
    assert got['device'].default == 'cuda'
    for name in ref:
        assert got[name].default == ref[name].default or name == 'self'
    for meth in ('run', 'print_results', 'plot'):
        assert str(inspect.signature(getattr(ultranest_tpu.NestedSampler,
                                             meth))) == \
            str(inspect.signature(getattr(ultranest_torch.NestedSampler,
                                          meth)))


def test_classic_sampler_equals_the_reference(tmp_path, capsys):
    """The reference's test (200 live points, seed 5) on both packages."""
    ref = _classic(ultranest_tpu, str(tmp_path / 'ref'), {}).run(
        max_iters=4000)
    kernels.reset_counts()
    sampler = _classic(ultranest_torch, str(tmp_path / 'port'),
                       dict(device='cpu'))
    got = sampler.run(max_iters=4000)
    assert abs(got['logz'] - GAUSS2D_ANALYTIC) < 1.0
    assert (got['ncall'], got['niter']) == (ref['ncall'], ref['niter'])
    np.testing.assert_allclose(got['logz'], ref['logz'], rtol=0, atol=1e-9)
    np.testing.assert_allclose(got['logzerr'], ref['logzerr'], rtol=1e-9)
    np.testing.assert_allclose(got['samples'], ref['samples'], rtol=0,
                               atol=1e-12)
    for key in ('upoints', 'points', 'weights', 'logl'):
        np.testing.assert_allclose(got['weighted_samples'][key],
                                   ref['weighted_samples'][key], rtol=1e-9,
                                   atol=1e-12)
    assert sorted(got) == sorted(ref)
    # every rebuild bootstrapped its radius through K2's wrapper, on the
    # CPU its plain version; no kernel was launched here
    assert kernels.PLAIN_CALLS['bootstrap_radius'] > 0
    assert sum(kernels.LAUNCHES.values()) == 0
    capsys.readouterr()
    sampler.print_results()
    assert 'logZ = ' in capsys.readouterr().out
    sampler.plot()
    run_dir = sampler.logs
    assert os.path.getsize(os.path.join(run_dir['plots'], 'corner.pdf')) > 0
    with open(os.path.join(run_dir['results'], 'final.csv')) as f:
        assert f.readline().strip() == 'niter,ncall,logz,logzerr,h'


@pytest.mark.parametrize('nlive,seed,ndim', [(50, 1, 1), (80, 2, 3)])
def test_classic_sampler_other_sizes_equal_the_reference(tmp_path, nlive,
                                                         seed, ndim):
    """d 1 takes the ScalingLayer; d 3 a non-vectorized likelihood."""
    names = ['p%d' % i for i in range(ndim)]

    def scalar_loglike(theta):
        return float(-0.5 * (((theta - 0.5) / 0.1) ** 2).sum())

    out = []
    for pkg, dev, sub in ((ultranest_tpu, {}, 'ref'),
                          (ultranest_torch, dict(device='cpu'), 'port')):
        s = pkg.NestedSampler(names, scalar_loglike, vectorized=False,
                              num_live_points=nlive,
                              log_dir=str(tmp_path / sub), seed=seed, **dev)
        out.append(s.run(max_iters=600, dlogz=0.01))
    ref, got = out
    assert (got['ncall'], got['niter']) == (ref['ncall'], ref['niter'])
    np.testing.assert_allclose(got['logz'], ref['logz'], rtol=0, atol=1e-9)


def test_classic_sampler_resumes_from_its_store(tmp_path):
    """A second run on the same directory replays the stored points: the
    same answer, and no likelihood call beyond the model check."""
    first = _classic(ultranest_torch, str(tmp_path), dict(device='cpu'),
                     nlive=60, resume='resume').run(max_iters=500)
    ncalls = []

    def counting(theta):
        ncalls.append(len(theta))
        return gauss_loglike(theta)

    again = ultranest_torch.NestedSampler(
        ['a', 'b'], counting, transform=transform_unit, vectorized=True,
        num_live_points=60, log_dir=str(tmp_path), seed=5, resume='resume',
        device='cpu')
    second = again.run(max_iters=500)
    np.testing.assert_allclose(second['logz'], first['logz'], atol=1e-9)
    assert second['niter'] == first['niter']
    assert sum(ncalls) < first['ncall'] // 2


def test_classic_sampler_without_a_run_directory():
    """With ``log_dir=None`` nothing is stored and nothing is replayed: the
    run ends, with the answer of the run that kept a directory (in the
    reference package this run replays rows of zeros and never ends)."""
    sampler = _classic(ultranest_torch, None, dict(device='cpu'), nlive=60)
    res = sampler.run(max_iters=2000)
    assert abs(res['logz'] - GAUSS2D_ANALYTIC) < 1.0
    assert np.isfinite(res['samples']).all()
    assert ((res['weighted_samples']['upoints'] > 0)
            & (res['weighted_samples']['upoints'] < 1)).all()
    sampler.plot()           # no directory: draws nothing, writes nothing


def test_classic_sampler_checks_the_model():
    with pytest.raises(AssertionError, match='returned shape'):
        ultranest_torch.NestedSampler(
            ['a', 'b'], lambda t: np.zeros((len(t), 2)), vectorized=True,
            log_dir=None, device='cpu')
    with pytest.raises(AssertionError, match='non-finite'):
        ultranest_torch.NestedSampler(
            ['a', 'b'], lambda t: np.full(len(t), np.nan), vectorized=True,
            log_dir=None, device='cpu')
    with pytest.raises(AssertionError, match='transform'):
        ultranest_torch.NestedSampler(
            ['a', 'b'], gauss_loglike, transform=lambda x: x[:, :1],
            vectorized=True, log_dir=None, device='cpu')


@pytest.fixture(scope='module')
def reactive_run(tmp_path_factory):
    """One small reactive run of the port with a run directory."""
    log_dir = str(tmp_path_factory.mktemp('reactive'))
    sampler = ultranest_torch.ReactiveNestedSampler(
        ['a', 'b'], gauss_loglike, transform=shifted_transform,
        derived_param_names=['a+b'], vectorized=True, seed=2,
        log_dir=log_dir, storage_backend='csv', device='cpu')
    sampler.run(min_num_live_points=60, viz_callback=False,
                show_status=False, max_num_improvement_loops=0, min_ess=0,
                dlogz=2.0, frac_remain=0.1)
    return sampler


def test_reactive_plot_writes_its_three_files(reactive_run):
    reactive_run.plot()
    plots = reactive_run.logs['plots']
    for kind in ('corner', 'run', 'trace'):
        assert os.path.getsize(os.path.join(plots, kind + '.pdf')) > 0


@pytest.mark.parametrize('kind', ['corner', 'run', 'trace'])
def test_reactive_plot_methods_write_one_file_each(reactive_run, kind):
    path = os.path.join(reactive_run.logs['plots'], kind + '.pdf')
    if os.path.exists(path):
        os.unlink(path)
    getattr(reactive_run, 'plot_' + kind)()
    assert os.path.getsize(path) > 0


def test_plot_module_has_the_reference_names_and_signatures():
    assert tplot.__all__ == jplot.__all__
    for name in tplot.__all__:
        a, b = getattr(jplot, name), getattr(tplot, name)
        assert b.__module__ == 'ultranest_torch.plot'
        assert str(inspect.signature(a)) == str(inspect.signature(b)), name


@pytest.mark.parametrize('name', ['cornerplot', 'runplot', 'traceplot'])
def test_plot_functions_draw_what_the_reference_draws(reactive_run, name):
    """The same results through both packages' plot functions: the same
    panels, and in each panel the same number of lines."""
    import matplotlib.pyplot as plt
    results = reactive_run.results if name == 'cornerplot' \
        else reactive_run.run_sequence
    figs = []
    for mod in (jplot, tplot):
        out = getattr(mod, name)(results)
        fig = out if name == 'cornerplot' else out[0]
        figs.append([(len(ax.lines), len(ax.collections), ax.get_xlabel(),
                      ax.get_ylabel()) for ax in fig.axes])
        plt.close(fig)
    assert figs[0] == figs[1] and len(figs[1]) >= 3


def test_plot_helpers_equal_the_reference():
    rng = np.random.RandomState(0)
    x = rng.normal(size=500)
    assert tplot.highest_density_interval_from_samples(x) == \
        jplot.highest_density_interval_from_samples(x)
    lo, hi = tplot.highest_density_interval_from_samples(
        np.abs(x), xlo=0.0, probability_level=0.9)
    assert lo == 0.0 and hi > 1.0
    grid = np.linspace(0, 1, 20)
    bands = []
    for mod in (jplot, tplot):
        band = mod.PredictionBand(grid)
        for a in rng.normal(size=50):
            band.add(a * grid)
        bands.append((band.get_line(0.5), band.get_line(0.1)))
        rng = np.random.RandomState(0)
        rng.normal(size=500)
    np.testing.assert_array_equal(bands[0][0].shape, bands[1][0].shape)
    import matplotlib.pyplot as plt
    band.shade(color='k', alpha=0.1)
    band.line(color='k')
    plt.close()


def test_cornerplot_of_a_single_point_posterior_warns(reactive_run):
    """A posterior concentrated in one point draws nothing and says so."""
    import logging
    results = dict(reactive_run.results)
    ws = dict(results['weighted_samples'])
    w = np.zeros_like(ws['weights'])
    w[-1] = 1.0
    ws['weights'] = w
    results['weighted_samples'] = ws
    records = []
    logger = logging.getLogger('test_torch_classic')
    handler = logging.Handler()
    handler.emit = records.append
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        assert tplot.cornerplot(results, logger=logger) is None
    finally:
        logger.removeHandler(handler)
    assert any('single point' in r.getMessage() for r in records)
