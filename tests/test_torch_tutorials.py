"""The port's host tutorials (``examples/torch_port/tutorial_*.py``)
against the JAX package's, on the CPU, at their ``--fast``/``--quick``
sizes (``tutorial_linefit`` has none and runs at its defaults).

They pass a numpy likelihood: the loops run on the host and the regions
are built (K2 at every MLFriends rebuild) on ``device='cpu'``, where the
kernel wrappers take their plain versions. The same numpy seeds make the
same decisions in both packages, so each run's ncall and niter are equal
and its logZ within 1e-6 relative (its points can differ in the last
bits of their float32 region sampling without changing a decision; see
below), with one exception. The bootstrap radius of a region rebuild is float32; the JAX
package computes it with XLA, which on the CPU contracts the squared
distances' multiply-adds into FMAs, the port rounds each step (ROADMAP.md
section C), so in 48 of the 74 rebuilds of the line model of
``tutorial_linefit`` the two radii differ by one float32 ulp. The
bounding box of the region's sampling moves with the radius, so the
proposals move by ~1e-9; mostly no decision changes (the logZ of such
runs then agrees within 1e-6 relative), but the line model parts from
the reference after 2750 equal dead points, and so do some of the
simulations of ``tutorial_sine_modelcomparison``. Those are held to the
reference statistically: logZ within the larger logzerr, ncall and
niter within 1%. Some region paths draw from numpy's global stream, not
the sampler's seeded one, in both packages (ROADMAP.md section C), so
each test seeds that stream before each package's run.
"""
import itertools
import os
import runpy
import sys

import numpy as np

from torch_port_helpers import REPO as _REPO
from torch_port_helpers import load_script, one_thread  # noqa: F401



def _load(name, port=True):
    """The port's example *name* (or, with *port* false, the JAX
    package's)."""
    if port:
        return load_script('examples/torch_port/%s.py' % name,
                           'torch_port_' + name)
    return load_script('examples/%s.py' % name, 'jax_example_' + name)



def _equal(mine, ref):
    assert (int(mine['ncall']), int(mine['niter'])) == \
        (int(ref['ncall']), int(ref['niter']))
    assert abs(mine['logz'] - ref['logz']) < 1e-6 * max(1.0, abs(ref['logz'])), \
        (mine['logz'], ref['logz'])


def _solve_equal(mine, ref):
    assert abs(mine['logZ'] - ref['logZ']) < 1e-6 * max(1.0, abs(ref['logZ']))
    assert abs(mine['logZerr'] - ref['logZerr']) < 1e-6


def test_linefit(capsys):
    np.random.seed(1)
    ref_const, ref_line = _load('tutorial_linefit', port=False).main()
    np.random.seed(1)
    const, line = _load('tutorial_linefit').main(device='cpu')
    _equal(const, ref_const)
    assert abs(line['logz'] - ref_line['logz']) < max(line['logzerr'],
                                                      ref_line['logzerr'])
    for key in ('ncall', 'niter'):
        assert abs(line[key] - ref_line[key]) < 0.01 * ref_line[key]
    assert 'line strongly preferred' in capsys.readouterr().out


def test_outliers():
    np.random.seed(1)
    ref = _load('tutorial_outliers', port=False).main(fast=True)
    np.random.seed(1)
    mine = _load('tutorial_outliers').main(fast=True, device='cpu')
    assert list(mine) == list(ref)
    for name in ref:
        _equal(mine[name], ref[name])


def test_intrinsic_distribution():
    np.random.seed(1)
    ref = _load('tutorial_intrinsic_distribution', port=False).main(
        fast=True)
    np.random.seed(1)
    mine = _load('tutorial_intrinsic_distribution').main(fast=True,
                                                         device='cpu')
    _equal(mine, ref)


def test_warmstart(tmp_path, monkeypatch):
    (tmp_path / 'jax').mkdir()
    (tmp_path / 'torch').mkdir()
    monkeypatch.chdir(tmp_path / 'jax')
    np.random.seed(1)
    ref = _load('tutorial_warmstart', port=False).main(fast=True)
    monkeypatch.chdir(tmp_path / 'torch')
    np.random.seed(1)
    mine = _load('tutorial_warmstart').main(fast=True, device='cpu')
    for a, b in zip(mine, ref):
        _equal(a, b)
    # the csv point store (h5py is not on every machine) runs the same
    np.random.seed(1)
    mine_csv = _load('tutorial_warmstart').main(
        fast=True, storage_backend='csv', device='cpu')
    for a, b in zip(mine_csv, ref):
        _equal(a, b)


def _run_jax_script(name, monkeypatch):
    """The JAX tutorial *name* (a script that parses its arguments and
    runs when imported) at --quick; returns its globals."""
    monkeypatch.setattr(sys, 'argv', [name + '.py', '--quick'])
    return runpy.run_path(os.path.join(_REPO, 'examples', name + '.py'))


def test_sine_modelcomparison(monkeypatch, capsys):
    np.random.seed(1)
    ref = _run_jax_script('tutorial_sine_modelcomparison', monkeypatch)
    jax_out = capsys.readouterr().out
    np.random.seed(1)
    mine = _load('tutorial_sine_modelcomparison').main(quick=True,
                                                       device='cpu')
    _equal(mine['result1'], ref['result1'])
    _solve_equal(mine['result0'], ref['result0'])
    # simulations whose region radii split by one float32 ulp from the
    # reference's part ways (as the line model of test_linefit): held to
    # the larger logzerr of the two sine runs, ~0.3 at 100 live points
    np.testing.assert_allclose(mine['K_simulated'], ref['K_simulated'],
                               rtol=0, atol=0.3)
    # the same lines, in the same order (the simulations' to 2 decimals)
    out = capsys.readouterr().out
    mine_lines = [ln for ln in out.splitlines() if not ln.startswith('[')]
    ref_lines = [ln for ln in jax_out.splitlines()
                 if not ln.startswith('[')]
    assert len(mine_lines) == len(ref_lines)
    assert [ln for ln in mine_lines if 'sim ' not in ln
            and 'false-alarm' not in ln] == \
        [ln for ln in ref_lines if 'sim ' not in ln
         and 'false-alarm' not in ln]


def _first_rungs(monkeypatch, calibrator, n=2):
    """Stop *calibrator*'s ladder after *n* rungs: each later rung doubles
    nsteps and the cost of the run, and the ladder's length is
    stochastic."""
    run_iter = calibrator.ReactiveNestedCalibrator.run_iter
    monkeypatch.setattr(calibrator.ReactiveNestedCalibrator, 'run_iter',
                        lambda self, **kw: itertools.islice(
                            run_iter(self, **kw), n))


def test_sine_bayesian_workflow(monkeypatch, tmp_path):
    import ultranest_torch.calibrator
    import ultranest_tpu.calibrator
    _first_rungs(monkeypatch, ultranest_tpu.calibrator)
    _first_rungs(monkeypatch, ultranest_torch.calibrator)
    np.random.seed(1)
    ref = _run_jax_script('tutorial_sine_bayesian_workflow', monkeypatch)
    np.random.seed(1)
    mine = _load('tutorial_sine_bayesian_workflow').main(
        quick=True, outdir=str(tmp_path), device='cpu')
    _equal(mine['result'], ref['result'])
    assert mine['calib'].nsteps == ref['calib'].nsteps == [4, 8]
    # the rungs' slice chains part from the reference's at a radius one
    # float32 ulp apart (see the module docstring): held statistically
    for a, b in zip(mine['calib'].results, ref['calib'].results):
        assert abs(a['logz'] - b['logz']) < max(a['logzerr'], b['logzerr'])
        assert abs(a['niter'] - b['niter']) < 0.05 * b['niter']
    assert sorted(os.listdir(tmp_path)) == [
        'corner.png', 'posterior_predictive.png', 'prior_predictive.png']
