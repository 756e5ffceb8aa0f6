"""The port's examples (``examples/torch_port/``) against the JAX
package's (``examples/``), on the CPU at their small sizes.

* Host paths (a numpy likelihood, regions built with ``device='cpu'``):
  the same numpy seed makes the same decisions in both packages, so
  ncall and niter are equal and logZ agrees within 1e-6 relative (the
  points can differ in the last bits of the regions' float32 sampling
  without changing a decision).
* ``--torch`` paths (the device walks and the region-rejection
  dispatch draw from torch's Philox streams, the JAX package from
  threefry): each run is held to its own gate, |logZ - truth| <
  max(4 logzerr, floor) with the floors of ``bench.py:353-372``, or the
  posterior mean within 4 standard deviations of the simulated truth.
* Every ``main`` defaults to the card, and importing an example loads
  no matplotlib.
"""
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest

from torch_port_helpers import REPO as _REPO
from torch_port_helpers import load_script, one_thread  # noqa: F401

EXAMPLES = ('testfeatures', 'run_problem', 'tutorial_highdim',
            'evaluate_scaling', 'tutorial_linefit', 'tutorial_outliers',
            'tutorial_intrinsic_distribution', 'tutorial_warmstart',
            'tutorial_sine_modelcomparison',
            'tutorial_sine_bayesian_workflow')


def _load(name, port=True):
    """The port's example *name* (or, with *port* false, the JAX
    package's)."""
    if port:
        return load_script('examples/torch_port/%s.py' % name,
                           'torch_port_' + name)
    return load_script('examples/%s.py' % name, 'jax_example_' + name)



@pytest.fixture
def jax_runs(monkeypatch):
    """Results of every ``ultranest_tpu.ReactiveNestedSampler.run`` call
    (the JAX examples print theirs without returning them)."""
    from ultranest_tpu import integrator
    out = []
    run = integrator.ReactiveNestedSampler.run

    def keep(self, *args, **kwargs):
        out.append(run(self, *args, **kwargs))
        return out[-1]

    monkeypatch.setattr(integrator.ReactiveNestedSampler, 'run', keep)
    return out


def _equal(mine, ref):
    assert (int(mine['ncall']), int(mine['niter'])) == \
        (int(ref['ncall']), int(ref['niter']))
    assert abs(mine['logz'] - ref['logz']) < 1e-6 * max(1.0, abs(ref['logz'])), \
        (mine['logz'], ref['logz'])


def _gate(res, truth, floor):
    assert abs(res['logz'] - truth) < max(4 * res['logzerr'], floor), \
        (res['logz'], res['logzerr'], truth)


def test_every_example_is_ported_and_defaults_to_the_card():
    jax_names = sorted(f[:-3] for f in os.listdir(os.path.join(
        _REPO, 'examples')) if f.endswith('.py'))
    assert sorted(EXAMPLES) == jax_names
    for name in EXAMPLES:
        module = _load(name)
        assert inspect.signature(module.main).parameters['device'].default \
            == 'cuda', name


def test_importing_the_examples_loads_no_matplotlib():
    code = ('import importlib.util, sys\n'
            'for n in %r:\n'
            '    s = importlib.util.spec_from_file_location(n, "%s/" + n + '
            '".py")\n'
            '    m = importlib.util.module_from_spec(s)\n'
            '    s.loader.exec_module(m)\n'
            'assert "matplotlib" not in sys.modules\n' % (
                EXAMPLES, os.path.join(_REPO, 'examples', 'torch_port')))
    subprocess.run([sys.executable, '-c', code], check=True, timeout=120)


@pytest.mark.parametrize('sampler', ['region', 'slice', 'popslice', 'poprw',
                                     'harm', 'simpleslice'])
def test_run_problem_host_samplers_equal_the_jax_example(sampler, jax_runs,
                                                         monkeypatch):
    # poprw with the default 2 * ndim steps leaves walkers unmoved, which
    # the reference's sampler refuses: it takes 16
    argv = ['--problem', 'gauss', '--x_dim', '2', '--num_live_points',
            '100', '--sampler', sampler, '--dlogz', '1.0', '--nsteps',
            '16' if sampler == 'poprw' else '0']
    monkeypatch.setattr(sys, 'argv', ['run_problem.py'] + argv)
    np.random.seed(7)
    _load('run_problem', port=False).main()
    np.random.seed(7)
    mine = _load('run_problem').main(argv, device='cpu')
    _equal(mine, jax_runs[-1])


@pytest.mark.parametrize('argv,truth,floor', [
    (['--problem', 'eggbox', '--torch', '--num_live_points', '100',
      '--frac_remain', '0.5'], 235.856, 1.0),
    (['--problem', 'gauss', '--x_dim', '4', '--torch', '--sampler',
      'fusedslice', '--num_live_points', '100'], 0.0, 1.5),
    (['--problem', 'gauss', '--x_dim', '4', '--torch', '--sampler',
      'fusedrw', '--num_live_points', '100'], 0.0, 1.5),
])
def test_run_problem_torch_paths_in_their_gates(argv, truth, floor):
    from ultranest_torch.ops import kernels
    kernels.reset_counts()
    res = _load('run_problem').main(argv + ['--device', 'cpu'])
    _gate(res, truth, floor)
    # on the CPU every wrapper runs its plain version and launches nothing
    assert sum(kernels.LAUNCHES.values()) == 0
    assert kernels.PLAIN_CALLS['bootstrap_radius'] > 0


def test_tutorial_highdim_host_equals_the_jax_example():
    np.random.seed(3)
    ref = _load('tutorial_highdim', port=False).main(fast=True)
    np.random.seed(3)
    mine = _load('tutorial_highdim').main(fast=True, device='cpu')
    _equal(mine, ref)


def test_tutorial_highdim_torch_walk_finds_the_period():
    res = _load('tutorial_highdim').main(fast=True, use_torch=True,
                                         device='cpu')
    i = res['paramnames'].index('period')
    mean, std = res['posterior']['mean'][i], res['posterior']['stdev'][i]
    assert abs(mean - 7.0) < 4 * std, (mean, std)


def test_evaluate_scaling_rows():
    ref = _load('evaluate_scaling', port=False)
    mine = _load('evaluate_scaling')
    for method in ('mlfriends', 'slice'):
        np.random.seed(1)
        a = ref.run_one(method, 2)
        np.random.seed(1)
        b = mine.run_one(method, 2, device='cpu')
        assert sorted(a) == sorted(b)
        _equal(b, a)
    row = mine.run_one('popslice', 4, device='cpu')
    _gate(row, 0.0, 1.5)


def test_evaluate_scaling_main_writes_its_rows(tmp_path, capsys):
    out = tmp_path / 'rows.json'
    rows = _load('evaluate_scaling').main(
        ['--dims', '2', '--methods', 'popslice', '--json', str(out)],
        device='cpu')
    assert len(rows) == 1 and out.exists()
    assert 'popslice' in capsys.readouterr().out
