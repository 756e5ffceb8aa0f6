"""The port's language runners (``languages/*/*_torch.py``) on the CPU.

Each library is built from the sources in ``languages/`` into the test's
own directory (C and C++ always where a compiler exists; Fortran only
with gfortran) and loaded through the runner's ``load(path)``. The
ctypes wrappers are held against a numpy version of the same
likelihood (rtol 1e-12: the same float64 arithmetic in another order),
then a small sampler runs on them and must land within 1.0 of the
analytic logZ (the gate of ``tests/test_languages.py``). The Julia and
R runners need Julia or R, which are not installed where the port is
tested: they are not run.
"""
import os
import shutil
import subprocess

import numpy as np
import pytest

from torch_port_helpers import REPO, load_script, one_thread  # noqa: F401

LANGDIR = os.path.join(REPO, 'languages')
RUN = dict(min_num_live_points=100, viz_callback=False, show_status=False,
           max_num_improvement_loops=0, min_ess=0, dlogz=2.0,
           frac_remain=0.1)




def _runner(lang, name):
    return load_script('languages/%s/%s.py' % (lang, name),
                       'torch_runner_' + name)


def _build(compiler, src, out, extra=()):
    subprocess.run([compiler, '-O2', '-fPIC', '-shared', '-o', str(out),
                    os.path.join(LANGDIR, src)] + list(extra), check=True,
                   capture_output=True, text=True, timeout=120)
    return str(out)


def _centered_gauss(p):
    centers = 0.4 + 0.1 * np.arange(p.shape[1]) - 0.5
    return -0.5 * (((p - centers) / 0.1) ** 2).sum(axis=1) \
        - 0.5 * p.shape[1] * np.log(2 * np.pi * 0.1 ** 2)


def _shell(p):
    r = np.sqrt(((p - 0.5) ** 2).sum(axis=1))
    return -0.5 * ((r - 0.4) / 0.02) ** 2 - 0.5 * np.log(2 * np.pi * 0.02**2)


SHELL_LOGZ = np.log(4 * np.pi * (0.4 ** 2 + 0.02 ** 2))


def _fortran_gauss(p):
    return -0.5 * (((p - 0.5) / 0.1) ** 2).sum(axis=1) \
        - 0.5 * p.shape[1] * np.log(2 * np.pi * 0.1 ** 2)


@pytest.fixture(scope='module')
def clib(tmp_path_factory):
    if shutil.which('gcc') is None:
        pytest.skip('no C compiler')
    return _build('gcc', 'c/mylib.c',
                  tmp_path_factory.mktemp('c') / 'mylib.so', ['-lm'])


@pytest.fixture(scope='module')
def cpplib(tmp_path_factory):
    if shutil.which('g++') is None:
        pytest.skip('no C++ compiler')
    return _build('g++', 'c++/mycpplib.cpp',
                  tmp_path_factory.mktemp('cpp') / 'mycpplib.so')


def test_c_wrappers_match_numpy(clib):
    transform, loglike = _runner('c', 'runc_torch').load(clib)
    u = np.random.RandomState(0).uniform(size=(10, 3))
    p = transform(u)
    np.testing.assert_allclose(p, u * 2 - 1, rtol=1e-12)
    np.testing.assert_allclose(loglike(p), _centered_gauss(p), rtol=1e-12)
    transform1, loglike1 = _runner('c', 'runcsimple_torch').load(clib)
    np.testing.assert_allclose(transform1(u[0]), p[0], rtol=1e-12)
    np.testing.assert_allclose(loglike1(p[0]), _centered_gauss(p[:1])[0],
                               rtol=1e-12)


def test_c_runner_samples(clib):
    res = _runner('c', 'runc_torch').main(clib, device='cpu', **RUN)
    assert abs(res['logz'] + np.log(8)) < 1.0, res['logz']


def test_c_scalar_runner_samples(clib, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    res = _runner('c', 'runcsimple_torch').main(clib, device='cpu',
                                                plot=False, **RUN)
    assert abs(res['logz'] + np.log(8)) < 1.0, res['logz']


def test_cpp_wrappers_match_numpy(cpplib):
    p = np.random.RandomState(1).uniform(size=(10, 3))
    loglike = _runner('c++', 'runcpp_torch').load(cpplib)
    np.testing.assert_allclose(loglike(p), _shell(p), rtol=1e-12)
    loglike1 = _runner('c++', 'runcppsimple_torch').load(cpplib)
    np.testing.assert_allclose(loglike1(p[0]), _shell(p[:1])[0],
                               rtol=1e-12)


def test_cpp_runner_samples(cpplib):
    res = _runner('c++', 'runcpp_torch').main(cpplib, device='cpu', **RUN)
    assert abs(res['logz'] - SHELL_LOGZ) < 1.0, res['logz']


def test_fortran_runner_samples(tmp_path):
    if shutil.which('gfortran') is None:
        pytest.skip('no gfortran')
    lib = _build('gfortran', 'fortran/myfortlib.f90',
                 tmp_path / 'myfortlib.so')
    runner = _runner('fortran', 'runfort_torch')
    p = np.random.RandomState(2).uniform(size=(10, 3))
    np.testing.assert_allclose(runner.load(lib)(p), _fortran_gauss(p),
                               rtol=1e-12)
    res = runner.main(lib, device='cpu', **RUN)
    assert abs(res['logz']) < 1.0, res['logz']


def test_python_runner_samples():
    res = _runner('python', 'runpy_torch').main(device='cpu', **RUN)
    # unnormalised gaussian, sigma 0.1 in 3-d: logZ = 1.5 log(2 pi 0.01)
    assert abs(res['logz'] - 1.5 * np.log(2 * np.pi * 0.01)) < 1.0


def test_runners_default_to_the_library_beside_them():
    """``load()`` without a path opens the ``.so`` next to the runner (as
    the originals do); every runner's ``main`` defaults to the card."""
    import inspect
    for lang, name, lib in (('c', 'runc_torch', 'mylib.so'),
                            ('c', 'runcsimple_torch', 'mylib.so'),
                            ('c++', 'runcpp_torch', 'mycpplib.so'),
                            ('c++', 'runcppsimple_torch', 'mycpplib.so'),
                            ('fortran', 'runfort_torch', 'myfortlib.so')):
        runner = _runner(lang, name)
        default = inspect.signature(runner.load).parameters['path'].default
        assert default == os.path.join(os.path.dirname(os.path.abspath(
            os.path.join(LANGDIR, lang, name + '.py'))), lib)
        assert inspect.signature(runner.main).parameters['device'].default \
            == 'cuda'
    assert inspect.signature(_runner('python', 'runpy_torch').main) \
        .parameters['device'].default == 'cuda'
