"""The port's stored runs and warm starts against the JAX package, on the CPU.

Mirrors ``tests/test_resume_similar.py`` and
``tests/test_run.py::test_read_file``. The run directories' formats are
the JAX package's, so the port reads what the JAX package wrote and the
other way round. Both host paths draw from the same seeded streams:

* ``read_file`` of a run directory written by either package gives the
  same logZ sequence in both packages, exactly with ``random=False`` and
  per numpy seed with ``random=True`` (its bootstrap draws come from
  numpy's global stream);
* ``resume='resume-similar'`` salvages a run the JAX package wrote: the
  rewritten point store is equal row for row, the runs that follow
  equal in ncall, niter and logZ, inside the reference test's gate
  (|logZ - log(2 pi 0.11^2)| < 1.5, fewer than 3x the first run's calls);
* ``warmstart_from_similar_file`` on the JAX package's
  ``weighted_post_untransformed.txt`` builds the reference's aux
  transform (to 1e-12) and a warm run equal to the reference's per seed;
  its ``.torch`` functions run the device path inside the same gate.
"""
import os
import shutil

import h5py
import numpy as np
import pytest
import torch

import ultranest_torch
import ultranest_tpu

CPU = 'cpu'
PACKAGES = {'tpu': (ultranest_tpu, {}), 'torch': (ultranest_torch,
                                                  dict(device=CPU))}
RUN = dict(min_num_live_points=100, viz_callback=False, show_status=False,
           max_num_improvement_loops=0, min_ess=0, dlogz=2.0,
           frac_remain=0.1)
LOGZ_B = np.log(2 * np.pi * 0.11 ** 2)


def loglike_a(theta):
    return -0.5 * (((theta - 0.5) / 0.1) ** 2).sum(axis=1)


def loglike_b(theta):
    # slightly different widths: a 'similar' likelihood
    return -0.5 * (((theta - 0.5) / 0.11) ** 2).sum(axis=1)


def torch_loglike_b(theta):
    return -0.5 * (((theta - 0.5) / 0.11) ** 2).sum(dim=1)


def transform(x):
    return np.asarray(x)


def _write_run(pkg, log_dir, seed):
    """A stored 2-d gauss run of *pkg* ('tpu' or 'torch') in *log_dir*."""
    mod, kw = PACKAGES[pkg]
    np.random.seed(seed)
    sampler = mod.ReactiveNestedSampler(
        ['a', 'b'], loglike_a, transform=transform, vectorized=True,
        log_dir=log_dir, resume=True, seed=seed, **kw)
    res = sampler.run(**RUN)
    sampler.pointstore.close()
    return sampler.logs['run_dir'], res


@pytest.fixture(scope='module')
def stored(tmp_path_factory):
    """Run directories written once per package: name -> (dir, results)."""
    root = tmp_path_factory.mktemp('runs')
    return {pkg: _write_run(pkg, str(root / pkg), seed=3)
            for pkg in PACKAGES}


@pytest.mark.parametrize('writer', sorted(PACKAGES))
@pytest.mark.parametrize('random', [False, True])
def test_read_file_equals_the_reference(stored, writer, random):
    run_dir, res = stored[writer]
    out = {}
    for pkg, (mod, _) in PACKAGES.items():
        np.random.seed(11)
        out[pkg] = mod.read_file(run_dir, 2, num_bootstraps=10,
                                 random=random)
    (seq_r, fin_r), (seq_p, fin_p) = out['tpu'], out['torch']
    assert seq_p['niter'] == seq_r['niter'] >= res['niter']
    for key in ('logz', 'logzerr', 'logvol', 'logwt', 'logl'):
        np.testing.assert_array_equal(np.asarray(seq_p[key]),
                                      np.asarray(seq_r[key]), err_msg=key)
    assert (fin_p['logz'], fin_p['logzerr']) == \
        (fin_r['logz'], fin_r['logzerr'])
    # the reference test's gate
    assert abs(fin_p['logz'] - res['logz']) < 0.5


def test_port_writes_the_reference_files(stored):
    run_dir, _ = stored['torch']
    for fn in ('chains/equal_weighted_post.txt', 'chains/weighted_post.txt',
               'chains/weighted_post_untransformed.txt', 'chains/run.txt',
               'info/results.json', 'info/post_summary.csv',
               'results/points.hdf5'):
        assert os.path.exists(os.path.join(run_dir, fn)), fn


def test_resume_refuses_changed_likelihood(stored, tmp_path):
    run_dir = shutil.copytree(stored['tpu'][0], str(tmp_path / 'run'))
    with pytest.raises(Exception, match='resume'):
        ultranest_torch.ReactiveNestedSampler(
            ['a', 'b'], loglike_b, transform=transform, vectorized=True,
            log_dir=run_dir, resume=True, seed=2, device=CPU)


def test_resume_similar_needs_a_tau(stored, tmp_path):
    """The reference's assertion: warmstart_max_tau in 0..1."""
    run_dir = shutil.copytree(stored['tpu'][0], str(tmp_path / 'run'))
    with pytest.raises(AssertionError, match='warmstart_max_tau'):
        ultranest_torch.ReactiveNestedSampler(
            ['a', 'b'], loglike_b, transform=transform, vectorized=True,
            log_dir=run_dir, resume='resume-similar', seed=2, device=CPU)


def test_resume_similar_equals_the_reference(stored, tmp_path):
    src, res1 = stored['tpu']
    out = {}
    for pkg, (mod, kw) in PACKAGES.items():
        run_dir = shutil.copytree(src, str(tmp_path / pkg))
        ncalls = {'n': 0}

        def counting_loglike_b(theta):
            ncalls['n'] += len(theta)
            return loglike_b(theta)

        np.random.seed(4)
        sampler = mod.ReactiveNestedSampler(
            ['a', 'b'], counting_loglike_b, transform=transform,
            vectorized=True, log_dir=run_dir, resume='resume-similar',
            warmstart_max_tau=0.3, seed=4, **kw)
        with h5py.File(os.path.join(run_dir, 'results', 'points.hdf5'),
                       'r') as f:
            salvaged = f['points'][:]
        res = sampler.run(**RUN)
        sampler.pointstore.close()
        out[pkg] = salvaged, res, ncalls['n']
    (pts_r, res_r, n_r), (pts_p, res_p, n_p) = out['tpu'], out['torch']
    np.testing.assert_array_equal(pts_p, pts_r)
    assert 0 < len(pts_p) < res1['ncall']
    assert (res_p['ncall'], res_p['niter'], n_p) == \
        (res_r['ncall'], res_r['niter'], n_r)
    assert res_p['logz'] == res_r['logz']
    # the reference test's gate: the salvage reuses the stored run
    assert n_p < 3 * res1['ncall'], (n_p, res1['ncall'])
    assert abs(res_p['logz'] - LOGZ_B) < 1.5, (res_p['logz'], LOGZ_B)


def _aux_run(mod, names, aux_ll, aux_tr, seed, **kw):
    np.random.seed(seed)
    sampler = mod.ReactiveNestedSampler(names, aux_ll, transform=aux_tr,
                                        vectorized=True, seed=seed, **kw)
    return sampler, sampler.run(**RUN)


def test_warmstart_from_similar_file_equals_the_reference(stored):
    usample_file = os.path.join(stored['tpu'][0], 'chains',
                                'weighted_post_untransformed.txt')
    aux, runs = {}, {}
    for pkg, (mod, kw) in PACKAGES.items():
        aux[pkg] = mod.warmstart_from_similar_file(
            usample_file, ['a', 'b'], loglike_b, transform, vectorized=True)
        assert aux[pkg][0] == ['a', 'b', 'aux_logweight'] and aux[pkg][3]
        runs[pkg] = _aux_run(mod, *aux[pkg][:3], seed=6, **kw)[1]
    u = np.random.RandomState(1).uniform(0.01, 0.99, size=(200, 3))
    np.testing.assert_allclose(aux['torch'][2](u), aux['tpu'][2](u),
                               rtol=1e-12, atol=0)
    ref, got = runs['tpu'], runs['torch']
    assert (got['ncall'], got['niter']) == (ref['ncall'], ref['niter'])
    assert got['logz'] == ref['logz']
    assert abs(got['logz'] - LOGZ_B) < 1.5, (got['logz'], LOGZ_B)


def test_warmstart_keeps_the_device_path(stored):
    """With torch_loglike, the warm-started run keeps the fused path."""
    usample_file = os.path.join(stored['torch'][0], 'chains',
                                'weighted_post_untransformed.txt')
    names, aux_ll, aux_tr, vec = ultranest_torch.warmstart_from_similar_file(
        usample_file, ['a', 'b'], loglike_b, transform, vectorized=True,
        torch_loglike=torch_loglike_b)
    assert aux_tr.torch is not None and aux_ll.torch is not None
    u = np.random.RandomState(2).uniform(0.05, 0.95, size=(64, 3))
    p = aux_tr.torch(torch.as_tensor(u, dtype=torch.float64))
    np.testing.assert_allclose(p.numpy(), aux_tr(u), rtol=1e-12, atol=1e-14)
    sampler, res = _aux_run(ultranest_torch, names, aux_ll, aux_tr, seed=7,
                            torch_loglike=aux_ll.torch,
                            torch_transform=aux_tr.torch, device=CPU)
    assert sampler.fused_sampler is not None
    assert abs(res['logz'] - LOGZ_B) < 1.5, (res['logz'], LOGZ_B)


def test_warmstart_missing_file_warns(tmp_path):
    for mod, _ in PACKAGES.values():
        with pytest.warns(UserWarning, match='not hot-resuming'):
            names, ll, tr, vec = mod.warmstart_from_similar_file(
                str(tmp_path / 'missing.txt'), ['a', 'b'], loglike_b,
                transform, vectorized=True)
        assert names == ['a', 'b'] and ll is loglike_b
