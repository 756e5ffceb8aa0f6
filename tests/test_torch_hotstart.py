"""The port's warm-start module against the JAX package, on the CPU.

Mirrors the hotstart and reuse_samples cases of
``tests/test_aux_modules.py``, ``tests/test_reference_parity2.py:89-160``
and ``tests/test_coverage_gaps.py::test_hotstart_gaussian_family``, with
the same inputs (made from a seed with numpy) through ``ultranest_tpu.
hotstart`` and ``ultranest_torch.hotstart``:

* the host closures are copies: quantile envelopes equal, refined ones
  and the contbox transforms within rtol 1e-12 (in fact equal);
* the ``.torch`` contbox functions against the reference's ``.jax``
  functions on the same float32 inputs, within 1e-6 (XLA on the CPU
  fuses ``a + b * c`` into one rounding, the port rounds twice), and
  against the float64 host closures within the reference test's own
  tolerances (``test_aux_modules.py:102-104``: 1e-4 and 5e-2);
* ``interp`` against ``jnp.interp`` at the knots, below the first, above
  the last and at t = 0 and 1, within 1e-6;
* ``reuse_samples`` per numpy seed (its equal-weight resampling draws
  from the global stream): equal on the host, within 1e-5 in logZ with
  the float32 ``torch_loglike``;
* seeded warm runs equal to the reference's in ncall, niter and logZ,
  and inside the reference tests' gates.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ultranest_torch
import ultranest_tpu
from ultranest_torch import hotstart as thot
from ultranest_tpu import hotstart as jhot

CPU = 'cpu'


def _quantile_inputs():
    rng = np.random.RandomState(2)
    upoints = rng.normal(0.5, 0.05, size=(500, 3)).clip(1e-3, 1 - 1e-3)
    uweights = rng.uniform(size=500)
    uweights /= uweights.sum()
    steps = 10.0 ** -(1.0 * np.arange(1, 8, 2))
    return steps, upoints, uweights


def test_quantile_intervals_equal_the_reference():
    steps, upoints, uweights = _quantile_inputs()
    for a, b in zip(jhot.compute_quantile_intervals(steps, upoints, uweights),
                    thot.compute_quantile_intervals(steps, upoints,
                                                    uweights)):
        np.testing.assert_array_equal(b, a)
    for a, b in zip(
            jhot.compute_quantile_intervals_refined(steps, upoints, uweights),
            thot.compute_quantile_intervals_refined(steps, upoints,
                                                    uweights)):
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=0)


def loglike(x):
    return -0.5 * (((x - 0.5) / 0.02) ** 2).sum(axis=-1)


def jax_loglike(x):
    return -0.5 * jnp.sum(((x - 0.5) / 0.02) ** 2, axis=1)


def torch_loglike(x):
    return -0.5 * (((x - 0.5) / 0.02) ** 2).sum(dim=1)


def _contbox(mod, vectorized=True, **kw):
    rng = np.random.RandomState(3)
    upoints = rng.normal(0.5, 0.02, size=(400, 2)).clip(1e-3, 1 - 1e-3)
    uweights = np.ones(400) / 400
    return mod.get_auxiliary_contbox_parameterization(
        ['a', 'b'], loglike, lambda x: x, upoints, uweights,
        vectorized=vectorized, **kw)


@pytest.mark.parametrize('vectorized', [True, False])
def test_contbox_equals_the_reference(vectorized):
    ref, got = _contbox(jhot, vectorized), _contbox(thot, vectorized)
    assert got[0] == ref[0] == ['a', 'b', 'aux_logweight']
    assert got[3] == ref[3] == vectorized
    u = np.random.RandomState(4).uniform(0.05, 0.95, size=(100, 3))
    u[:4, -1] = [0.0, 1.0, 0.25, 0.75]
    if vectorized:
        p_ref, p_got = ref[2](u), got[2](u)
        L_ref, L_got = ref[1](p_ref), got[1](p_got)
    else:
        p_ref = np.array([ref[2](ui) for ui in u])
        p_got = np.array([got[2](ui) for ui in u])
        L_ref = np.array([ref[1](pi) for pi in p_ref])
        L_got = np.array([got[1](pi) for pi in p_got])
    np.testing.assert_allclose(p_got, p_ref, rtol=1e-12, atol=0)
    np.testing.assert_allclose(L_got, L_ref, rtol=1e-12, atol=0)
    # the box compresses the prior; at t = 1 the deformation vanishes
    assert (p_got[:, -1] <= 0).all()
    np.testing.assert_allclose(p_got[1, :2], u[1, :2], atol=1e-12)
    np.testing.assert_allclose(p_got[1, -1], 0, atol=1e-12)


def test_contbox_torch_functions_equal_the_jax_functions():
    ref = _contbox(jhot, jax_loglike=jax_loglike)
    got = _contbox(thot, torch_loglike=torch_loglike)
    u = np.random.RandomState(5).uniform(0.05, 0.95, size=(64, 3))
    u[:4, -1] = [0.0, 1.0, 0.25, 0.75]
    u32 = u.astype(np.float32)
    p_jax = np.asarray(ref[2].jax(jnp.asarray(u32)))
    p_t = got[2].torch(torch.as_tensor(u32)).numpy()
    assert p_t.dtype == np.float32
    np.testing.assert_allclose(p_t, p_jax, rtol=0, atol=1e-6)
    L_jax = np.asarray(ref[1].jax(jnp.asarray(p_jax)))
    L_t = got[1].torch(torch.as_tensor(p_jax)).numpy()
    np.testing.assert_allclose(L_t, L_jax, rtol=1e-6, atol=0)
    # against the float64 host closures: the reference test's tolerances
    np.testing.assert_allclose(p_t, got[2](u), atol=1e-4)
    np.testing.assert_allclose(L_t, got[1](got[2](u)), atol=5e-2)


@pytest.mark.parametrize('where', ['knots', 'below', 'above', 'ends',
                                   'inside'])
def test_interp_equals_jnp_interp(where):
    rng = np.random.RandomState(6)
    xp = np.concatenate([[0.0], np.sort(rng.uniform(size=10)), [1.0]])
    fp = rng.normal(size=(12, 3))
    x = {'knots': xp, 'below': np.array([-1.0, -1e-7, -0.5]),
         'above': np.array([1.0 + 1e-6, 2.0, 7.5]),
         'ends': np.array([0.0, 1.0]),
         'inside': rng.uniform(size=200)}[where]
    x32, xp32, fp32 = (a.astype(np.float32) for a in (x, xp, fp))
    want = np.stack([np.asarray(jnp.interp(x32, xp32, fp32[:, k]))
                     for k in range(3)], axis=1)
    got = thot.interp(torch.as_tensor(x32), torch.as_tensor(xp32),
                      torch.as_tensor(fp32))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        thot.interp(torch.as_tensor(x), torch.as_tensor(xp),
                    torch.as_tensor(fp[:, 0])).numpy(),
        np.interp(x, xp, fp[:, 0]), rtol=1e-12, atol=1e-15)


def test_gaussian_family_equals_the_reference():
    def host_loglike(theta):
        return float(-0.5 * (((theta - 5.0) / 0.5) ** 2).sum())

    def host_transform(u):
        return u * 10.0

    ctr = np.array([0.5, 0.5])
    invcov = np.linalg.inv(np.diag([0.05, 0.05]) ** 2)
    us = np.random.RandomState(7).uniform(0.05, 0.95, size=(20, 2))
    us[0] = 0.5
    for name, args, kw in (
            ('get_auxiliary_problem', (ctr, invcov), dict(
                enlargement_factor=3.0)),
            ('get_extended_auxiliary_problem', (ctr, invcov), dict(
                enlargement_factor=3.0)),
            ('get_extended_auxiliary_independent_problem',
             (ctr, np.array([0.05, 0.05])), dict(df=10))):
        ref_ll, ref_tr = getattr(jhot, name)(host_loglike, host_transform,
                                             *args, **kw)
        ll, tr = getattr(thot, name)(host_loglike, host_transform, *args,
                                     **kw)
        for u in us:
            np.testing.assert_allclose(tr(u), ref_tr(u), rtol=1e-12, atol=0)
            assert ll(u) == ref_ll(u) and np.isfinite(ll(u))
    # the mapped cube centre is the posterior centre itself
    out = tr(us[0])
    assert out.shape == (3,) and abs(out[0] - 5.0) < 1.0


@pytest.mark.parametrize('kind', ['host', 'torch'])
def test_reuse_samples_equals_the_reference(kind):
    rng = np.random.RandomState(8)
    points = rng.normal(0.5, 0.1, size=(500, 2))
    logl = -0.5 * (((points - 0.5) / 0.1) ** 2).sum(axis=1)

    def loglike2(theta):
        return -0.5 * (((theta - 0.5) / 0.1) ** 2).sum(axis=1)

    if kind == 'host':
        kw_ref = kw = dict(vectorized=True)
        fn = loglike2
    else:
        kw_ref = dict(jax_loglike=lambda t: -0.5 * jnp.sum(
            ((t - 0.5) / 0.1) ** 2, axis=1))
        kw = dict(torch_loglike=lambda t: -0.5 * (((t - 0.5) / 0.1) ** 2)
                  .sum(dim=1), device=CPU)
        fn = None
    np.random.seed(9)
    ref = jhot.reuse_samples(['a', 'b'], fn, points, logl, **kw_ref)
    np.random.seed(9)
    got = thot.reuse_samples(['a', 'b'], fn, points, logl, **kw)
    tol = 0 if kind == 'host' else 1e-5
    assert got['ncall'] == ref['ncall']
    np.testing.assert_allclose(got['logz'], ref['logz'], rtol=0, atol=tol)
    np.testing.assert_allclose(got['ess'], ref['ess'], rtol=tol)
    if kind == 'host':
        np.testing.assert_array_equal(got['samples'], ref['samples'])
    assert np.isfinite(got['logz']) and got['ess'] > 10
    np.testing.assert_allclose(got['posterior']['mean'], [0.5, 0.5],
                               atol=0.05)


def _narrow_contbox(mod, **kw):
    def ll(theta):
        return -0.5 * (((theta - 0.5) / 0.01) ** 2).sum(axis=1)

    rng = np.random.RandomState(1)
    upoints = np.clip(rng.normal(0.5, 0.01, size=(1000, 2)), 1e-3, 1 - 1e-3)
    uweights = np.ones(len(upoints)) / len(upoints)
    return mod.get_auxiliary_contbox_parameterization(
        ['a', 'b'], ll, lambda x: x, upoints, uweights, vectorized=True,
        **kw)


def test_warm_run_equals_the_reference():
    """``test_aux_modules.py::test_hotstart_run_accelerates``, per seed."""
    out = {}
    for name, mod, kw in (('tpu', ultranest_tpu, {}),
                          ('torch', ultranest_torch, dict(device=CPU))):
        names, aux_ll, aux_tr, _ = _narrow_contbox(mod.hotstart
                                                   if name == 'tpu' else thot)
        np.random.seed(2)
        sampler = mod.ReactiveNestedSampler(names, aux_ll, transform=aux_tr,
                                            vectorized=True, seed=2, **kw)
        out[name] = sampler.run(min_num_live_points=50, viz_callback=False,
                                show_status=False, max_num_improvement_loops=0,
                                min_ess=0, dlogz=2.0, frac_remain=0.1)
    ref, got = out['tpu'], out['torch']
    assert (got['ncall'], got['niter'], got['logz']) == \
        (ref['ncall'], ref['niter'], ref['logz'])
    assert abs(got['logz'] - np.log(2 * np.pi * 0.01 ** 2)) < 1.5
    assert got['niter'] < 600


def test_warm_run_keeps_the_device_path():
    """``test_aux_modules.py::test_hotstart_contbox_keeps_jax_path``."""
    names, aux_ll, aux_tr, _ = _narrow_contbox(
        thot, torch_loglike=lambda t: -0.5 * (((t - 0.5) / 0.01) ** 2)
        .sum(dim=1))
    sampler = ultranest_torch.ReactiveNestedSampler(
        names, aux_ll, transform=aux_tr, vectorized=True, seed=2,
        torch_loglike=aux_ll.torch, torch_transform=aux_tr.torch, device=CPU)
    assert sampler.fused_sampler is not None
    res = sampler.run(min_num_live_points=50, viz_callback=False,
                      show_status=False, max_num_improvement_loops=0,
                      min_ess=0, dlogz=2.0, frac_remain=0.1)
    assert abs(res['logz'] - np.log(2 * np.pi * 0.01 ** 2)) < 1.5
    assert res['niter'] < 600


def test_solvecompat_equals_the_reference():
    from ultranest_torch.solvecompat import pymultinest_solve_compat as tsol
    from ultranest_tpu.solvecompat import pymultinest_solve_compat as jsol

    def host_loglike(theta):
        return -0.5 * (((theta - 0.5) / 0.1) ** 2).sum()

    kw = dict(n_live_points=50, verbose=False, frac_remain=0.5,
              evidence_tolerance=2.0, seed=3)
    ref = jsol(host_loglike, lambda c: c, 2, **kw)
    got = tsol(host_loglike, lambda c: c, 2, device=CPU, **kw)
    assert got['logZ'] == ref['logZ'] and got['logZerr'] == ref['logZerr']
    np.testing.assert_array_equal(got['samples'], ref['samples'])
    assert abs(got['logZ'] - np.log(2 * np.pi * 0.1 ** 2)) < 2.0
