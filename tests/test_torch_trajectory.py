"""The port's trajectory samplers against the JAX package, on the CPU.

Mirrors ``tests/test_trajectory.py``. ``samplingpath``, ``flatnuts`` and
``pathsampler`` are numpy on the host in both packages, drawing from
numpy's global stream in the same order, so the same seeded inputs give
equal outputs: geometry bit for bit, clocked walks and step-sampler runs
equal per seed. The regions they walk in are each package's own (the
port's built with ``device='cpu'``). The gradients come from
``torch.autograd`` in the port and ``jax.grad`` in the reference, both in
float32 on the same inputs: within 1e-6 of each other and of the
analytic gradient, and the HMC samplers' steps fed each package's own
gradient equal per seed in their counts and within 1e-6 in the point
(the reflections inherit the gradients' float32 rounding).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ultranest_torch
import ultranest_tpu
from ultranest_torch import dychmc as tdc
from ultranest_torch import dyhmc as tdh
from ultranest_torch import flatnuts as tfn
from ultranest_torch import mlfriends as tml
from ultranest_torch import samplingpath as tsp
from ultranest_tpu import dychmc as jdc
from ultranest_tpu import dyhmc as jdh
from ultranest_tpu import flatnuts as jfn
from ultranest_tpu import mlfriends as jml
from ultranest_tpu import samplingpath as jsp

CPU = 'cpu'


def loglike(p):
    return -0.5 * (((p - 0.5) / 0.1) ** 2).sum(axis=1)


def jax_loglike(p):
    return -0.5 * jnp.sum(((p - 0.5) / 0.1) ** 2, axis=1)


def torch_loglike(p):
    return -0.5 * (((p - 0.5) / 0.1) ** 2).sum(dim=1)


def test_port_has_the_reference_names():
    for j, t in ((jsp, tsp), (jfn, tfn), (jdc, tdc), (jdh, tdh)):
        names = [n.replace('jax', 'torch') for n in
                 getattr(j, '__all__', [n for n in dir(j)
                                        if not n.startswith('_')])]
        for name in names:
            assert hasattr(t, name), (t.__name__, name)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_geometry_equals_the_reference(seed):
    rng = np.random.RandomState(seed)
    x = rng.uniform(0.1, 0.9, size=3)
    v = rng.normal(size=3)
    v *= 0.2 / np.linalg.norm(v)
    t = rng.uniform(0, 10)
    for name, args in (
            ('linear_steps_with_reflection', (x, v, t)),
            ('box_line_intersection', (x, v)),
            ('nearest_box_intersection_line', (x, v)),
            ('reflect', (v, x / np.linalg.norm(x))),
            ('get_sphere_tangent', (x, v)),
            ('angle', (x, v)),
            ('distances', (v / np.linalg.norm(v), x - 0.5))):
        a = getattr(jsp, name)(*args)
        b = getattr(tsp, name)(*args)
        np.testing.assert_equal(b, a, err_msg=name)
    path = {}
    for mod in (jsp, tsp):
        p = mod.SamplingPath(x, v, 1.0)
        p.add(2, x + 2 * v, v, 2.0)
        path[mod] = [p.interpolate(1), p.extrapolate(3), p.extrapolate(-2)]
    np.testing.assert_equal(path[tsp], path[jsp])


def _make_region(ml, npts=100, ndim=2, seed=0, **kw):
    rng = np.random.RandomState(seed)
    u = rng.uniform(0.3, 0.7, size=(npts, ndim))
    tl = ml.AffineLayer()
    tl.optimize(u, u)
    region = ml.MLFriends(u, tl, **kw)
    region.maxradiussq, region.enlarge = region.compute_enlargement(
        nbootstraps=10, rng=np.random.RandomState(seed))
    region.create_ellipsoid()
    return region


def _regions(**kw):
    return (_make_region(jml, **kw),
            _make_region(tml, device=torch.device(CPU), **kw))


def test_contour_gradient_equals_the_reference():
    normals = []
    for sp, region in zip((jsp, tsp), _regions()):
        path = sp.ContourSamplingPath(
            sp.SamplingPath(np.array([0.5, 0.5]), np.array([0.01, 0.0]), 1.0),
            region)
        normals.append(path.gradient(np.array([0.9, 0.9])))
    np.testing.assert_array_equal(normals[1], normals[0])
    assert np.isclose(np.linalg.norm(normals[1]), 1)
    assert normals[1][0] < 0 and normals[1][1] < 0


@pytest.mark.parametrize('clocked', ['ClockedStepSampler',
                                     'ClockedBisectSampler',
                                     'ClockedNUTSSampler'])
def test_clocked_walk_equals_the_reference(clocked):
    runs = []
    for sp, fn, region in zip((jsp, tsp), (jfn, tfn), _regions(npts=200)):
        np.random.seed(2)
        Lmin = -2.0
        ui = np.array([0.55, 0.48])
        Li = loglike(ui.reshape((1, -1)))[0]
        cp = sp.ContourSamplingPath(
            sp.SamplingPath(ui, np.array([0.04, 0.01]), Li), region)
        sampler = getattr(fn, clocked)(cp)
        stepper = fn.DirectJumper(sampler, nsteps=5)
        stepper.prepare_jump()
        Llast, trace = None, []
        for _ in range(200):
            if sampler.is_done():
                break
            u, is_independent = sampler.next(Llast)
            trace.append((None if u is None else u.copy(), is_independent))
            Llast = None
            if u is not None and not is_independent:
                L = loglike(u.reshape((1, -1)))[0]
                if L > Lmin:
                    Llast = L
        runs.append((trace, stepper.make_jump()))
    (ta, (ua, La)), (tb, (ub, Lb)) = runs
    assert len(ta) == len(tb) > 0
    for a, b in zip(ta, tb):
        np.testing.assert_array_equal(b[0], a[0])
        assert a[1] == b[1]
    np.testing.assert_array_equal(ub, ua)
    assert La == Lb and np.isfinite(ub).all() and Lb > -2.0


@pytest.mark.parametrize('transformed', [False, True])
def test_gradients_equal_the_reference(transformed):
    jt = (lambda u: u * 2.0 - 0.5) if transformed else None
    tt = (lambda u: u * 2.0 - 0.5) if transformed else None
    us = np.random.RandomState(3).uniform(0.2, 0.8, size=(10, 2))
    g_ref = jdc.gradient_from_jax(jax_loglike, jt)
    g_port = tdc.gradient_from_torch(torch_loglike, tt, device=CPU)
    f_ref = jdh.transform_loglike_gradient_from_jax(jax_loglike, jt)
    f_port = tdh.transform_loglike_gradient_from_torch(torch_loglike, tt,
                                                       device=CPU)
    for u in us:
        p = u * 2.0 - 0.5 if transformed else u
        # analytic: dL/du = -(p - 0.5) / 0.01 * dp/du
        g = -(p - 0.5) / 0.01 * (2.0 if transformed else 1.0)
        np.testing.assert_allclose(g_port(u), g / np.linalg.norm(g),
                                   atol=1e-6)
        np.testing.assert_allclose(g_port(u), g_ref(u), atol=1e-6)
        (p_a, L_a, d_a), (p_b, L_b, d_b) = f_ref(u), f_port(u)
        np.testing.assert_allclose(p_b, p_a, atol=1e-6)
        np.testing.assert_allclose(L_b, L_a, rtol=1e-6)
        np.testing.assert_allclose(d_b, d_a, rtol=1e-5)
        np.testing.assert_allclose(d_b, g, rtol=1e-5)


def test_dychmc_step_equals_the_reference():
    out = []
    for dc, region, grad in zip(
            (jdc, tdc), _regions(npts=200, seed=4),
            (jdc.gradient_from_jax(jax_loglike),
             tdc.gradient_from_torch(torch_loglike, device=CPU))):
        np.random.seed(3)
        sampler = dc.DynamicCHMCSampler(scale=0.05, nsteps=4)
        sampler.set_gradient(grad)
        us = region.u
        Ls = loglike(us)
        Lmin = np.percentile(Ls, 20)
        ok = Ls > Lmin
        out.append(sampler.__next__(region, Lmin, us[ok], Ls[ok],
                                    lambda u: u, loglike))
    (ua, pa, La, na), (ub, pb, Lb, nb) = out
    # the float32 gradients differ in their last bits, the reflections
    # by as much
    assert nb == na > 0
    np.testing.assert_allclose(ub, ua, rtol=0, atol=1e-6)
    np.testing.assert_allclose(Lb, La, rtol=1e-6)
    assert (ub > 0).all() and (ub < 1).all()


def test_dyhmc_step_equals_the_reference():
    out = []
    for dh, region, tlg in zip(
            (jdh, tdh), _regions(npts=200, seed=6),
            (jdh.transform_loglike_gradient_from_jax(jax_loglike),
             tdh.transform_loglike_gradient_from_torch(torch_loglike,
                                                       device=CPU))):
        np.random.seed(5)
        p, L, g = tlg(np.array([0.6, 0.5]))
        assert np.isclose(L, loglike(np.array([[0.6, 0.5]]))[0], atol=1e-4)
        sampler = dh.DynamicHMCSampler(ndim=2, nsteps=3,
                                       transform_loglike_gradient=tlg)
        us = region.u
        Ls = loglike(us)
        Lmin = np.percentile(Ls, 20)
        out.append(sampler.__next__(region, Lmin, us, Ls, lambda u: u,
                                    loglike))
    (ua, pa, La, na), (ub, pb, Lb, nb) = out
    assert nb == na > 0
    np.testing.assert_allclose(ub, ua, rtol=0, atol=1e-6)
    assert (ub > 0).all() and (ub < 1).all()


def test_pathsampler_run_equals_the_reference():
    from ultranest_torch.pathsampler import SamplingPathStepSampler as TS
    from ultranest_tpu.pathsampler import SamplingPathStepSampler as JS
    out = []
    for mod, cls, kw in ((ultranest_tpu, JS, {}),
                         (ultranest_torch, TS, dict(device=CPU))):
        np.random.seed(7)
        sampler = mod.ReactiveNestedSampler(['a', 'b'], loglike,
                                            transform=lambda x: x,
                                            vectorized=True, seed=7, **kw)
        sampler.stepsampler = cls(nresets=3, nsteps=5)
        out.append(sampler.run(min_num_live_points=50, viz_callback=False,
                               show_status=False, max_num_improvement_loops=0,
                               min_ess=0, dlogz=2.0, frac_remain=0.5,
                               max_ncalls=20000))
    ref, got = out
    assert (got['ncall'], got['niter'], got['logz']) == \
        (ref['ncall'], ref['niter'], ref['logz'])
    assert abs(got['logz'] - np.log(2 * np.pi * 0.1 ** 2)) < 2.5
