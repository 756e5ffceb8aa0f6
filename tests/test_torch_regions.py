"""The port's regions against the JAX package's, on the CPU.

Layers, the bootstrapped MLFriends radius and ellipsoid enlargement
(masks drawn from identically seeded RandomStates), membership,
clustering and the pairwise helpers, on the vendored eggbox region
(``tests/data/eggboxregion.txt``) and on random clouds. Geometry is held
to rtol 1e-6 in f64; masks, labels and counts must be equal.
"""
import os
import warnings

import numpy as np
import pytest

import ultranest_tpu.mlfriends as jml
import ultranest_tpu.ops.cluster as jcluster
import ultranest_tpu.ops.pairwise as jpw
import ultranest_torch.mlfriends as tml
import ultranest_torch.ops.cluster as tcluster
import ultranest_torch.ops.pairwise as tpw
from ultranest_torch.convert import reference_state, region_from_reference
from ultranest_torch.ops.bootstrap import bootstrap_radius_enlargement

DATA = os.path.join(os.path.dirname(__file__), 'data')
RTOL = 1e-6
CPU = 'cpu'


def _dev(mod):
    """The device keyword the port requires (the reference has none)."""
    return {} if mod is jml else dict(device=CPU)


def _cloud(kind):
    """(points, layer name) of a test point set."""
    if kind == 'eggbox':
        return np.loadtxt(os.path.join(DATA, 'eggboxregion.txt')), \
            'ScalingLayer'
    rng = np.random.RandomState(4)
    if kind == 'blobs':
        pts = np.concatenate([0.3 + 0.02 * rng.normal(size=(150, 3)),
                              0.7 + 0.03 * rng.normal(size=(150, 3))])
        return pts, 'LocalAffineLayer'
    cov = np.array([[1.0, 0.9], [0.9, 1.0]]) * 0.01
    return 0.5 + rng.multivariate_normal([0, 0], cov, size=400), \
        'AffineLayer'


def _regions(kind, nboot=30, seed=8):
    """Matching reference and port MLFriends regions, fully bootstrapped."""
    pts, layer_name = _cloud(kind)
    out = []
    for mod in (jml, tml):
        layer = getattr(mod, layer_name)()
        layer.optimize(pts, pts)
        region = mod.MLFriends(pts, layer, **_dev(mod))
        region.maxradiussq, region.enlarge = region.compute_enlargement(
            nbootstraps=nboot, rng=np.random.RandomState(seed))
        region.create_ellipsoid()
        out.append(region)
    return out


@pytest.mark.parametrize('layer_name', ['ScalingLayer', 'AffineLayer',
                                        'LocalAffineLayer'])
def test_layers_match(layer_name):
    pts, _ = _cloud('blobs')
    layers = []
    for mod in (jml, tml):
        layer = getattr(mod, layer_name)()
        layer.optimize(pts, pts)
        layers.append(layer.create_new(pts, 0.05 ** 2, **_dev(mod)))
    ref, port = layers
    assert ref.nclusters == port.nclusters
    np.testing.assert_array_equal(ref.clusterids, port.clusterids)
    for name in ('mean', 'std', 'ctr', 'T', 'invT', 'logvolscale'):
        if hasattr(ref, name):
            np.testing.assert_allclose(getattr(port, name),
                                       getattr(ref, name), rtol=RTOL)
    np.testing.assert_allclose(port.transform(pts), ref.transform(pts),
                               rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize('kind', ['eggbox', 'blobs', 'corr'])
def test_bootstrap_radius_and_enlargement_match(kind):
    ref, port = _regions(kind)
    np.testing.assert_allclose(port.maxradiussq, ref.maxradiussq, rtol=RTOL)
    np.testing.assert_allclose(port.enlarge, ref.enlarge, rtol=RTOL)
    for name in ('ellipsoid_center', 'ellipsoid_invcov', 'ellipsoid_axes_T',
                 'bbox_lo', 'bbox_hi', 'unormed'):
        np.testing.assert_allclose(getattr(port, name), getattr(ref, name),
                                   rtol=RTOL, atol=1e-12)
    r_ref = ref.compute_maxradiussq(nbootstraps=20,
                                    rng=np.random.RandomState(2))
    r_port = port.compute_maxradiussq(nbootstraps=20,
                                      rng=np.random.RandomState(2))
    np.testing.assert_allclose(r_port, r_ref, rtol=RTOL)
    if kind == 'eggbox':
        assert 1e-10 < r_port < 6e-10


@pytest.mark.parametrize('kind', ['eggbox', 'blobs', 'corr'])
def test_inside_and_converted_region_match(kind):
    ref, port = _regions(kind)
    rng = np.random.RandomState(6)
    d = ref.u.shape[1]
    # points near the live points (both sides of the radius) and uniform
    near = ref.u[rng.randint(len(ref.u), size=3000)] \
        + rng.normal(size=(3000, d)) * np.sqrt(ref.maxradiussq) \
        * np.std(ref.u, axis=0)
    pts = np.clip(np.concatenate([near, rng.uniform(size=(2000, d))]),
                  1e-9, 1 - 1e-9)
    want = ref.inside(pts)
    assert 0 < want.sum() < len(pts)
    np.testing.assert_array_equal(port.inside(pts), want)
    conv = region_from_reference(reference_state(ref), CPU)
    assert type(conv) is tml.MLFriends
    np.testing.assert_array_equal(conv.inside(pts), want)
    np.testing.assert_array_equal(conv.unormed, ref.unormed)
    assert conv.maxradiussq == ref.maxradiussq


@pytest.mark.parametrize('kind', ['eggbox', 'blobs'])
def test_update_clusters_match(kind):
    ref, _ = _regions(kind)
    u, t = ref.u, ref.unormed
    prev = np.ones(len(u), dtype=int)
    for r2 in (ref.maxradiussq, 4 * ref.maxradiussq):
        n_ref, ids_ref, over_ref = jml.update_clusters(u, t, r2, prev)
        n_port, ids_port, over_port = tml.update_clusters(u, t, r2, prev,
                                                          device=CPU)
        assert n_ref == n_port
        np.testing.assert_array_equal(ids_port, ids_ref)
        np.testing.assert_allclose(over_port, over_ref, rtol=RTOL)
    if kind == 'eggbox':
        assert 14 < n_port < 20


def test_wrapping_ellipsoid_and_other_regions_match():
    pts, _ = _cloud('corr')
    rng_seed = 3
    for name in ('RobustEllipsoidRegion', 'SimpleRegion'):
        out = []
        for mod in (jml, tml):
            layer = mod.ScalingLayer()
            layer.optimize(pts, pts)
            region = getattr(mod, name)(pts, layer, **_dev(mod))
            region.maxradiussq, region.enlarge = region.compute_enlargement(
                nbootstraps=30, rng=np.random.RandomState(rng_seed))
            region.create_ellipsoid()
            out.append(region)
        np.testing.assert_allclose(out[1].enlarge, out[0].enlarge,
                                   rtol=RTOL)
        np.testing.assert_array_equal(out[1].inside(pts), out[0].inside(pts))
    p = np.column_stack([pts, np.full(len(pts), 0.25)])
    wraps = []
    for mod in (jml, tml):
        w = mod.WrappingEllipsoid(p)
        w.enlarge = w.compute_enlargement(nbootstraps=30,
                                          rng=np.random.RandomState(1))
        w.create_ellipsoid()
        wraps.append(w)
    np.testing.assert_allclose(wraps[1].enlarge, wraps[0].enlarge, rtol=RTOL)
    q = p + np.random.RandomState(2).normal(size=p.shape) * 0.05
    q[::2, 2] = 0.25
    np.testing.assert_array_equal(wraps[1].inside(q), wraps[0].inside(q))


@pytest.mark.parametrize('n', [300, 1500])
def test_pairwise_helpers_match(n):
    """Host (small) and device-torch (large) routes both agree."""
    rng = np.random.RandomState(n)
    a = rng.uniform(size=(n, 2))
    b = rng.uniform(size=(n, 2))
    r2 = 2.0 / n
    assert tpw._small(n, n, 2) == (n == 300)
    np.testing.assert_allclose(tpw.compute_maxradiussq(a, b, device=CPU),
                               jpw.compute_maxradiussq(a, b), rtol=RTOL)
    np.testing.assert_array_equal(tpw.count_nearby(a, b, r2, device=CPU),
                                  jpw.count_nearby(a, b, r2))
    np.testing.assert_array_equal(tpw.find_nearby(a, b, r2, device=CPU),
                                  jpw.find_nearby(a, b, r2))
    # f32 neighbourhood means: the two matmuls sum in different orders,
    # a few ulp of the O(1) coordinates
    np.testing.assert_allclose(tpw.subtract_nearby(a, r2, device=CPU),
                               jpw.subtract_nearby(a, r2), rtol=1e-5,
                               atol=1e-6)
    ids = rng.randint(0, 4, size=n)
    np.testing.assert_array_equal(
        tpw.match_clusters(a, ids, b, r2, device=CPU),
        jpw.match_clusters(a, ids, b, r2))
    np.testing.assert_allclose(
        tpw.compute_mean_pair_distance(a, ids, device=CPU),
        jpw.compute_mean_pair_distance(a, ids), rtol=1e-5)
    np.testing.assert_array_equal(
        tcluster.connected_components(a, r2, device=CPU),
        jcluster.connected_components(a, r2))


@pytest.mark.parametrize('r2', [3.5e38, 1e300, np.inf, 2.0 ** 128 - 2.0 ** 104])
def test_match_clusters_takes_a_radius_beyond_float32_without_warning(r2):
    """A radius beyond float32's range (a SimpleRegion's, say) reaches
    every point on the device route as its float32 cast would, and
    raises no overflow warning; below the cast's rounding to infinity
    the threshold is float32's largest value, as the cast gives."""
    rng = np.random.RandomState(5)
    a, b = rng.uniform(size=(1500, 2)), rng.uniform(size=(1500, 2))
    ids = np.where(np.arange(1500) < 750, 1, 2)
    assert not tpw._small(1500, 1500, 2)
    with np.errstate(over='ignore'):
        cast = np.float32(r2)
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        got = tpw.match_clusters(a, ids, b, r2, device=CPU)
        assert tpw._f32_or_inf(r2) == cast
    # two clusters within reach of every point: each stays unassigned
    np.testing.assert_array_equal(got, np.zeros(1500, dtype=np.int64))


def test_large_problems_need_a_device():
    """Above the host threshold there is no implicit device to fall to."""
    a = np.random.RandomState(1).uniform(size=(1500, 2))
    assert not tpw._small(len(a), len(a), 2)
    with pytest.raises(ValueError):
        tpw.find_nearby(a, a, 1e-3, device=None)
    with pytest.raises(ValueError):
        tcluster.connected_components(a, 1e-3, device=None)
    with pytest.raises(ValueError):
        bootstrap_radius_enlargement(a, a, np.ones((2, len(a)), bool),
                                     mode='mlfriends')


def test_region_rebuilds_pass_the_sampler_device(monkeypatch):
    """With the host threshold at 0, every neighbour query, clustering
    and match of a run's region rebuilds goes through torch on the
    sampler's own device."""
    import ultranest_torch
    from ultranest_torch.models import problems
    monkeypatch.setattr(tpw, 'HOST_WORK_THRESHOLD', 0)
    seen = []
    to_torch = tpw._torch

    def spy(x, device, *dtype):
        seen.append(device)
        return to_torch(x, device, *dtype)
    monkeypatch.setattr(tpw, '_torch', spy)
    monkeypatch.setattr(tcluster, '_torch', spy)
    prob = problems.gauss(2)
    s = ultranest_torch.ReactiveNestedSampler(
        prob.param_names, prob.loglike, vectorized=True, seed=2,
        torch_loglike=prob.torch_loglike, device=CPU, ndraw_min=256,
        ndraw_max=1024)
    res = s.run(viz_callback=False, show_status=False,
                max_num_improvement_loops=0, min_ess=0,
                min_num_live_points=64, dlogz=2.0, frac_remain=0.5)
    assert np.isfinite(res['logz'])
    assert len(seen) > 10
    assert set(seen) == {s.device}
