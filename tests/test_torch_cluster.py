"""The port's device label propagation against the JAX package, on the CPU.

``ultranest_torch.ops.cluster.label_propagation_components`` (pointer
jumping, its loop condition read from the device) must give the labels
of the reference's ``label_propagation_components`` and of
``connected_components`` (the smallest member index of each component)
exactly: on the random geometries of ``tests/test_region.py:255-270``, on
the golden sets of ``tests/test_clustering_golden.py`` (their mode
counts too) and on the vendored datasets of ``tests/data/`` at their
MLFriends radii.

Kernel K8's plain version (``kernels.radius_graph_plain``), which builds
the cluster graph and the local centring of a region rebuild in one call,
is held to the host path (``connected_components``, ``subtract_nearby``)
on the same sets, and the layers' ``create_new`` is held to the route it
takes on each device.
"""
import os

import numpy as np
import pytest
import torch

import ultranest_tpu.mlfriends as jml
import ultranest_tpu.ops.cluster as jcluster
import ultranest_torch.mlfriends as tml
import ultranest_torch.ops.cluster as tcluster
import ultranest_torch.ops.pairwise as tpw
from ultranest_torch import tracing
from ultranest_torch.ops import kernels
from ultranest_tpu.mlfriends import (AffineLayer, MLFriends, ScalingLayer)
from ultranest_tpu.ops.bootstrap import (bootstrap_radius_enlargement,
                                         make_bootstrap_masks)

DATA = os.path.join(os.path.dirname(__file__), 'data')
CPU = 'cpu'


def _check(tpoints, r2):
    """Port labels equal to both reference labellings; the count."""
    got = tcluster.label_propagation_components(tpoints, r2, device=CPU)
    np.testing.assert_array_equal(
        got, np.asarray(jcluster.label_propagation_components(tpoints, r2)))
    np.testing.assert_array_equal(
        got, jcluster.connected_components(tpoints, r2))
    np.testing.assert_array_equal(
        got, tcluster.connected_components(tpoints, r2, device=CPU))
    assert got.dtype == np.int64 and (got <= np.arange(len(got))).all()
    return len(np.unique(got))


@pytest.mark.parametrize('trial', range(5))
def test_random_geometries(trial):
    rng = np.random.RandomState(11 + trial)
    nblobs = rng.randint(1, 5)
    pts = np.concatenate([
        rng.normal(c, 0.02, size=(rng.randint(5, 30), 2))
        for c in rng.uniform(0, 10, size=(nblobs, 2))])
    for r2 in (0.01, 0.5, 200.0):
        n = _check(pts, r2)
        if r2 == 200.0:
            assert n == 1


def _golden(kind):
    """(points, number of modes) of the golden sets."""
    rng = np.random.RandomState({'eggbox': 1, 'blob': 2, 'elongated': 3}[
        kind])
    if kind == 'eggbox':
        centers = [[(2 * i + 1) * 0.2 - 0.04, (2 * j + 1) * 0.2]
                   for i in range(3) for j in range(3)]
        pts = np.vstack([rng.normal(c, 0.006, size=(25, 2))
                         for c in centers])
        return np.clip(pts, 1e-3, 1 - 1e-3), 9
    if kind == 'blob':
        return rng.normal(0.5, 0.05, size=(200, 2)).clip(1e-3, 1 - 1e-3), 1
    z = rng.normal(size=(200, 2)) * [0.15, 0.002]
    rot = np.array([[np.cos(0.7), -np.sin(0.7)], [np.sin(0.7), np.cos(0.7)]])
    return (z @ rot.T + 0.5).clip(1e-3, 1 - 1e-3), 1


@pytest.mark.parametrize('kind', ['eggbox', 'blob', 'elongated'])
def test_golden_sets(kind):
    u, nmodes = _golden(kind)
    layer = AffineLayer()
    layer.optimize(u, u)
    region = MLFriends(u, layer)
    masks = make_bootstrap_masks(len(u), 30, rng=np.random.RandomState(0))
    r2, _, ok = bootstrap_radius_enlargement(u, region.unormed, masks)
    assert ok
    assert _check(region.unormed, r2) == nmodes


@pytest.mark.parametrize('name', ['eggboxregion', 'overclustered_u_20',
                                  'clusters2'])
def test_vendored_datasets(name):
    points = np.loadtxt(os.path.join(DATA, name + '.txt'))
    if name == 'clusters2':
        r2 = float(np.loadtxt(os.path.join(DATA, 'clusters2_radius.txt')))
    else:
        layer = ScalingLayer()
        layer.optimize(points, points)
        r2 = MLFriends(points, layer).compute_maxradiussq(
            nbootstraps=30, rng=np.random.RandomState(0))
    n = _check(points, r2)
    assert 1 <= n < len(points)


# ------------------------------------------------- K8's plain version -----

def _off_boundary(r2, *sets):
    """*r2*, raised by factors of 1.0001 until no pair of any of *sets*
    (float32 points, float64 distances) lies within 1e-5 relative of it:
    there the host's float64 distances and the kernel's float32 ones may
    decide a pair differently, as they are allowed to."""
    d2 = [tpw._np_sqdist(x, x) for x in sets]
    for _ in range(200):
        if all(not (np.abs(x - r2) <= 1e-5 * r2).any() for x in d2):
            return r2
        r2 *= 1.0001
    raise AssertionError('no radius off the pairs near %g' % r2)


def _radius_graph_case(case):
    """(t-space points, u-space points, squared radius) of a named set."""
    if case.startswith('random'):
        trial, r2 = divmod(int(case[len('random'):]), 3)
        rng = np.random.RandomState(11 + trial)
        nblobs = rng.randint(1, 5)
        pts = np.concatenate([
            rng.normal(c, 0.02, size=(rng.randint(5, 30), 2))
            for c in rng.uniform(0, 10, size=(nblobs, 2))])
        return pts, pts / 10, (0.01, 0.5, 200.0)[r2]
    if case in ('eggbox', 'blob', 'elongated'):
        u, _ = _golden(case)
        layer = AffineLayer()
        layer.optimize(u, u)
        region = MLFriends(u, layer)
        masks = make_bootstrap_masks(len(u), 30,
                                     rng=np.random.RandomState(0))
        r2, _, _ = bootstrap_radius_enlargement(u, region.unormed, masks)
        return region.unormed, u, r2
    points = np.loadtxt(os.path.join(DATA, case + '.txt'))
    layer = ScalingLayer()
    layer.optimize(points, points)
    region = MLFriends(points, layer)
    r2 = region.compute_maxradiussq(nbootstraps=30,
                                    rng=np.random.RandomState(0))
    return region.unormed, points, r2


@pytest.mark.parametrize('case', ['random%d' % i for i in range(15)] + [
    'eggbox', 'blob', 'elongated', 'eggboxregion', 'overclustered_u_20',
    'clusters2'])
def test_radius_graph_plain_equals_host_path(case):
    """Labels exactly, the centred points within the 1e-5 relative of
    ``subtract_nearby`` against the reference (f32 neighbourhood sums in
    another order); also the route's own packing, fetch and unpacking."""
    tp, up, r2 = _radius_graph_case(case)
    t = np.asarray(tp, np.float32)
    u = np.asarray(up, np.float32)
    r2 = _off_boundary(r2, t, u)
    kernels.reset_counts()
    out = kernels.radius_graph(torch.as_tensor(t), torch.as_tensor(u), r2)
    assert kernels.PLAIN_CALLS['radius_graph'] == 1
    assert out.dtype == torch.int32 and out.shape == (len(t) * 3,)
    labels, centred = kernels.radius_graph_parts(out, len(t))
    want = tcluster.connected_components(t, r2, device=CPU)
    np.testing.assert_array_equal(labels.numpy(), want)
    np.testing.assert_allclose(centred.numpy(),
                               tpw.subtract_nearby(u, r2, device=CPU),
                               rtol=1e-5, atol=1e-6)
    alone = kernels.radius_graph(torch.as_tensor(t), None, r2)
    assert torch.equal(alone, labels)
    assert kernels.radius_graph_parts(alone, len(t))[1] is None
    got_labels, got_centred = tcluster._radius_graphs_k8(
        t, r2, u, torch.device(CPU))
    assert got_labels.dtype == np.int64 and got_centred.dtype == float
    np.testing.assert_array_equal(got_labels, want)
    np.testing.assert_array_equal(got_centred, centred.numpy())
    if r2 == 200.0:
        assert len(np.unique(want)) == 1


def _eggbox_layer(cls):
    """A torch layer of class *cls* fitted to the eggbox golden set, its
    live points and bootstrapped radius."""
    u, _ = _golden('eggbox')
    layer = cls()
    layer.optimize(u, u)
    region = tml.MLFriends(u, layer, device=CPU)
    r2 = region.compute_maxradiussq(nbootstraps=30,
                                    rng=np.random.RandomState(0))
    return layer, u, r2


@pytest.mark.parametrize('name', ['LocalAffineLayer', 'AffineLayer',
                                  'ScalingLayer',
                                  'MaxPrincipleGapAffineLayer'])
def test_create_new_on_cpu_takes_the_host_path(name):
    """On the CPU a rebuild's layer comes from the host path, booked as
    ``layer/graph_host``, and equals the JAX package's layer bit for bit."""
    layer, u, r2 = _eggbox_layer(getattr(tml, name))
    ref = getattr(jml, name)()
    ref.optimize(u, u)
    kernels.reset_counts()
    spans = tracing.Spans()
    with spans.running():
        with spans.count('layer'):
            new = layer.create_new(u, r2, device=CPU)
    assert spans['layer/graph_host#'] == 1 and 'layer/graph#' not in spans
    assert kernels.PLAIN_CALLS['radius_graph'] == 0
    want = ref.create_new(u, r2)
    assert new.nclusters == want.nclusters > 1
    np.testing.assert_array_equal(new.clusterids, want.clusterids)
    if name == 'ScalingLayer':
        np.testing.assert_array_equal(new.std, want.std)
    else:
        np.testing.assert_array_equal(new.T, want.T)


@pytest.mark.parametrize('name', ['LocalAffineLayer', 'AffineLayer',
                                  'ScalingLayer',
                                  'MaxPrincipleGapAffineLayer'])
def test_create_new_through_k8_equals_the_host_path(name, monkeypatch):
    """The K8 route (here with K8's plain version, as on a card for a set
    within the cap) gives the host path's clusters; the whitening learned
    from its centred points differs by their last bits only."""
    layer, u, r2 = _eggbox_layer(getattr(tml, name))
    host = layer.create_new(u, r2, device=CPU)
    monkeypatch.setattr(tcluster, '_k8_serves',
                        lambda device, n, d: kernels.radius_graph_fits(n, d))
    kernels.reset_counts()
    spans = tracing.Spans()
    with spans.running():
        with spans.count('layer'):
            new = layer.create_new(u, r2, device=CPU)
    assert spans['layer/graph#'] == 1 and 'layer/graph_host#' not in spans
    assert kernels.PLAIN_CALLS['radius_graph'] == 1
    assert new.nclusters == host.nclusters > 1
    np.testing.assert_array_equal(new.clusterids, host.clusterids)
    if name == 'ScalingLayer':
        np.testing.assert_array_equal(new.std, host.std)
    elif name == 'LocalAffineLayer':
        np.testing.assert_allclose(new.T, host.T, rtol=1e-5)
    else:
        np.testing.assert_array_equal(new.T, host.T)


@pytest.mark.parametrize('n,d,route', [
    (kernels.MAX_GRAPH_ELEMS // 2, 2, 'graph'),
    (kernels.MAX_GRAPH_ELEMS // 2 + 1, 2, 'graph_host'),
    (kernels.MAX_GRAPH_ELEMS // 32, 32, 'graph'),
    (kernels.MAX_GRAPH_ELEMS // 32 + 1, 32, 'graph_host'),
    (10, 33, 'graph_host'), (1, 1, 'graph')])
def test_radius_graphs_routes_by_device_and_cap(n, d, route, monkeypatch):
    """A CUDA device and a set within K8's cap take K8, one beyond it the
    host path (both stand-ins here); a CPU device always the host path."""
    calls = []
    monkeypatch.setattr(tcluster, '_radius_graphs_k8',
                        lambda *a: calls.append('graph') or ('k8', None))
    monkeypatch.setattr(tcluster, 'connected_components',
                        lambda *a, **k: calls.append('graph_host') or 'host')
    monkeypatch.setattr(tcluster, 'subtract_nearby',
                        lambda *a, **k: 'centred')
    t = np.zeros((n, d))
    for device in ('cuda', CPU):
        calls.clear()
        spans = tracing.Spans()
        with spans.running():
            got = tcluster.radius_graphs(t, 1.0, t, device=device)
        want = route if device == 'cuda' else 'graph_host'
        assert calls == [want] and spans[want + '#'] == 1
        assert got[0] == ('k8' if want == 'graph' else 'host')
