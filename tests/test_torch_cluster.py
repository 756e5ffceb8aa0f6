"""The port's device label propagation against the JAX package, on the CPU.

``ultranest_torch.ops.cluster.label_propagation_components`` (pointer
jumping, its loop condition read from the device) must give the labels
of the reference's ``label_propagation_components`` and of
``connected_components`` (the smallest member index of each component)
exactly: on the random geometries of ``tests/test_region.py:255-270``, on
the golden sets of ``tests/test_clustering_golden.py`` (their mode
counts too) and on the vendored datasets of ``tests/data/`` at their
MLFriends radii.
"""
import os

import numpy as np
import pytest

import ultranest_tpu.ops.cluster as jcluster
import ultranest_torch.ops.cluster as tcluster
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
