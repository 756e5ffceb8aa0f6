# noqa: D400 D205
"""
Region construction and sampling
--------------------------------

Constructs sampling regions from neighbourhoods around the live points:

* MLFriends (Buchner 2014 RadFriends arxiv:1407.5459, Buchner 2019
  MLFriends arxiv:1707.04476) with learned whitening layers + clustering,
* a robust single-ellipsoid region (Mukherjee et al. 2006),
* a fast axis-aligned ellipsoid region for high-d step sampling,
* a wrapping ellipsoid for filtering in user-transformed space.

Counterpart of ``ultranest_tpu/mlfriends.py`` (itself a rebuild of
upstream ``ultranest/mlfriends.pyx``), with the same class API plus a
required ``device``: regions are built with ``device=`` and layers'
``create_new`` takes one. The bootstrapped radius runs in CUDA kernel K2
on that device (:mod:`ultranest_torch.ops.bootstrap`); a rebuild's
clustering and local centring run in CUDA kernel K8 on a CUDA device
(:func:`ultranest_torch.ops.cluster.radius_graphs`); other neighbour
queries, and the clustering elsewhere, run on the host when small and as
torch on that device otherwise (:mod:`ultranest_torch.ops`). Host code
holds the small d x d linear algebra, the renumbering of the clusters
and the RNG-facing sampling policy.
"""

import numpy as np

from .ops.bootstrap import bootstrap_radius_enlargement, make_bootstrap_masks
from .ops.cluster import radius_graphs
from .ops.pairwise import (count_nearby, find_nearby,  # noqa: F401
                           compute_maxradiussq, compute_mean_pair_distance,
                           subtract_nearby)
from .utils import vol_prefactor

__all__ = [
    'ScalingLayer', 'AffineLayer', 'MaxPrincipleGapAffineLayer',
    'LocalAffineLayer', 'MLFriends', 'RobustEllipsoidRegion', 'SimpleRegion',
    'WrappingEllipsoid', 'update_clusters', 'make_eigvals_positive',
    'bounding_ellipsoid', 'vol_prefactor', 'find_nearby', 'count_nearby',
    'compute_maxradiussq', 'compute_mean_pair_distance', 'subtract_nearby',
]

int_dtype = np.int64


def update_clusters(upoints, tpoints, maxradiussq, clusterids=None, *,
                    device, local=False):
    """Cluster *upoints* by friends-of-friends connectivity in t-space.

    Two points share a cluster iff they are linked through pairs within
    sqrt(maxradiussq). Components are found by
    :func:`ultranest_torch.ops.cluster.radius_graphs` (kernel K8 on a
    CUDA *device*, else ``connected_components``); cluster ids are then
    renumbered 1..k, re-using the previous assignment *clusterids*
    where possible (the component containing the first point previously
    labelled ``k`` receives label ``k`` again), matching the reference
    policy (upstream ``upstream mlfriends.pyx:275-384``). Large point sets
    build their radius graph on *device*. With *local*, the third value
    is the local centring of ``LocalAffineLayer`` instead, from the same
    call (:func:`subtract_nearby`'s result).

    Returns
    -------
    nclusters: int
    new_clusterids: int array (N,)
    overlapped_points: array (N, d)
        upoints with their cluster means subtracted (single-member clusters
        are centered on the global mean); with *local*, each of upoints
        minus the mean of the upoints within the radius of it.
    """
    upoints = np.asarray(upoints)
    n = len(upoints)
    assert len(tpoints) == n
    if maxradiussq is None or maxradiussq >= 1e50:
        # ellipsoid-only regions use the 1e300 radius sentinel: every pair
        # is connected, so skip the O(N^2) graph — one cluster, uncentered
        return 1, np.ones(n, dtype=int_dtype), (
            subtract_nearby(upoints, maxradiussq, device=device) if local
            else upoints)
    if clusterids is None:
        clusterids = np.zeros(n, dtype=int_dtype)
    else:
        clusterids = np.asarray(clusterids)[:n]

    labels, centred = radius_graphs(tpoints, maxradiussq,
                                    upoints if local else None,
                                    device=device)
    components = np.unique(labels)

    new_ids = np.zeros(n, dtype=int_dtype)
    assigned = set()
    k = 0
    while len(assigned) < len(components):
        k += 1
        comp = None
        # prefer the component containing the first point previously
        # labelled k, to keep ids stable across rebuilds
        prev = np.where(clusterids == k)[0]
        if len(prev) > 0:
            cand = labels[prev[0]]
            if cand not in assigned:
                comp = cand
        if comp is None:
            # otherwise the lowest-representative unassigned component
            for c in components:
                if c not in assigned:
                    comp = c
                    break
        new_ids[labels == comp] = k
        assigned.add(comp)
    nclusters = k

    if local:
        overlapped_points = centred
    elif nclusters == 1:
        overlapped_points = upoints
    else:
        overlapped_points = np.empty_like(upoints)
        global_mean = upoints.mean(axis=0)
        for idx in range(1, nclusters + 1):
            member = new_ids == idx
            group = upoints[member, :]
            if len(group) > 1:
                mean = group.mean(axis=0)
            else:
                # single point: center on the global population mean so the
                # outlier still contributes spread
                mean = global_mean
            overlapped_points[member, :] = group - mean

    return nclusters, new_ids, overlapped_points


def make_eigvals_positive(a, targetprod):
    """Raise zero eigenvalues of symmetric matrix *a* to meet a target eigenvalue product."""
    assert np.isfinite(a).all(), a
    w, v = np.linalg.eigh(a)
    mask = w < max(1.0e-10, 1e-300 ** (1.0 / len(a)))
    if np.any(mask):
        # work in log space: products of many small eigenvalues underflow
        nzprod_log = np.sum(np.log(w[~mask]))
        nzeros = mask.sum()
        w[mask] = np.exp((np.log(targetprod) - nzprod_log) / nzeros)
        a = np.dot(np.dot(v, np.diag(w)), np.linalg.inv(v))
    return a


def bounding_ellipsoid(x, minvol=0.0):
    """Center and (inflated) covariance of the ellipsoid bounding points *x*.

    The sample covariance is scaled by (ndim+2) — the expansion factor for
    points uniformly distributed in an ellipsoid.
    """
    ctr = x.mean(axis=0)
    cov = np.atleast_2d(np.cov(x - ctr, rowvar=0))
    assert np.isfinite(cov).all(), (cov, x)
    cov = cov * (x.shape[1] + 2)
    return ctr, make_eigvals_positive(cov, minvol) if minvol > 0 else cov


def _inside_ellipsoid(points, ellipsoid_center, ellipsoid_invcov, square_radius):
    """Mahalanobis membership test for each row of *points*."""
    d = points - ellipsoid_center
    # (d @ A * d).sum reduces to BLAS; the 3-operand einsum lowers to
    # naive O(N d^2) loops (no matmul path without optimize=True)
    r = (d @ ellipsoid_invcov * d).sum(axis=1)
    return r <= square_radius


class ScalingLayer:
    """Whitening layer that shifts and scales each axis independently."""

    def __init__(self, mean=0, std=1, nclusters=1, wrapped_dims=[],
                 clusterids=None):
        """Initialise layer."""
        self.mean, self.std = mean, std
        self.nclusters = nclusters
        self.clusterids = clusterids
        self.wrapped_dims = wrapped_dims
        self.has_wraps = len(wrapped_dims) > 0

    def optimize_wrap(self, points):
        """Choose wrap cut positions for circular parameters.

        For each wrapped axis, the largest gap in the live points is found
        and the axis is re-seamed there; no-op without wrapped axes.
        """
        if not self.has_wraps:
            return
        # per wrapped axis: sorted values padded with the cube edges; the
        # seam goes through the middle of the widest gap
        cuts = []
        for i in self.wrapped_dims:
            vals = np.sort(np.concatenate(([0.0], points[:, i], [1.0])))
            widest = np.diff(vals).argmax()
            cuts.append(0.5 * (vals[widest] + vals[widest + 1]))
        self.wrap_cuts = cuts

    def _shift_axes(self, points, offsets):
        """Translate the wrapped axes modulo 1 (vectorized over axes)."""
        shifted = points.copy().reshape((-1, points.shape[-1]))
        dims = list(self.wrapped_dims)
        shifted[:, dims] = np.fmod(
            shifted[:, dims] + np.asarray(offsets)[None, :], 1)
        return shifted

    def wrap(self, points):
        """Apply the wrap seam for circular parameters."""
        if not self.has_wraps:
            return points
        return self._shift_axes(points,
                                [1 - c for c in self.wrap_cuts])

    def unwrap(self, wpoints):
        """Undo the wrap seam for circular parameters."""
        if not self.has_wraps:
            return wpoints
        return self._shift_axes(wpoints, self.wrap_cuts)

    def optimize(self, points, centered_points, clusterids=None, minvol=0.0):
        """Fit per-axis mean/std from *points* / cluster-centered points."""
        self.optimize_wrap(points)
        self.mean = self.wrap(points).mean(axis=0)[None, :]
        self.std = centered_points.std(axis=0)[None, :]
        self.axes = np.diag(self.std[0])
        self.logvolscale = float(np.log(self.std).sum())
        self.set_clusterids(clusterids=clusterids, npoints=len(points))

    def set_clusterids(self, clusterids=None, npoints=None):
        """Update the cluster id assigned to each point."""
        if clusterids is None and self.clusterids is None and npoints is not None:
            clusterids = np.ones(npoints, dtype=int_dtype)
        if clusterids is not None:
            self.clusterids = clusterids

    def create_new(self, upoints, maxradiussq, minvol=0.0, *, device):
        """Cluster points and return a freshly optimized layer of this class."""
        uwpoints = self.wrap(upoints)
        tpoints = self.transform(upoints)
        nclusters, clusteridxs, overlapped_uwpoints = update_clusters(
            uwpoints, tpoints, maxradiussq, self.clusterids, device=device)
        s = self.__class__(nclusters=nclusters, wrapped_dims=self.wrapped_dims,
                           clusterids=clusteridxs)
        s.optimize(upoints, overlapped_uwpoints)
        return s

    def transform(self, u):
        """Transform points from cube space to the whitened space."""
        w = self.wrap(u) if self.has_wraps else u
        return ((w - self.mean) / self.std).reshape(u.shape)

    def untransform(self, ww):
        """Transform points from whitened space back to cube space."""
        w = (ww * self.std) + self.mean
        if self.has_wraps:
            return self.unwrap(w).reshape(ww.shape)
        return w.reshape(ww.shape)


class AffineLayer(ScalingLayer):
    """Affine whitening layer learned from the sample covariance.

    The next layer's covariance is learned from cluster-mean-subtracted
    points, so multiple modes contribute their common shape rather than
    their separation.
    """

    def __init__(self, ctr=0, T=1, invT=1, nclusters=1, wrapped_dims=[],
                 clusterids=None):
        """Initialise; parameters are learned via :meth:`optimize`."""
        self.ctr = ctr
        self.T = T
        self.invT = invT
        self.nclusters = nclusters
        self.wrapped_dims = wrapped_dims
        self.has_wraps = len(wrapped_dims) > 0
        self.clusterids = clusterids

    def optimize(self, points, centered_points, clusterids=None, minvol=0.0):
        """Estimate whitening transform from covariance of *centered_points*."""
        self.optimize_wrap(points)
        self.ctr = self.wrap(points).mean(axis=0)
        cov = np.cov(centered_points, rowvar=0) * (len(self.ctr) + 2)
        self.cov = cov
        eigval, eigvec = np.linalg.eigh(cov)
        np.clip(eigval, eigval.max() * 1e-40, None, out=eigval)
        self.logvolscale = -0.5 * np.linalg.slogdet(np.linalg.inv(cov))[1]
        self.T = eigvec * eigval ** -0.5
        self.invT = np.linalg.inv(self.T)
        self.axes = self.invT
        self.set_clusterids(clusterids=clusterids, npoints=len(points))

    def create_new(self, upoints, maxradiussq, minvol=0.0, *, device):
        """Cluster points and return a freshly optimized layer of this class."""
        uwpoints = self.wrap(upoints)
        tpoints = self.transform(upoints)
        nclusters, clusteridxs, overlapped_uwpoints = update_clusters(
            uwpoints, tpoints, maxradiussq, self.clusterids, device=device)
        s = self.__class__(nclusters=nclusters, wrapped_dims=self.wrapped_dims,
                           clusterids=clusteridxs)
        s.optimize(upoints, overlapped_uwpoints, minvol=minvol)
        return s

    def transform(self, u):
        """Transform points from cube space to the whitened space."""
        w = self.wrap(u) if self.has_wraps else u
        return np.dot(w - self.ctr, self.T)

    def untransform(self, ww):
        """Transform points from whitened space back to cube space."""
        w = np.dot(ww, self.invT) + self.ctr
        if self.has_wraps:
            return self.unwrap(w).reshape(ww.shape)
        return w.reshape(ww.shape)


class MaxPrincipleGapAffineLayer(AffineLayer):
    """Affine layer that splits along the largest principal-axis gap.

    After cluster co-centering, points are projected onto the principal
    axis; the largest gap splits them into two groups which are separately
    mean-subtracted before the covariance is learned. This yields a more
    local covariance even before clusters separate cleanly.
    """

    def create_new(self, upoints, maxradiussq, minvol=0.0, *, device):
        """Cluster, split at the principal gap, and optimize a new layer."""
        uwpoints = self.wrap(upoints)
        tpoints = self.transform(upoints)
        nclusters, clusteridxs, overlapped_uwpoints = update_clusters(
            uwpoints, tpoints, maxradiussq, self.clusterids, device=device)

        cov = np.cov(overlapped_uwpoints, rowvar=0)
        cov *= (len(self.ctr) + 2)
        eigval, eigvec = np.linalg.eigh(cov)
        principal = eigvec[:, -1]
        t = np.dot(overlapped_uwpoints
                   - overlapped_uwpoints.mean(axis=0).reshape((1, -1)),
                   principal)
        tsorted = np.sort(t)
        tgapindex = np.argmax(np.diff(tsorted))
        tsep = (tsorted[tgapindex] + tsorted[tgapindex + 1]) / 2
        left = t < tsep
        halved = overlapped_uwpoints.copy()
        halved[left, :] -= overlapped_uwpoints[left, :].mean(axis=0)
        halved[~left, :] -= overlapped_uwpoints[~left, :].mean(axis=0)

        s = MaxPrincipleGapAffineLayer(
            nclusters=nclusters, wrapped_dims=self.wrapped_dims,
            clusterids=clusteridxs)
        s.optimize(upoints, halved, minvol=minvol)
        return s


class LocalAffineLayer(AffineLayer):
    """Affine layer learned from locally (MLradius) co-centered points.

    The default layer: each point has the mean of its radius-neighbourhood
    subtracted, giving a local covariance; on a CUDA *device* kernel K8
    computes that and the clusters in one call, elsewhere a host matmul
    (or torch on *device* for large sets) does.
    """

    def create_new(self, upoints, maxradiussq, minvol=0.0, *, device):
        """Cluster points and optimize on locally co-centered points."""
        uwpoints = self.wrap(upoints)
        tpoints = self.transform(upoints)
        nclusters, clusteridxs, local_overlapped_uwpoints = update_clusters(
            uwpoints, tpoints, maxradiussq, self.clusterids, device=device,
            local=True)
        s = self.__class__(nclusters=nclusters, wrapped_dims=self.wrapped_dims,
                           clusterids=clusteridxs)
        s.optimize(upoints, local_overlapped_uwpoints, minvol=minvol)
        return s


class MLFriends:
    """MLFriends region: union of balls around live points in whitened space.

    Supports membership testing (for filtering proposals) and four
    uniform sampling strategies with automatic switching. The bootstrap
    radius and the large neighbour queries run on *device*.
    """

    def __init__(self, u, transformLayer, *, device):
        """Initialise with live points *u* and a whitening *transformLayer*."""
        if not np.logical_and(u > 0, u < 1).all():
            raise ValueError(
                "not all u values are between 0 and 1: %s"
                % u[~np.logical_and(u > 0, u < 1).all()])
        self.u = u
        self.device = device
        self.set_transformLayer(transformLayer)
        self.sampling_methods = [
            self.sample_from_transformed_boundingbox,
            self.sample_from_boundingbox,
            self.sample_from_points,
            self.sample_from_wrapping_ellipsoid,
        ]
        self.current_sampling_method = self.sample_from_boundingbox
        self.vol_prefactor = vol_prefactor(self.u.shape[1])

    def estimate_volume(self):
        """Log-volume scale of one radius-ball under the current layer.

        Ignores ball count, overlap and cube clipping: used only for
        accept/reject comparisons between consecutive regions.
        """
        r = self.maxradiussq ** 0.5
        ndim = self.u.shape[1]
        return self.transformLayer.logvolscale + np.log(r) * ndim

    def set_transformLayer(self, transformLayer):
        """Set transform layer and invalidate the radius."""
        self.transformLayer = transformLayer
        whitened = transformLayer.transform(self.u)
        assert np.isfinite(whitened).all(), (whitened, self.u)
        self.unormed = whitened
        self.bbox_lo, self.bbox_hi = \
            whitened.min(axis=0), whitened.max(axis=0)
        self.maxradiussq = None

    def compute_maxradiussq(self, nbootstraps=50, rng=np.random,
                            mesh=None):
        """Bootstrapped squared MLFriends radius (radius only)."""
        masks = make_bootstrap_masks(len(self.u), nbootstraps, rng=rng)
        maxd, _, ok = bootstrap_radius_enlargement(
            self.u, self.unormed, masks, mode='mlfriends', device=self.device,
            mesh=mesh)
        assert maxd > 0, (maxd, self.u)
        return maxd

    def compute_enlargement(self, nbootstraps=50, minvol=0.0,
                            rng=np.random, mesh=None):
        """Bootstrapped MLFriends radius and ellipsoid enlargement.

        The radius rounds run in kernel K2 on the region's device
        (:func:`ultranest_torch.ops.bootstrap.bootstrap_radius_enlargement`),
        split over the shards of *mesh* when one is given.

        Returns
        -------
        max_distance: float
            squared MLFriends radius
        max_radius: float
            squared Mahalanobis enlargement of the wrapping ellipsoid
        """
        masks = make_bootstrap_masks(len(self.u), nbootstraps, rng=rng)
        maxd, maxf, ok = bootstrap_radius_enlargement(
            self.u, self.unormed, masks, mode='mlfriends', device=self.device,
            mesh=mesh)
        if not ok:
            raise np.linalg.LinAlgError("compute_enlargement degenerated")
        return maxd, maxf

    def sample_from_points(self, nsamples=100, rng=np.random):
        """Sample from the union of balls by drawing around random live points."""
        N, ndim = self.u.shape
        idx = rng.randint(N, size=nsamples)
        v = rng.normal(size=(nsamples, ndim))
        v *= (rng.uniform(size=nsamples) ** (1.0 / ndim)
              / np.linalg.norm(v, axis=1)).reshape((-1, 1))
        v = self.unormed[idx, :] + v * self.maxradiussq ** 0.5
        # multiplicity correction: accept with probability 1/(number of
        # balls covering the proposal)
        nnearby = count_nearby(self.unormed, v, self.maxradiussq,
                               device=self.device)
        vmask = rng.uniform(high=np.maximum(nnearby, 1)) < 1
        vmask = np.logical_and(vmask, nnearby > 0)
        w = self.transformLayer.untransform(v[vmask, :])
        wmask = np.logical_and(w > 0, w < 1).all(axis=1)
        wmask[wmask] = self.inside_ellipsoid(w[wmask])
        return w[wmask, :]

    def sample_from_boundingbox(self, nsamples=100, rng=np.random):
        """Sample from the unit cube, filtered by ellipsoid and radius test."""
        N, ndim = self.u.shape
        u = rng.uniform(size=(nsamples, ndim))
        wmask = self.inside_ellipsoid(u)
        v = self.transformLayer.transform(u[wmask, :])
        idnearby = find_nearby(self.unormed, v, self.maxradiussq,
                               device=self.device)
        vmask = idnearby >= 0
        return u[wmask, :][vmask, :]

    def sample_from_transformed_boundingbox(self, nsamples=100, rng=np.random):
        """Sample from the whitened-space bounding box, then filter."""
        N, ndim = self.u.shape
        v = rng.uniform(self.bbox_lo - self.maxradiussq ** 0.5,
                        self.bbox_hi + self.maxradiussq ** 0.5,
                        size=(nsamples, ndim))
        idnearby = find_nearby(self.unormed, v, self.maxradiussq,
                               device=self.device)
        vmask = idnearby >= 0
        w = self.transformLayer.untransform(v[vmask, :])
        wmask = np.logical_and(w > 0, w < 1).all(axis=1)
        wmask[wmask] = self.inside_ellipsoid(w[wmask])
        return w[wmask, :]

    def sample_from_wrapping_ellipsoid(self, nsamples=100, rng=np.random):
        """Sample from the enlarged wrapping ellipsoid, then filter."""
        N, ndim = self.u.shape
        z = rng.normal(size=(nsamples, ndim))
        assert ((z ** 2).sum(axis=1) > 0).all()
        z /= ((z ** 2).sum(axis=1) ** 0.5).reshape((nsamples, 1))
        assert self.enlarge > 0, self.enlarge
        u = z * self.enlarge ** 0.5 * rng.uniform(size=(nsamples, 1)) ** (1.0 / ndim)
        w = self.ellipsoid_center + np.dot(u, self.ellipsoid_axes_T)
        wmask = np.logical_and(w > 0, w < 1).all(axis=1)
        v = self.transformLayer.transform(w[wmask, :])
        idnearby = find_nearby(self.unormed, v, self.maxradiussq,
                               device=self.device)
        vmask = idnearby >= 0
        return w[wmask, :][vmask, :]

    def sample(self, nsamples=100, rng=np.random):
        """Draw uniform samples, auto-switching between strategies on failure."""
        samples = self.current_sampling_method(nsamples=nsamples, rng=rng)
        if len(samples) == 0:
            self.current_sampling_method = self.sampling_methods[
                rng.randint(len(self.sampling_methods))]
        return samples

    def inside(self, pts):
        """Check membership: wrapping ellipsoid AND within radius of a live point."""
        mask = self.inside_ellipsoid(pts)
        if mask.any():
            bpts = self.transformLayer.transform(pts[mask, :])
            idnearby = find_nearby(self.unormed, bpts, self.maxradiussq,
                                   device=self.device)
            mask[mask] = idnearby >= 0
        return mask

    def create_ellipsoid(self, minvol=0.0):
        """Build and cache the wrapping ellipsoid (center, cov, axes)."""
        assert self.enlarge is not None
        center, cov = bounding_ellipsoid(self.u, minvol=minvol)
        self.ellipsoid_center = center
        self.ellipsoid_cov = cov
        self.ellipsoid_invcov = np.linalg.inv(cov)

        eigval, eigvec = np.linalg.eigh(self.ellipsoid_invcov)
        self.ellipsoid_axlens = eigval ** -0.5
        self.ellipsoid_axes = np.dot(eigvec, np.diag(self.ellipsoid_axlens))
        self.ellipsoid_axes_T = self.ellipsoid_axes.transpose()

        eigval2, eigvec2 = np.linalg.eigh(cov)
        self.ellipsoid_inv_axlens = 1.0 / np.sqrt(eigval2)
        self.ellipsoid_inv_axes = np.dot(eigvec2,
                                         np.diag(self.ellipsoid_inv_axlens))

    def inside_ellipsoid(self, u):
        """Check membership in the enlarged wrapping ellipsoid."""
        return _inside_ellipsoid(u, self.ellipsoid_center,
                                 self.ellipsoid_invcov, self.enlarge)

    def compute_mean_pair_distance(self):
        """Mean same-cluster pair distance of the whitened live points."""
        return compute_mean_pair_distance(self.unormed,
                                          self.transformLayer.clusterids,
                                          device=self.device)


class RobustEllipsoidRegion(MLFriends):
    """Single-ellipsoid region (no MLFriends radius): robust for high-d."""

    def __init__(self, u, transformLayer, *, device):
        """Initialise with live points *u* and whitening *transformLayer*."""
        if not np.logical_and(u > 0, u < 1).all():
            raise ValueError(
                "not all u values are between 0 and 1: %s"
                % u[~np.logical_and(u > 0, u < 1).all()])
        self.u = u
        self.device = device
        self.set_transformLayer(transformLayer)
        self.sampling_methods = [
            self.sample_from_boundingbox,
            self.sample_from_wrapping_ellipsoid,
        ]
        self.current_sampling_method = self.sample_from_boundingbox
        self.vol_prefactor = vol_prefactor(self.u.shape[1])

    def sample_from_boundingbox(self, nsamples=100, rng=np.random):
        """Sample from the unit cube, filtered by the ellipsoid."""
        N, ndim = self.u.shape
        u = rng.uniform(size=(nsamples, ndim))
        wmask = self.inside_ellipsoid(u)
        return u[wmask, :]

    def sample_from_transformed_boundingbox(self, nsamples=100, rng=np.random):
        """Sample from the whitened-space bounding box, filtered by the ellipsoid."""
        N, ndim = self.u.shape
        v = rng.uniform(self.bbox_lo - self.maxradiussq,
                        self.bbox_hi + self.maxradiussq, size=(nsamples, ndim))
        w = self.transformLayer.untransform(v)
        wmask = np.logical_and(w > 0, w < 1).all(axis=1)
        wmask[wmask] = self.inside_ellipsoid(w[wmask])
        return w[wmask, :]

    def sample_from_wrapping_ellipsoid(self, nsamples=100, rng=np.random):
        """Sample uniformly inside the enlarged ellipsoid, clipped to the cube."""
        N, ndim = self.u.shape
        z = rng.normal(size=(nsamples, ndim))
        z /= ((z ** 2).sum(axis=1) ** 0.5).reshape((nsamples, 1))
        assert self.enlarge > 0, self.enlarge
        u = z * self.enlarge ** 0.5 * rng.uniform(size=(nsamples, 1)) ** (1.0 / ndim)
        w = self.ellipsoid_center + np.dot(u, self.ellipsoid_axes_T)
        wmask = np.logical_and(w > 0, w < 1).all(axis=1)
        return w[wmask, :]

    def inside(self, pts):
        """Check membership in the wrapping ellipsoid."""
        return self.inside_ellipsoid(pts)

    def compute_enlargement(self, nbootstraps=50, minvol=0.0,
                            rng=np.random, mesh=None):
        """Bootstrapped ellipsoid enlargement (radius fixed at 1e300; a
        *mesh* is accepted and unused: there are no radius rounds)."""
        N, ndim = self.u.shape
        if N < ndim + 1:
            raise FloatingPointError(
                'not enough live points to compute covariance')
        masks = make_bootstrap_masks(N, nbootstraps, rng=rng)
        maxd, maxf, ok = bootstrap_radius_enlargement(
            self.u, None, masks, mode='ellipsoid')
        if not ok:
            raise np.linalg.LinAlgError("compute_enlargement degenerated")
        return 1e300, maxf

    def estimate_volume(self):
        """Log-volume of the enlarged ellipsoid (ignoring cube clipping)."""
        ndim = len(self.ellipsoid_cov)
        sign, logvol = np.linalg.slogdet(self.ellipsoid_cov)
        if sign > 0:
            return logvol + ndim * np.log(self.enlarge)
        return -1e300


class SimpleRegion(RobustEllipsoidRegion):
    """Axis-aligned ellipsoid region: fastest, for slice-sampled high-d runs."""

    def create_ellipsoid(self, minvol=0.0):
        """Build the axis-aligned wrapping ellipsoid from per-axis variances."""
        assert self.enlarge is not None
        ctr = np.mean(self.u, axis=0)
        var = np.var(self.u, axis=0)
        a = np.diag(1.0 / var)
        cov = np.diag(var)

        self.ellipsoid_center = ctr
        self.ellipsoid_invcov = a
        self.ellipsoid_cov = cov

        self.ellipsoid_axlens = np.sqrt(var)
        self.ellipsoid_axes = np.diag(self.ellipsoid_axlens)
        self.ellipsoid_axes_T = self.ellipsoid_axes.transpose()
        self.ellipsoid_inv_axlens = 1.0 / np.sqrt(var)
        self.ellipsoid_inv_axes = np.diag(self.ellipsoid_inv_axlens)

    def compute_enlargement(self, nbootstraps=50, minvol=0.0,
                            rng=np.random, mesh=None):
        """Bootstrapped axis-aligned enlargement (a *mesh* is accepted and
        unused: there are no radius rounds).

        Note: uses the per-point Mahalanobis sum over dimensions (the
        reference reduces over the wrong axis at `upstream mlfriends.pyx:1540`).
        """
        N, ndim = self.u.shape
        if N < ndim + 1:
            raise FloatingPointError(
                'not enough live points to compute variance')
        masks = make_bootstrap_masks(N, nbootstraps, rng=rng)
        maxd, maxf, ok = bootstrap_radius_enlargement(
            self.u, None, masks, mode='simple')
        if not ok:
            raise np.linalg.LinAlgError("compute_enlargement degenerated")
        return 1e300, maxf


class WrappingEllipsoid:
    """Ellipsoid that safely wraps a point set (used in p-space)."""

    def __init__(self, u):
        """Initialise with points *u*; constant dimensions are factored out."""
        self.u = u
        self.variable_dims = np.std(self.u, axis=0) > 0
        if self.variable_dims.all():
            self.variable_dims = Ellipsis

    def compute_enlargement(self, nbootstraps=50, rng=np.random):
        """Bootstrapped enlargement factor for the wrapping ellipsoid."""
        v = self.u[:, self.variable_dims]
        masks = make_bootstrap_masks(len(v), nbootstraps, rng=rng)
        _, maxf, ok = bootstrap_radius_enlargement(v, None, masks, mode='wrap')
        if not ok:
            raise np.linalg.LinAlgError("Distances are not positive")
        return maxf

    def create_ellipsoid(self, minvol=0.0):
        """Build and cache the wrapping ellipsoid."""
        assert self.enlarge is not None
        ctr, cov = bounding_ellipsoid(self.u[:, self.variable_dims],
                                      minvol=minvol)
        a = np.linalg.inv(cov)
        self.ellipsoid_center = ctr
        self.ellipsoid_invcov = a
        self.ellipsoid_cov = cov
        eigval, eigvec = np.linalg.eigh(a)
        self.ellipsoid_axlens = 1.0 / np.sqrt(eigval)
        self.ellipsoid_axes = np.dot(eigvec, np.diag(self.ellipsoid_axlens))

    def update_center(self, ctr):
        """Update the center, respecting factored-out fixed dimensions."""
        if self.variable_dims is Ellipsis:
            self.ellipsoid_center = ctr
        else:
            self.ellipsoid_center = ctr[self.variable_dims]

    def inside(self, u):
        """Check membership; fixed dimensions must match exactly."""
        inside_variable = _inside_ellipsoid(
            u[:, self.variable_dims], self.ellipsoid_center,
            self.ellipsoid_invcov, self.enlarge)
        if self.variable_dims is Ellipsis:
            return inside_variable
        inside_fixed = np.all(
            self.u[0, ~self.variable_dims] == u[:, ~self.variable_dims], axis=1)
        return np.logical_and(inside_fixed, inside_variable)
