# noqa: D400 D205
"""
Pairwise-distance operations
----------------------------

Counterpart of ``ultranest_tpu/ops/pairwise.py``: nearest-neighbour
queries and radius reductions over live-point sets (upstream
``mlfriends.pyx:31-270``).

Small problems run on the host in f64 (:func:`_np_sqdist`); larger ones
run as torch on the device every caller must name (``device=``, the
sampler's own device), as the reference sends them to its accelerator.
The split is the reference's ``_small`` rule and threshold, which was
tuned for a TPU behind a network link and still has to be measured again
for a local GPU.

Device distances are summed per axis from direct differences
(:func:`pairwise_sqdist`), never from the f32 Gram identity and never
with ``torch.cdist``, which switches to a matmul above 25 rows.
"""

import numpy as np
import torch

__all__ = [
    'pairwise_sqdist', 'compute_maxradiussq', 'count_nearby', 'find_nearby',
    'compute_mean_pair_distance', 'subtract_nearby', 'match_clusters',
    'pad_rows', 'round_up',
]

# Work threshold (pairwise-matrix cells x dims) below which the host
# numpy path is used (the reference's value, ops/pairwise.py:37).
HOST_WORK_THRESHOLD = 4_000_000


def _small(na, nb, d):
    """Whether a pairwise problem is small enough for the host path."""
    return na * nb * max(d, 1) < HOST_WORK_THRESHOLD


def _np_sqdist(a, b):
    """Host pairwise squared distances (f64 Gram identity).

    f64 keeps the Gram cancellation error (~eps * |a||b|) far below the
    smallest distances nested sampling produces. Same operation order as
    the reference, so results are bit-identical to it.
    """
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    ra = np.einsum('ij,ij->i', a, a)
    rb = np.einsum('ij,ij->i', b, b)
    g = a @ b.T
    g *= 2.0
    t = ra[:, None] + rb[None, :]
    np.subtract(t, g, out=t)
    np.maximum(t, 0.0, out=t)
    return t


def round_up(n, base=64):
    """Round *n* up to the next power of two, at least *base*."""
    n = max(int(n), base)
    return 1 << (n - 1).bit_length()


def pad_rows(x, npad, fill=0.0):
    """Pad array *x* along axis 0 to *npad* rows with *fill*."""
    x = np.asarray(x)
    n = x.shape[0]
    if n == npad:
        return x
    pad_width = [(0, npad - n)] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad_width, constant_values=fill)


def pairwise_sqdist(a, b):
    """Squared distances between the rows of *a* (n, d) and *b* (m, d).

    Summed axis by axis in order k = 0..d-1 from direct differences:
    ``acc = acc + diff * diff`` as two separate f32 roundings, the
    arithmetic of the reference's ``lax.scan`` and of the CUDA kernels
    in :mod:`ultranest_torch.ops.kernels`. The Gram identity
    (``|a|^2+|b|^2-2ab``) loses the small distances of late-stage
    regions to f32 cancellation.
    """
    d2 = torch.zeros((a.shape[0], b.shape[0]), dtype=a.dtype,
                     device=a.device)
    for k in range(a.shape[1]):
        diff = a[:, k, None] - b[None, :, k]
        d2 = d2 + diff * diff
    return d2


def _torch(x, device, dtype=torch.float32):
    """*x* as a tensor on *device*, which must be named."""
    if device is None:
        raise ValueError('a device is required for the torch path')
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def compute_maxradiussq(apts, bpts, *, device):
    """Worst-case nearest-neighbour squared distance from *bpts* to *apts*.

    Equivalent to upstream ``mlfriends.pyx:188-224``.
    """
    apts = np.asarray(apts, dtype=np.float32)
    bpts = np.asarray(bpts, dtype=np.float32)
    na, nb = len(apts), len(bpts)
    if _small(na, nb, apts.shape[1]):
        return float(_np_sqdist(apts, bpts).min(axis=0).max())
    d2 = pairwise_sqdist(_torch(apts, device), _torch(bpts, device))
    return float(d2.amin(dim=0).max())


def _nearby_host(apts, bpts, radiussq, count, device):
    apts = np.asarray(apts, dtype=np.float32)
    bpts = np.asarray(bpts, dtype=np.float32)
    na, nb = len(apts), len(bpts)
    if na == 0 or nb == 0:
        return np.full(nb, 0 if count else -1, dtype=np.int64)
    if _small(na, nb, apts.shape[1]):
        within = _np_sqdist(apts, bpts) <= radiussq
    else:
        d2 = pairwise_sqdist(_torch(apts, device), _torch(bpts, device))
        within = (d2 <= np.float32(radiussq)).cpu().numpy()
    if count:
        return within.sum(axis=0).astype(np.int64)
    first = within.argmax(axis=0)
    return np.where(within.any(axis=0), first, -1).astype(np.int64)


def count_nearby(apts, bpts, radiussq, nnearby=None, *, device):
    """Number of *apts* within sqrt(radiussq) of each point in *bpts*.

    Mirrors upstream ``mlfriends.pyx:31-68``; if *nnearby* is given,
    results are also written into it.
    """
    out = _nearby_host(apts, bpts, radiussq, True, device)
    if nnearby is not None:
        nnearby[:] = out
    return out


def find_nearby(apts, bpts, radiussq, nnearby=None, *, device):
    """Index of some *apts* member within sqrt(radiussq) of each *bpts* point.

    -1 where none is within reach (cf. upstream ``mlfriends.pyx:143-183``).
    """
    out = _nearby_host(apts, bpts, radiussq, False, device)
    if nnearby is not None:
        nnearby[:] = out
    return out


def compute_mean_pair_distance(pts, clusterids=None, *, device):
    """Mean distance between point pairs sharing a cluster id (> 0).

    Cf. upstream ``mlfriends.pyx:229-270``.
    """
    pts = _torch(np.asarray(pts, dtype=np.float32), device)
    n = len(pts)
    if clusterids is None:
        clusterids = np.ones(n, dtype=np.int64)
    cid = _torch(clusterids, device, torch.int64)
    d2 = pairwise_sqdist(pts, pts)
    valid = (cid[:, None] == cid[None, :]) & (cid > 0)[:, None]
    valid = torch.triu(valid, diagonal=1)
    npairs = int(valid.sum())
    assert npairs > 0, "no pairs share a cluster"
    return float(torch.where(valid, d2.sqrt(), 0.0).sum()) / npairs


def subtract_nearby(upoints, maxradiussq, *, device):
    """Subtract from each point the mean of points within the radius.

    The local co-centering used by ``LocalAffineLayer``
    (cf. upstream ``mlfriends.pyx:73-138``).
    """
    upoints = np.asarray(upoints, dtype=np.float32)
    n = len(upoints)
    if _small(n, n, upoints.shape[1]):
        within = _np_sqdist(upoints, upoints) <= maxradiussq
        counts = np.maximum(within.sum(axis=1), 1)
        means = (within.astype(np.float32) @ upoints) / \
            counts[:, None].astype(np.float32)
        return (upoints - means).astype(float)
    pts = _torch(upoints, device)
    within = (pairwise_sqdist(pts, pts) <= np.float32(maxradiussq)).float()
    counts = within.sum(dim=1).clamp(min=1)
    means = (within @ pts) / counts[:, None]
    return (pts - means).cpu().numpy().astype(float)


def match_clusters(apts, clusterids, bpts, radiussq, *, device):
    """For each point in *bpts*: which clusters of *apts* are within reach.

    Cluster id 0 (unassigned) is ignored.

    Returns
    -------
    new_ids: int array (len(bpts),)
        the cluster id when exactly one cluster is within sqrt(radiussq),
        0 when none or several (ambiguous points stay unassigned).
    """
    apts = np.asarray(apts, dtype=np.float32)
    bpts = np.asarray(bpts, dtype=np.float32)
    clusterids = np.asarray(clusterids)
    na, nb = len(apts), len(bpts)
    ids = np.unique(clusterids[clusterids > 0])
    if len(ids) == 0 or na == 0 or nb == 0:
        return np.zeros(nb, dtype=np.int64)
    if _small(na, nb, apts.shape[1]):
        within = _np_sqdist(apts, bpts) <= radiussq
        counts = np.stack([(within[clusterids == ci]).any(axis=0)
                           for ci in ids])
    else:
        onehot = _torch(clusterids[:, None] == ids[None, :], device)
        within = (pairwise_sqdist(_torch(apts, device), _torch(bpts, device))
                  <= np.float32(radiussq)).float()
        counts = (onehot.T @ within > 0).cpu().numpy()
    nhit = counts.sum(axis=0)
    first = counts.argmax(axis=0)
    return np.where(nhit == 1, ids[first], 0).astype(np.int64)
