# noqa: D400 D205
"""
Friends-of-friends clustering
-----------------------------

Counterpart of ``ultranest_tpu/ops/cluster.py:30-118``. Two points
belong to the same cluster iff they are connected through pairs closer
than the MLFriends radius: connected components of the
r-neighbourhood graph. The adjacency comes from host f64 distances for
small sets and from torch direct-difference distances on the caller's
device otherwise; the labelling is scipy's union-find on the host.
"""

import numpy as np

from .pairwise import _np_sqdist, _small, _torch, pairwise_sqdist

__all__ = ['connected_components']


def _adjacency(tpoints, radiussq, device):
    """Boolean (N, N) radius graph, on the host or on *device*."""
    n = len(tpoints)
    if _small(n, n, tpoints.shape[1]):
        return _np_sqdist(tpoints, tpoints) <= radiussq
    pts = _torch(tpoints, device)
    return (pairwise_sqdist(pts, pts) <= np.float32(radiussq)).cpu().numpy()


def connected_components(tpoints, radiussq, *, device):
    """Connected components of the radius graph over *tpoints*.

    Returns
    -------
    labels: int array (N,)
        component label per point: the smallest member index of its
        component.
    """
    import scipy.sparse
    import scipy.sparse.csgraph
    tpoints = np.asarray(tpoints, dtype=np.float32)
    adj = _adjacency(tpoints, radiussq, device)
    _, labels = scipy.sparse.csgraph.connected_components(
        scipy.sparse.csr_matrix(adj), directed=False)
    # canonicalize: label = smallest member index of the component
    first = np.full(labels.max() + 1, -1, dtype=np.int64)
    for i, lab in enumerate(labels):
        if first[lab] < 0:
            first[lab] = i
    return first[labels]
