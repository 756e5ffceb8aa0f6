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
:func:`label_propagation_components` labels the same graph on the
device instead, by pointer-jumping label propagation.
"""

import numpy as np
import torch

from ..parallel.launch import fetch_with_deadline
from .pairwise import _np_sqdist, _small, _torch, pairwise_sqdist

__all__ = ['connected_components', 'label_propagation_components']


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


def label_propagation_components(tpoints, radiussq, *, device):
    """Components of the radius graph, labelled on *device*.

    Counterpart of ``ultranest_tpu/ops/cluster.py:77-118``: every point
    starts with its own index as label and repeatedly takes the smallest
    label among its neighbours, then the label of that label's owner
    (pointer jumping), until no label changes. The reference's
    ``lax.while_loop`` becomes a host loop whose condition is read from
    the device after each round, under the dispatch deadline.

    Returns
    -------
    labels: int array (N,)
        the smallest member index of each point's component, as
        :func:`connected_components` gives.
    """
    pts = _torch(np.asarray(tpoints, dtype=np.float32), device)
    n = pts.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    # a point is its own neighbour, so the minimum below never loses it
    adj = pairwise_sqdist(pts, pts) <= np.float32(radiussq)
    adj |= torch.eye(n, dtype=torch.bool, device=pts.device)
    labels = torch.arange(n, device=pts.device)
    big = torch.full_like(labels, n)
    while True:
        neigh = torch.where(adj, labels[None, :], big[None, :])
        new = torch.minimum(labels, neigh.amin(dim=1))
        new = torch.minimum(new, labels[new])
        changed = (new != labels).any()
        labels = new
        if not fetch_with_deadline(changed):
            break
    return labels.cpu().numpy().astype(np.int64)
