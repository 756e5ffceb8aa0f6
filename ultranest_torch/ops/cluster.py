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
:func:`radius_graphs` serves a region rebuild's transform layer: on a
CUDA device, for live sets within kernel K8's cap, the cluster labels
and the local centring come from K8 in one call; elsewhere from
:func:`connected_components` and
:func:`ultranest_torch.ops.pairwise.subtract_nearby` as before.
"""

import numpy as np
import torch

from .. import tracing
from ..parallel.launch import fetch_with_deadline
from . import kernels
from .pairwise import (_np_sqdist, _small, _torch, pairwise_sqdist,
                       subtract_nearby)

__all__ = ['connected_components', 'label_propagation_components',
           'radius_graphs']


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


def _radius_graphs_k8(tpoints, radiussq, upoints, device):
    """K8 on *device*: both point sets in one copy there, the labels and
    the centred points back in one blocking copy, as the rebuild reads
    K2's radius."""
    n, d = tpoints.shape
    nd = n * d
    flat = np.empty(nd if upoints is None else 2 * nd, dtype=np.float32)
    flat[:nd] = tpoints.reshape(-1)
    if upoints is not None:
        flat[nd:] = upoints.reshape(-1)
    packed = torch.as_tensor(flat).to(device, non_blocking=True)
    out = kernels.radius_graph(
        packed[:nd].view(n, d),
        None if upoints is None else packed[nd:].view(n, d),
        np.float32(radiussq)).cpu().numpy()
    labels, centred = kernels.radius_graph_parts(out, n)
    return (labels.astype(np.int64),
            None if centred is None else centred.astype(float))


def _k8_serves(device, n, d):
    """Whether K8 takes *n* points of dimension *d* on *device*."""
    return device.type == 'cuda' and kernels.radius_graph_fits(n, d)


def radius_graphs(tpoints, radiussq, upoints=None, *, device):
    """The cluster labels of *tpoints* and, given *upoints*, the local
    centring of *upoints*, at the squared radius *radiussq*.

    On a CUDA *device*, for a live set that :func:`kernels.radius_graph_fits`,
    kernel K8 computes both in one call (booked as ``graph`` under the
    innermost open span of the run in progress: ``rebuild/layer/graph``);
    otherwise :func:`connected_components` and :func:`subtract_nearby`
    do (booked as ``graph_host``). K8's result comes back in one
    blocking copy, as K2's radius does in the same rebuild: region
    rebuilds stay on the sampler's device whatever the dispatch watchdog
    decides (it swaps the samplers only). The two agree but for pairs within
    float32 rounding of the radius, which the host's float64 distances
    may decide the other way, and in the last bits of the centred points.

    Returns
    -------
    labels: int array (N,)
        the smallest member index of each point's component
    centred: float array (N, d) or None
        each of *upoints* minus the mean of the *upoints* within the
        radius of it (None without *upoints*)
    """
    tpoints = np.asarray(tpoints, dtype=np.float32)
    if upoints is not None:
        upoints = np.asarray(upoints, dtype=np.float32)
    n, d = tpoints.shape
    device = torch.device(device)
    if _k8_serves(device, n, d):
        with tracing.count('graph'):
            return _radius_graphs_k8(tpoints, radiussq, upoints, device)
    with tracing.count('graph_host'):
        labels = connected_components(tpoints, radiussq, device=device)
        centred = None if upoints is None else subtract_nearby(
            upoints, radiussq, device=device)
    return labels, centred
