# noqa: D400 D205
"""
Bootstrapped region radius / ellipsoid enlargement
--------------------------------------------------

Counterpart of ``ultranest_tpu/ops/bootstrap.py``: B rounds of "select a
random subset of live points, wrap them, measure how far the
*unselected* points stick out" (upstream ``mlfriends.pyx:1017-1070``).

* The masks are drawn on the host RandomState, bit-identical to the
  reference (:func:`make_bootstrap_masks`).
* The O(B N^2 d) radius rounds run in kernel K2
  (:func:`ultranest_torch.ops.kernels.bootstrap_radius`) on the device
  the caller must name, or in its plain torch version when that is the
  CPU. With a mesh, each shard runs K2 on its block of rounds and the
  shards' radii are max-reduced: bit-equal to K2 on all rounds, because
  a maximum is exact.
* The ellipsoid enlargement rounds stay batched host numpy in f64
  (:func:`_bootstrap_enlargement`, carried over unchanged).
"""

import numpy as np
import torch

from ..parallel import pmax, shard_count
from ..parallel.launch import fetch_replicated, shard_rows
from . import kernels
from .pairwise import round_up

__all__ = ['bootstrap_radius_enlargement', 'make_bootstrap_masks']


def make_bootstrap_masks(n, nbootstraps, rng=np.random):
    """Draw bootstrap selection masks on the host RNG.

    Each round selects the *set* of points hit by n draws-with-replacement
    (multiplicity ignored, as upstream). Degenerate rounds (all / none
    selected) are dropped, mirroring upstream's ``continue``.

    Returns
    -------
    masks: bool array (nrounds, n)
    """
    masks = np.zeros((nbootstraps, n), dtype=bool)
    # one (B, n) draw consumes the same RandomState stream as B
    # sequential size-n draws (row-major fill)
    idx = rng.randint(n, size=(nbootstraps, n))
    np.put_along_axis(masks, idx, True, axis=1)
    keep = ~(masks.all(axis=1) | ~masks.any(axis=1))
    return masks[keep]


def _numpy_radius(tpoints, masks, K=8):
    """Exact host bootstrap radius via a K-nearest-neighbour table.

    The reference's host path (``ultranest_tpu/ops/bootstrap.py:155-196``),
    carried over so the GPU kernel can be timed against it: with ~63% of
    points selected per round, the nearest *selected* neighbour of an
    unselected point is almost surely among its K=8 nearest overall, so
    one shared (n, K) neighbour table answers every round; misses fall
    back to the exact column scan.
    """
    from .pairwise import _np_sqdist
    n = len(tpoints)
    B = len(masks)
    if B == 0 or n == 0:
        return 0.0
    d2 = _np_sqdist(tpoints, tpoints)
    K = min(K, n)
    dT = np.ascontiguousarray(d2.T)
    if K < n:
        nbr = np.argpartition(dT, K - 1, axis=1)[:, :K]
    else:
        nbr = np.argsort(dT, axis=1)
    dnbr = np.take_along_axis(dT, nbr, axis=1)
    selnbr = masks[:, nbr]
    minds = np.where(selnbr, dnbr[None], np.inf).min(axis=2)
    has = np.isfinite(minds)
    miss_b, miss_j = np.nonzero(~has & ~masks)
    for b, j in zip(miss_b.tolist(), miss_j.tolist()):
        col = d2[masks[b], j]
        minds[b, j] = col.min() if col.size else -np.inf
    minds = np.where(masks, -np.inf, minds)
    return max(0.0, float(minds.max()))


def radius_inputs(tpoints, masks, device):
    """Padded kernel inputs (tpoints f32, valid u8, masks u8) on *device*.

    Rows are padded to the power-of-two bucket of the reference
    (``round_up``); padded rows are invalid and never selected. The three
    arrays ship as ONE host-to-device copy of their bytes and are sliced
    into views (the float32 points first, so that they stay aligned).
    """
    tpoints = np.asarray(tpoints, dtype=np.float32)
    n, d = tpoints.shape
    npd = round_up(n)
    nrounds = len(masks)
    npts = npd * d * 4
    flat = np.zeros(npts + npd + nrounds * npd, dtype=np.uint8)
    flat[:npts].view(np.float32).reshape(npd, d)[:n] = tpoints
    flat[npts:npts + n] = 1
    flat[npts + npd:].reshape(nrounds, npd)[:, :n] = masks
    packed = torch.as_tensor(flat).to(device, non_blocking=True)
    return (packed[:npts].view(torch.float32).view(npd, d),
            packed[npts:npts + npd],
            packed[npts + npd:].view(nrounds, npd))


def _bootstrap_radius(tpoints, masks, device, mesh=None, axis_name=None):
    """Bootstrapped MLFriends radius: kernel K2 on *device*.

    With a *mesh* of more shards than one and at least as many rounds,
    the rounds are padded to a multiple of the shard count with rounds
    that select every point (no unselected point, so they never win the
    maximum; ``ultranest_tpu/ops/bootstrap.py:212-218``), each shard runs
    K2 on its block of rounds and the results are max-reduced.
    """
    nshards = shard_count(mesh, axis_name)
    if nshards == 1 or len(masks) < nshards:
        return float(kernels.bootstrap_radius(
            *radius_inputs(tpoints, masks, device)))
    padded = np.ones((-(-len(masks) // nshards) * nshards, masks.shape[1]),
                     dtype=bool)
    padded[:len(masks)] = masks
    local = kernels.bootstrap_radius(*radius_inputs(
        tpoints, shard_rows(padded, mesh, axis_name), device))
    return float(fetch_replicated(pmax(local, mesh, axis_name)))


def _bootstrap_enlargement(u, masks, mode):
    """Host-side batched ellipsoid enlargement over all bootstrap rounds.

    For each round: center+covariance of the selected subset (with the
    (d+2) uniform-ellipsoid inflation for full-covariance modes), then the
    maximum squared Mahalanobis distance of the unselected points, all
    rounds as BLAS matmuls through the moment identities. ``u`` is
    centered on its global mean first, which bounds the cancellation
    error of the moment form. Carried over from
    ``ultranest_tpu/ops/bootstrap.py:242-304``.
    """
    u = np.asarray(u, dtype=np.float64)
    n, ndim = u.shape
    u = u - u.mean(axis=0)                             # cancellation guard
    w = masks.astype(np.float64)                       # (B, N)
    counts = w.sum(axis=1)                             # (B,)
    ctr = (w @ u) / counts[:, None]                    # (B, d)
    u2 = u * u                                         # (N, d)

    if mode == 'simple':
        # axis-aligned: per-axis variance of the selected points, floored
        # at 1e-30 so a degenerate axis enlarges hugely instead of
        # producing inf - inf = NaN
        var = (w @ u2) / counts[:, None] - ctr * ctr   # (B, d)
        var = np.maximum(var, 1e-30)
        ivar = 1.0 / var
        m = u2 @ ivar.T - 2.0 * (u @ (ctr * ivar).T) \
            + (ctr * ctr * ivar).sum(axis=1)           # (N, B)
        m = m.T
    else:
        # ddof=1 sample covariance, inflated by (d+2)
        outer = (u[:, :, None] * u[:, None, :]).reshape(n, ndim * ndim)
        cov = (w @ outer).reshape(-1, ndim, ndim) \
            - counts[:, None, None] * ctr[:, :, None] * ctr[:, None, :]
        cov /= np.maximum(counts - 1, 1)[:, None, None]
        cov *= (ndim + 2)
        try:
            invcov = np.linalg.inv(cov)
        except np.linalg.LinAlgError:
            return np.nan
        Au = np.matmul(u, invcov)                      # (B, N, d)
        uAu = np.einsum('bnd,nd->bn', Au, u)
        Ac = np.einsum('bij,bj->bi', invcov, ctr)      # (B, d)
        uAc = u @ Ac.T                                 # (N, B)
        cAc = (ctr * Ac).sum(axis=1)                   # (B,)
        m = uAu - 2.0 * uAc.T + cAc[:, None]

    m = np.where(~masks, m, -np.inf)
    return m.max()


def bootstrap_radius_enlargement(upoints, tpoints, masks, mode='mlfriends',
                                 device=None, mesh=None, axis_name=None):
    """Run all bootstrap rounds.

    Parameters
    ----------
    upoints: array (N, d)
        live points in unit-cube space (ellipsoid space)
    tpoints: array (N, d) or None
        live points in whitened space (MLFriends radius space)
    masks: bool array (B, N)
        bootstrap selection masks from :func:`make_bootstrap_masks`
    mode: str
        'mlfriends' (radius + ellipsoid), 'ellipsoid' (robust ellipsoid
        only), 'simple' (axis-aligned), 'wrap' (wrapping ellipsoid)
    device: str or torch.device
        where the radius kernel runs; required in 'mlfriends' mode, the
        only mode that has a radius to compute
    mesh: DeviceMesh or None
        when given, the O(B N^2) radius rounds are split over its shards
        (*axis_name*: over that dimension only) and max-reduced; the
        ellipsoid rounds stay host-batched on every rank

    Returns
    -------
    maxradiussq: float
        MLFriends squared radius (1e300 for ellipsoid-only modes)
    enlarge: float
        squared Mahalanobis enlargement factor
    ok: bool
        False when the computation degenerated (the caller keeps the old
        region, mirroring upstream's exception path)
    """
    if len(masks) == 0:
        return 0.0, np.nan, False

    if mode == 'mlfriends':
        if device is None:
            raise ValueError("mode 'mlfriends' needs a device for kernel K2")
        maxd = _bootstrap_radius(tpoints, masks, device, mesh=mesh,
                                 axis_name=axis_name)
    else:
        maxd = 1e300

    maxf = _bootstrap_enlargement(upoints, masks, mode)

    ok = bool(np.isfinite(maxf) and maxf > 0)
    if mode == 'mlfriends':
        ok = ok and np.isfinite(maxd) and maxd > 0
    return maxd, float(maxf), ok
