# noqa: D400 D205
"""
Device-side live-set consumption
--------------------------------

Counterpart of ``ultranest_tpu/segmentops.py``, shared by the two
segment engines (:mod:`ultranest_torch.fused` and
:mod:`ultranest_torch.popfused`). The consume scan turns a batch of
candidate rows into nested-sampling insertions on the device: each valid
row above the current worst live point replaces it (argmin-replace), so
the acceptance threshold rises inside the dispatch exactly as the host
tree would raise it. One record per row is emitted for the host to
replay (``integrator._explore_segments``).

The scan itself is kernel K3 (:func:`ultranest_torch.ops.kernels.consume_scan`).
Nothing here reads a value back to the host. The two whitening matmuls
run in full float32: TF32 must stay off
(``torch.backends.cuda.matmul.allow_tf32``, False by default).
"""

import torch

from .ops import kernels

__all__ = ['consume_scan', 'pack_segment', 'whitened_jump2',
           'whitened_cloud_var']

# per-row record layout appended after [u, L]:
# [accept, worst_slot, Lmin, rank, flags(plateau*2 + dup)]
# the walk engine (popfused) appends one more column: the whitened
# squared chain travel distance (whitened_jump2)
RECORD_COLS = 5


def whitened_jump2(u0, uf, tpack):
    """Whitened squared travel distance per chain, on the device.

    ``tpack`` is the (d+1, d) float32 pack of
    :meth:`popfused.FusedPopulationSliceSampler._pack_whiten`: the
    layer's whitening matrix T (rows 0..d-1) and a trailing 0/1 mask of
    wrapped (circular) dimensions. Wrapped axes use the minimal-image
    delta (period 1 in cube space).
    """
    delta = uf - u0
    wmask = tpack[-1]
    delta = delta - wmask[None, :] * torch.round(delta)
    wdelta = delta @ tpack[:-1]
    return (wdelta * wdelta).sum(dim=1)


def whitened_cloud_var(live_u, nlive, tpack):
    """Summed per-axis variance of the whitened live cloud, on the device.

    The decorrelation normalizer of the jump-distance diagnostics, taken
    from the dispatch-time live set. ``live_u`` is padded; rows past
    ``nlive`` are masked out.

    Wrapped axes (mask row ``tpack[-1]`` 1, period 1) are measured as
    ``whitened_jump2`` measures a jump: each valid coordinate becomes its
    minimal-image offset ``(u - c) - round(u - c)`` from the cloud's
    circular mean ``c = atan2(mean sin 2 pi u, mean cos 2 pi u) / 2 pi``,
    so a cloud that straddles the seam has the variance it has anywhere
    else on the circle. This differs from the reference on purpose: the
    reference ignores the mask here, its variance comes out inflated on
    wrapped axes and its governor over-doubles nsteps (ROADMAP §C).
    Unwrapped axes are taken as they are, as in the reference.
    """
    m = (torch.arange(live_u.shape[0], device=live_u.device)
         < nlive).to(torch.float32)
    n = torch.clamp(m.sum(), min=1.0)
    wmask = tpack[-1] > 0.5
    ang = (2 * torch.pi) * live_u
    c = torch.atan2((torch.sin(ang) * m[:, None]).sum(dim=0),
                    (torch.cos(ang) * m[:, None]).sum(dim=0)) / (2 * torch.pi)
    delta = live_u - c[None, :]
    delta = delta - torch.round(delta)
    w = torch.where(wmask[None, :], delta, live_u) @ tpack[:-1]
    mean = (w * m[:, None]).sum(dim=0) / n
    dev = (w - mean[None, :]) * m[:, None]
    return (dev * dev).sum() / n


def consume_scan(live_u, live_L, rows_u, rows_L, rows_valid):
    """Consume candidate rows into the live set; returns records.

    Parameters
    ----------
    live_u: (npad, d) float32
        live points, padded
    live_L: (npad,) float32
        live log-likelihoods, padded with +inf (argmin ignores padding)
    rows_u: (P, d) float32
        candidate coordinates, in draw order
    rows_L: (P,) float32
        candidate log-likelihoods
    rows_valid: (P,) float32
        1.0 where the row is a usable candidate

    Returns
    -------
    live_u2, live_L2, recs: updated live state and (P, 5) records
    """
    live_L2, recs = kernels.consume_scan(live_L, rows_L, rows_valid)
    # Coordinates are rebuilt afterwards in one scatter-max pass: a
    # slot's final occupant is the LAST accepted row that replaced it.
    npad, P = live_L.shape[0], rows_L.shape[0]
    accept = recs[:, 0] > 0.5
    slot = torch.where(accept, recs[:, 1].long(), npad)
    last_row = torch.full((npad + 1,), -1, dtype=torch.long,
                          device=live_L.device).scatter_reduce(
        0, slot, torch.arange(P, device=live_L.device), reduce='amax')[:npad]
    src = last_row.clamp(0, max(P - 1, 0))
    live_u2 = torch.where((last_row >= 0)[:, None], rows_u[src], live_u)
    return live_u2, live_L2, recs


def pack_segment(rows_u, rows_L, recs, nc, done_frac, width, nuseful=None,
                 ref2=None):
    """Pack rows + records + a trailing scalar row into one f32 tensor.

    The scalar row holds [nc, done_frac, width, nuseful, ref2, 0...]:
    the billed count, the valid fraction, the mean walk width, the
    useful-work count (evaluations a strictly sequential sampler would
    have needed; engines without speculation omit it and report the
    billed count) and the dispatch-time whitened cloud variance
    (:func:`whitened_cloud_var`; engines without jump diagnostics omit
    it and the slot stays 0). The count slots are float32, exact below
    2**24; the population sampler fetches its exact counts beside the
    pack. Every scalar is a 0-d float32 device tensor: nothing is copied
    from the host.
    """
    rows = torch.cat([rows_u, rows_L[:, None], recs], dim=1)
    vals = [nc, done_frac, width, nc if nuseful is None else nuseful]
    if ref2 is not None:
        vals.append(ref2)
    scalars = torch.zeros((1, rows.shape[1]), dtype=torch.float32,
                          device=rows.device)
    scalars[0, :len(vals)] = torch.stack(vals)
    return torch.cat([rows, scalars], dim=0)
