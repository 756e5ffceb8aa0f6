# noqa: D400 D205
"""
Device-side live-set consumption
--------------------------------

Counterpart of ``ultranest_tpu/segmentops.py:18-157``. The consume scan
turns a batch of candidate rows into nested-sampling insertions on the
device: each valid row above the current worst live point replaces it
(argmin-replace), so the acceptance threshold rises inside the dispatch
exactly as the host tree would raise it. One record per row is emitted
for the host to replay (``integrator._explore_segments``).

The scan itself is kernel K3 (:func:`ultranest_torch.ops.kernels.consume_scan`).
"""

import torch

from .ops import kernels

__all__ = ['consume_scan', 'pack_segment']

# per-row record layout appended after [u, L]:
# [accept, worst_slot, Lmin, rank, flags(plateau*2 + dup)]
RECORD_COLS = 5


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


def pack_segment(rows_u, rows_L, recs, nc, done_frac):
    """Pack rows + records + a trailing scalar row into one f32 tensor.

    The scalar row holds [nc, done_frac, 0, nc, 0...]: the billed count,
    the valid fraction, the walk width slot (unused by the rejection
    engine) and the useful-work count, equal to the billed count for
    engines without speculative evaluation. *nc* and *done_frac* are 0-d
    device tensors; nothing is copied from the host.
    """
    rows = torch.cat([rows_u, rows_L[:, None], recs], dim=1)
    scalars = torch.zeros((1, rows.shape[1]), dtype=torch.float32,
                          device=rows.device)
    scalars[0, :4] = torch.stack([nc, done_frac, torch.zeros_like(nc), nc])
    return torch.cat([rows, scalars], dim=0)
