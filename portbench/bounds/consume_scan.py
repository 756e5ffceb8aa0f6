"""K3, ``kernels.consume_scan(live_L, rows_L, rows_valid)``: candidate
rows consumed into the live likelihoods in order. Three compares per
live value for each row up to the last valid one (min, rank, dup), two
for each row after it. Bytes: the live and row likelihoods, the valid
flags, the new live likelihoods and five records a row, once."""

from ..peaks import bound_s as _bound

ENTRY = 'consume_scan'
KERNELS = ('scan_chain_warp', 'scan_chain_cta', 'scan_counts')
# one of the two chains runs once a call (the warp's up to 1024 live
# slots, the CTA's above); the counts only where there are rows
ONCE = ('scan_chain_warp', 'scan_chain_cta')


def record(args, out, captured):
    live_L, rows_L, rows_valid = args
    rec = dict(npad=int(live_L.shape[0]), P=int(rows_L.shape[0]))
    if captured:
        return rec
    # the rows' flags are made anew for every call and never written
    # again: keep them, find the last valid row once the window has closed
    rec['valid'] = rows_valid
    return rec


def bound_s(rec):
    if 'valid' not in rec:
        return None
    import numpy as np
    valid = np.flatnonzero(rec['valid'].cpu().numpy() > 0.5)
    npad, P = rec['npad'], rec['P']
    nseq = int(valid[-1]) + 1 if valid.size else 0
    ops = npad * (3 * nseq + 2 * (P - nseq))
    return _bound(ops, 4 * (2 * npad + 2 * P + 5 * P))
