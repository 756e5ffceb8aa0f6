"""Share of the improvement passes' node visits that the runs consumed
in C (``netiter.py``, ``NodeSweep``; ``native/nodesweep.c``): 100 x the
port's ``improve/sweep`` count over it and the ``improve/count`` count
(the visits of the per-node loop), pooled over the window's fits. None
where no fit booked ``improve/sweep`` (a program without the runs, a
one-pass fit) or no visit was counted."""


def read(run):
    fits = run.fits
    if not any('improve/sweep#' in f['phases'] for f in fits):
        return None
    swept = sum(f['phases'].get('improve/sweep#', 0) for f in fits)
    per_node = sum(f['phases'].get('improve/count#', 0) for f in fits)
    if swept + per_node <= 0:
        return None
    return 100.0 * swept / (swept + per_node)
