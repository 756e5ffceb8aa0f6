"""K2, ``kernels.bootstrap_radius(tpoints, valid, masks)``: the
bootstrapped MLFriends radius. Each distance some round needs (from a
point i the round selected to a valid point j it did not) is computed
once, 3 d operations; then one min per (round, selected i, unselected j)
and one max per (round, unselected j). Bytes: the points, the valid
flags, the masks and the radius, once."""


from ..peaks import bound_s as _bound

ENTRY = 'bootstrap_radius'
KERNELS = ('selbits_kernel', 'radius_kernel')
ONCE = KERNELS[:1]


def record(args, out, captured):
    tpoints, valid, masks = args
    # the region's inputs are made anew for every rebuild and never
    # written again: keep them, read them once the window has closed
    return dict(d=int(tpoints.shape[1]), valid=valid, masks=masks)


def bound_s(rec):
    valid = rec['valid'].cpu().numpy().astype(bool)
    sel = rec['masks'].cpu().numpy().astype(bool)
    out = valid[None, :] & ~sel
    nsel = sel.sum(axis=1).astype(float)
    nout = out.sum(axis=1).astype(float)
    mins = float((nsel * nout).sum())
    pairs = float(((sel.T.astype(float) @ out.astype(float)) > 0).sum())
    d = rec['d']
    ops = pairs * 3 * d + mins + float(nout.sum())
    nrounds, npad = sel.shape
    return _bound(ops, 4 * npad * d + npad + nrounds * npad + 4)
