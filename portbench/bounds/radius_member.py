"""K1, ``kernels.radius_member(tpoints, tmask, cands, r2)``: MLFriends
radius membership. A candidate outside needs its distance to every valid
live point, one inside at least one; each distance costs 3 d operations
and a compare. Bytes: the points, their mask, the candidates and the
answer, once."""

from ..peaks import bound_s as _bound

ENTRY = 'radius_member'
KERNELS = ('radius_member_kernel',)
ONCE = KERNELS


def record(args, out, captured):
    tpoints, tmask, cands = args[0], args[1], args[2]
    rec = dict(npts=int(tpoints.shape[0]), d=int(tpoints.shape[1]),
               m=int(cands.shape[0]))
    if captured:
        return rec
    # the mask and the answer are made anew by every call and never
    # written again: keep them, count once the window has closed
    rec.update(tmask=tmask, member=out)
    return rec


def bound_s(rec):
    if 'tmask' not in rec:
        return None
    m, d, n = rec['m'], rec['d'], rec['npts']
    nvalid = int((rec['tmask'] != 0).sum())
    nmember = int((rec['member'] > 0).sum())
    ops = ((m - nmember) * nvalid + nmember) * (3 * d + 1)
    return _bound(ops, 4 * (n * d + n + m * d + m))
