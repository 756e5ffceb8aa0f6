"""K4, ``kernels.spec_propose(u, v, tl, tr, xibank, it)``: one round of
the spec walk's proposals. It reads the walkers' points, directions and
brackets and the round's row of uniforms, and writes the chain, the
shrunk brackets and the candidate rows; 3 operations a candidate and 2 a
candidate's coordinate. Shapes alone set it, so a call captured in a
CUDA graph gives the bound of each replay."""

from ..peaks import bound_s as _bound

ENTRY = 'spec_propose'
KERNELS = ('spec_propose_kernel',)
ONCE = KERNELS[:1]


def record(args, out, captured):
    u, xibank = args[0], args[4]
    return dict(P=int(u.shape[0]), d=int(u.shape[1]), D=int(xibank.shape[2]))


def bound_s(rec):
    P, D, d = rec['P'], rec['D'], rec['d']
    ops = 3 * P * D + 2 * P * D * d
    return _bound(ops, 4 * (2 * P * d + 2 * P + P * D) + 8
                  + 4 * (P * D + 2 * P + P * D * d))
