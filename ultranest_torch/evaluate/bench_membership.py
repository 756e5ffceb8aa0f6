"""Membership shootout on one CUDA card: plain torch vs K1 vs K1t.

Counterpart of ``evaluate/bench_pallas_membership.py``, at its three
shapes and with its inputs (``make_inputs``: unit normals from
``numpy.random.RandomState(seed)``, every live point valid,
``r2 = 4 d``). Three versions of the radius membership test:

* ``plain`` — :func:`ultranest_torch.ops.kernels.radius_member_plain`
  (the script's ``xla``);
* ``K1`` — the row-major CUDA kernel
  :func:`ultranest_torch.ops.kernels.radius_member` (``pallas``);
* ``K1t`` — the transposed-layout CUDA kernel
  :func:`ultranest_torch.ops.kernels.radius_member_t` (``pallas_T``).

Each is timed with CUDA events, mean of 50 warm calls. Before timing,
:func:`check_shape` holds K1 and K1t against the plain version at 65
radii taken from the candidates' own nearest distances, so that each
radius puts candidates exactly on the boundary (at ``r2 = 4 d`` almost
every candidate is a member, and equality there proves little).

Run from the repository root: ``python -m
ultranest_torch.evaluate.bench_membership``. Needs a CUDA device; exits
non-zero without one.
"""

import subprocess
import sys

import numpy as np
import torch

from ..ops import kernels
from ..ops.pairwise import pairwise_sqdist

SHAPES = ((512, 4096, 16), (512, 32768, 2), (1024, 16384, 8))
REPS = 50


def make_inputs(npts=512, m=4096, d=16, seed=0):
    """(tp, tm, cd, r2) as the shootout script makes them."""
    rng = np.random.RandomState(seed)
    tp = rng.normal(size=(npts, d)).astype(np.float32)
    cd = rng.normal(size=(m, d)).astype(np.float32)
    tm = np.ones(npts, np.int32)
    r2 = np.float32(4.0 * d)
    return tp, tm, cd, r2


def nearest_sqdist(tpoints, cands, chunk=16384):
    """Each candidate's squared distance to its nearest row of *tpoints*.

    Summed in the plain version's arithmetic (``pairwise_sqdist``: axis
    order, the product and the sum each rounded), on the tensors' device.
    """
    return torch.cat([pairwise_sqdist(tpoints, cands[c0:c0 + chunk])
                      .min(dim=0).values
                      for c0 in range(0, len(cands), chunk)])


def boundary_radii(tpoints, cands, nradii=65):
    """Squared radii that put candidates exactly on the boundary.

    Quantiles 0.1..0.9 of the candidates' nearest-point distances (the
    median in the middle). A sum rounded differently (an FMA, another
    order) may flip a boundary candidate's membership; at d 2 an FMA
    changes only the last of two roundings, so it takes tens of
    boundary candidates to meet one it flips. Returns (radii, mind).
    """
    mind = nearest_sqdist(tpoints, cands)
    ranked = torch.sort(mind).values.cpu().numpy()
    m = len(ranked)
    return [float(ranked[int(q * (m - 1))])
            for q in np.linspace(0.1, 0.9, nradii)], mind


def check_shape(npts, m, d, device, nradii=65):
    """K1 and K1t against the plain version at boundary radii.

    Raises on any disagreement, or if a radius puts no member on the
    boundary; returns the number of boundary candidates checked.
    """
    tp, tm, cd, _ = make_inputs(npts, m, d)
    tp_d, tm_d, cd_d = (torch.as_tensor(a, device=device)
                        for a in (tp, tm, cd))
    tp_t, cd_t = tp_d.T.contiguous(), cd_d.T.contiguous()
    radii, mind = boundary_radii(tp_d, cd_d, nradii)
    nboundary = 0
    for r2 in radii:
        want = kernels.radius_member_plain(tp_d, tm_d, cd_d, r2)
        k1 = kernels.radius_member(tp_d, tm_d, cd_d, r2)
        k1t = kernels.radius_member_t(tp_t, tm_d, cd_t, r2)
        n1, nt = int((k1 != want).sum()), int((k1t != want).sum())
        assert n1 == 0 and nt == 0, ('membership disagrees', npts, m, d,
                                     r2, n1, nt)
        on = mind == r2
        assert bool(on.any()) and bool(want[on].all()), \
            ('no member on the boundary', npts, m, d, r2)
        nboundary += int(on.sum())
    return nboundary


def cuda_ms(fn, reps):
    """Mean milliseconds per call of *fn* on the card (warm)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def time_shape(npts, m, d):
    """ms per call of the three versions at the script's r2 = 4 d."""
    tp, tm, cd, r2 = make_inputs(npts, m, d)
    tp_d, tm_d, cd_d = (torch.as_tensor(a, device='cuda')
                        for a in (tp, tm, cd))
    tp_t, cd_t = tp_d.T.contiguous(), cd_d.T.contiguous()
    r2 = float(r2)
    return dict(
        npts=npts, m=m, d=d,
        plain_ms=cuda_ms(lambda: kernels.radius_member_plain(
            tp_d, tm_d, cd_d, r2), REPS),
        k1_ms=cuda_ms(lambda: kernels.radius_member(tp_d, tm_d, cd_d, r2),
                      REPS),
        k1t_ms=cuda_ms(lambda: kernels.radius_member_t(tp_t, tm_d, cd_t,
                                                       r2), REPS))


def run():
    """Time every shape; prints and returns one dict per shape."""
    rows = []
    for npts, m, d in SHAPES:
        row = time_shape(npts, m, d)
        rows.append(row)
        print('N=%d M=%d d=%d:  plain %.4f ms   K1 %.4f ms   K1t %.4f ms'
              % (npts, m, d, row['plain_ms'], row['k1_ms'], row['k1t_ms']),
              flush=True)
    return rows


def main():
    if not torch.cuda.is_available():
        print('bench_membership: no CUDA device', file=sys.stderr)
        return 1
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    for npts, m, d in SHAPES:
        nb = check_shape(npts, m, d, 'cuda')
        print('N=%d M=%d d=%d: K1 and K1t equal to plain at 65 radii, %d '
              'candidates on the boundary' % (npts, m, d, nb))
    run()
    return 0


if __name__ == '__main__':
    sys.exit(main())
