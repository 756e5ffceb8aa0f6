"""The port's kernels against the JAX package, on the CPU.

On the CPU every wrapper of :mod:`ultranest_torch.ops.kernels` runs its
plain torch version; these tests hold those against the reference:

* K1 radius membership against the Pallas kernel in interpret mode
  (the cases of tests/test_pallas.py), exactly;
* K2 bootstrap radius against the Pallas kernel in interpret mode and
  the XLA ``_radius_kernel``, within rtol 1e-6;
* K3 consume scan against ``ultranest_tpu.segmentops.consume_scan``,
  bit for bit, with +inf padding, duplicates and plateaus; and a numpy
  model of the CUDA kernels' own bookkeeping (per-lane minima of
  order-preserving keys, the lowest-slot rule across lanes, one chain
  step per accepted row, and rank, dup and plateau counted from the
  initial live set and the accepted rows' swaps) against the same
  reference on tie-heavy inputs.

The CUDA kernels themselves are held against these plain versions on a
card by tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

from ultranest_tpu.ops.bootstrap import _radius_kernel
from ultranest_tpu.ops.pallas_kernels import (bootstrap_radius_pallas,
                                              radius_member_pallas)
from ultranest_tpu.segmentops import consume_scan as jax_consume_scan
from ultranest_torch import segmentops
from ultranest_torch.ops import kernels
from ultranest_torch.ops.bootstrap import make_bootstrap_masks, radius_inputs
from ultranest_torch.ops.pairwise import pad_rows, round_up


def _member_case(name):
    """(tpoints, tmask, cands, r2) of the three tests/test_pallas.py cases."""
    if name == 'bruteforce':
        rng = np.random.RandomState(0)
        tpoints = rng.normal(size=(100, 3)).astype(np.float32)
        tmask = np.ones(100, bool)
        tmask[80:] = False
        return tpoints, tmask, rng.normal(size=(500, 3)).astype(
            np.float32), 0.5
    if name == 'empty':
        rng = np.random.RandomState(1)
        tpoints = rng.normal(size=(50, 2)).astype(np.float32)
        return tpoints, np.ones(50, bool), tpoints + 10.0, 1e-6
    rng = np.random.RandomState(2)
    # tight cluster far from the origin: the Gram identity's regime of
    # cancellation, where only direct differences resolve distances
    tpoints = (0.8 + 1e-5 * rng.normal(size=(64, 2))).astype(np.float32)
    cands = (0.8 + 1e-5 * rng.normal(size=(128, 2))).astype(np.float32)
    return tpoints, np.ones(64, bool), cands, np.float64(2e-10)


def _port_member(tpoints, tmask, cands, r2):
    return kernels.radius_member(
        torch.as_tensor(tpoints), torch.as_tensor(tmask.astype(np.int32)),
        torch.as_tensor(cands), float(r2)).numpy().astype(bool)


@pytest.mark.parametrize('case', ['bruteforce', 'empty', 'tiny_scales'])
def test_radius_member_matches_pallas(case):
    tpoints, tmask, cands, r2 = _member_case(case)
    want = radius_member_pallas(tpoints, tmask, cands, r2, interpret=True)
    got = _port_member(tpoints, tmask, cands, r2)
    np.testing.assert_array_equal(got, want)
    if case == 'empty':
        assert not got.any()


def test_radius_member_boundary_and_padding():
    """A candidate exactly at r2 is a member; masked rows never count."""
    tpoints = np.array([[0.0, 0.0], [0.3, 0.4], [5.0, 5.0]], np.float32)
    tmask = np.array([1, 1, 0], bool)
    cands = np.array([[0.0, 0.5], [5.0, 5.0], [0.3, 0.4]], np.float32)
    r2 = float(np.float32(0.25))
    got = _port_member(tpoints, tmask, cands, r2)
    want = radius_member_pallas(tpoints, tmask, cands, r2, interpret=True)
    np.testing.assert_array_equal(got, [True, False, True])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('n,d,nboot,seed', [(150, 5, 20, 3), (400, 2, 30, 4),
                                            (37, 3, 10, 5)])
def test_bootstrap_radius_matches_pallas_and_xla(n, d, nboot, seed):
    rng = np.random.RandomState(seed)
    tpoints = rng.normal(size=(n, d)).astype(np.float32)
    masks = make_bootstrap_masks(n, nboot, rng=rng)
    npd = round_up(n)
    valid = pad_rows(np.ones(n, bool), npd, False)
    mk = np.zeros((len(masks), npd), dtype=bool)
    mk[:, :n] = masks
    xla = float(_radius_kernel(pad_rows(tpoints, npd), valid, mk))
    pallas = bootstrap_radius_pallas(tpoints, masks, interpret=True)
    got = float(kernels.bootstrap_radius(*radius_inputs(tpoints, masks,
                                                        'cpu')))
    np.testing.assert_allclose(got, xla, rtol=1e-6)
    np.testing.assert_allclose(got, pallas, rtol=1e-6)


def _scan_inputs(seed, npad, nlive, P, d):
    rng = np.random.RandomState(seed)
    live_u = rng.uniform(size=(npad, d)).astype(np.float32)
    live_L = np.full(npad, np.inf, np.float32)
    live_L[:nlive] = rng.uniform(-5, 0, nlive).astype(np.float32)
    # a plateau at the minimum and duplicates of live values
    live_L[[1, 4, 7]] = live_L[:nlive].min() - 1
    rows_u = rng.uniform(size=(P, d)).astype(np.float32)
    rows_L = rng.uniform(-6, 2, P).astype(np.float32)
    rows_L[5] = live_L[3]
    rows_L[::9] = live_L[rng.randint(nlive, size=len(rows_L[::9]))]
    rows_L[2] = live_L[1]
    rows_L[-3:] = -np.inf                     # compaction padding rows
    rows_valid = (rng.uniform(size=P) < 0.8).astype(np.float32)
    rows_valid[-P // 4:] = 0.0                 # an invalid tail, as compacted
    return live_u, live_L, rows_u, rows_L, rows_valid


@pytest.mark.parametrize('seed,npad,nlive,P,d', [
    (0, 32, 20, 60, 3), (1, 32, 20, 60, 3), (2, 64, 50, 200, 2),
    (3, 512, 400, 1024, 2)])
def test_consume_scan_bit_exact(seed, npad, nlive, P, d):
    args = _scan_inputs(seed, npad, nlive, P, d)
    lu_ref, lL_ref, recs_ref = jax_consume_scan(*args)
    lu, lL, recs = segmentops.consume_scan(*map(torch.as_tensor, args))
    np.testing.assert_array_equal(recs.numpy(), np.asarray(recs_ref))
    np.testing.assert_array_equal(lL.numpy(), np.asarray(lL_ref))
    np.testing.assert_array_equal(lu.numpy(), np.asarray(lu_ref))
    flags = recs.numpy()[:, 4]
    assert (flags >= 2).any() and (flags % 2 == 1).any()


def test_consume_scan_all_invalid_and_empty():
    live_u, live_L, rows_u, rows_L, _ = _scan_inputs(5, 32, 20, 40, 2)
    none = np.zeros(40, np.float32)
    lu_ref, lL_ref, recs_ref = jax_consume_scan(live_u, live_L, rows_u,
                                                rows_L, none)
    lu, lL, recs = segmentops.consume_scan(
        *map(torch.as_tensor, (live_u, live_L, rows_u, rows_L, none)))
    np.testing.assert_array_equal(recs.numpy(), np.asarray(recs_ref))
    np.testing.assert_array_equal(lL.numpy(), live_L)
    lL, recs = kernels.consume_scan(torch.as_tensor(live_L),
                                    torch.zeros(0), torch.zeros(0))
    assert recs.shape == (0, 5) and torch.equal(lL, torch.as_tensor(live_L))


def test_wrappers_route_cpu_to_plain_and_refuse_other_devices():
    kernels.reset_counts()
    tp = torch.zeros((4, 2))
    kernels.radius_member(tp, torch.ones(4, dtype=torch.int32),
                          torch.zeros((128, 2)), 1.0)
    assert kernels.PLAIN_CALLS['radius_member'] == 1
    assert sum(kernels.LAUNCHES.values()) == 0
    meta = torch.zeros((4, 2), device='meta')
    with pytest.raises(ValueError):
        kernels.radius_member(meta, torch.ones(4, dtype=torch.int32,
                                               device='meta'),
                              torch.zeros((8, 2), device='meta'), 1.0)
    with pytest.raises(ValueError):
        kernels.consume_scan(torch.zeros(4), torch.zeros(3, device='meta'),
                             torch.zeros(3))
    assert sum(kernels.LAUNCHES.values()) == 0


# ------------------------------------------- K3's one-warp bookkeeping -----

LANES = 32


def _fkey(v):
    """Order-preserving uint32 keys of float32 values, -0.0 as +0.0."""
    b = np.asarray(v, np.float32).view(np.uint32).copy()
    b[b == 0x80000000] = 0
    return np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint32)


def _k3_model(live_L, rows_L, rows_valid):
    """numpy model of ``csrc/consume_scan.cu`` for npad <= 1024.

    The chain: lane l holds slots k*32 + l (k < K) as keys; slots past
    npad hold the largest key. The minimum g folds the lane minima: the
    minimum key, then the lowest slot among the lanes holding it (not the
    lowest lane). Rows come 32 at a time: the first row of the chunk
    from ``pos`` on that is valid, not NaN and keyed above g is the next
    accepted one; the rows before it are written as rejected under g, the
    owner lane's key is replaced and g folded again. Rows after the last
    valid one get accept 0 and the final minimum. The counts: rank, dup
    and plateau count the initial live values below L_p, equal to L_p and
    equal to Lmin_p (float compares), plus, for each accepted row i < p,
    the change from swapping Lmin_i out for L_i, the earlier rows taken
    256 at a time and compacted, as the kernel takes them.
    """
    npad, P = len(live_L), len(rows_L)
    K = max(4, -(-npad // LANES))
    key = np.full(K * LANES, 0xffffffff, np.uint32)
    key[:npad] = _fkey(live_L)
    key = key.reshape(K, LANES)
    stored = np.zeros(K * LANES, np.float32)
    stored[:npad] = live_L
    stored = stored.reshape(K, LANES)

    def fold():
        m = key.min(axis=0)                       # lane minima
        gkey = m.min()
        holders = np.nonzero(m == gkey)[0]
        slot = min(int(np.argmax(key[:, lane] == gkey)) * LANES + lane
                   for lane in holders)
        return gkey, slot, stored[slot // LANES, slot % LANES]

    valid = rows_valid > 0.5
    nseq = int(np.nonzero(valid)[0].max()) + 1 if valid.any() else 0
    kL = _fkey(rows_L)
    eligible = valid & ~np.isnan(rows_L)
    recs = np.zeros((P, 5), np.float32)
    g = fold()
    for p0 in range(0, nseq, LANES):
        n, pos = min(LANES, nseq - p0), 0
        while pos < n:
            gkey, slot, lmin = g
            acc = [j for j in range(pos, n)
                   if eligible[p0 + j] and kL[p0 + j] > gkey]
            nxt = acc[0] if acc else n
            for j in range(pos, min(nxt + 1, n)):
                recs[p0 + j, :3] = [j == nxt, slot, lmin]
            if nxt < n:
                key[slot // LANES, slot % LANES] = kL[p0 + nxt]
                stored[slot // LANES, slot % LANES] = rows_L[p0 + nxt]
                g = fold()
            pos = nxt + 1
    recs[nseq:, :3] = [0.0, g[1], g[2]]

    L, M = rows_L, recs[:, 2]
    with np.errstate(invalid='ignore'):
        lt = (live_L[None, :] < L[:, None]).sum(axis=1)
        eqL = (live_L[None, :] == L[:, None]).sum(axis=1)
        eqM = (live_L[None, :] == M[:, None]).sum(axis=1)
        block = 256
        for i0 in range(0, P, block):
            idx = [i for i in range(i0, min(i0 + block, P))
                   if recs[i, 0] > 0.5]          # compacted, in order
            for p in range(i0, P):
                for i in idx:
                    if i >= p:
                        break
                    li, mi = rows_L[i], recs[i, 2]
                    lt[p] += int(li < L[p]) - int(mi < L[p])
                    eqL[p] += int(li == L[p]) - int(mi == L[p])
                    eqM[p] += int(li == M[p]) - int(mi == M[p])
    recs[:, 3] = lt
    recs[:, 4] = 2.0 * (eqM > 1) + (eqL > 0)
    return stored.ravel()[:npad].copy(), recs


def _tie_case(case, npad, seed):
    """Tie-heavy scan inputs: live values and rows on a 0.25 grid, the
    minimum held by five slots in four lanes (two in lane 5)."""
    rng = np.random.RandomState(seed)
    nlive = npad * 25 // 32
    live_L = np.full(npad, np.inf, np.float32)
    live_L[:nlive] = rng.randint(-8, 8, nlive).astype(np.float32) * 0.25
    plateau = [70, 37, 5, 99, 12]           # lanes 6, 5, 5, 3, 12
    live_L[plateau] = -3.0
    P = 0 if case == 'empty' else 3 * npad // 2
    rows_L = rng.randint(-14, 10, P).astype(np.float32) * 0.25
    rows_L[::7] = live_L[rng.randint(nlive, size=len(rows_L[::7]))]
    rows_L[1:2] = -3.0
    rows_valid = (rng.uniform(size=P) < 0.8).astype(np.float32)
    rows_valid[P - P // 5:] = 0.0           # an invalid tail
    if case == 'signed_zero':
        live_L[:nlive] = np.abs(live_L[:nlive]) + 0.25
        live_L[plateau] = np.array([-0.0, 0.0, -0.0, 0.0, -0.0], np.float32)
        rows_L[::4] = np.array([-0.0, 0.0, np.inf, -np.inf, np.nan],
                               np.float32)[np.arange(len(rows_L[::4])) % 5]
    if case == 'all_invalid':
        rows_valid[:] = 0.0
    return live_L, rows_L, rows_valid


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize('npad', [128, 256, 512])
@pytest.mark.parametrize('case', ['plateau', 'signed_zero', 'all_invalid',
                                  'empty'])
def test_consume_scan_warp_model_matches_reference(case, npad):
    """The kernel's bookkeeping, modelled in numpy, equals the JAX scan
    bit for bit (signed zeros included), and so does the plain version.

    The reference's coordinate gather raises on an empty batch, so at
    P 0 the model is held to the plain version and to the unchanged
    live set.
    """
    live_L, rows_L, rows_valid = _tie_case(case, npad, npad + len(case))
    mL, mrec = _k3_model(live_L, rows_L, rows_valid)
    pL, prec = kernels.consume_scan_plain(
        *map(torch.as_tensor, (live_L, rows_L, rows_valid)))
    np.testing.assert_array_equal(_bits(mrec), _bits(prec.numpy()))
    np.testing.assert_array_equal(_bits(mL), _bits(pL.numpy()))
    if case == 'empty':
        assert mrec.shape == (0, 5)
        np.testing.assert_array_equal(_bits(mL), _bits(live_L))
        return
    P, d = len(rows_L), 2
    rng = np.random.RandomState(npad)
    _, lL_ref, recs_ref = jax_consume_scan(
        rng.uniform(size=(npad, d)).astype(np.float32), live_L,
        rng.uniform(size=(P, d)).astype(np.float32), rows_L, rows_valid)
    np.testing.assert_array_equal(_bits(mrec), _bits(recs_ref))
    np.testing.assert_array_equal(_bits(mL), _bits(lL_ref))
    accept, flags = mrec[:, 0], mrec[:, 4]
    if case == 'all_invalid':
        assert not accept.any()
        np.testing.assert_array_equal(_bits(mL), _bits(live_L))
    else:
        assert accept.sum() > 5 and (flags >= 2).sum() > 5
        assert (flags % 2 == 1).sum() > 5
    if case == 'signed_zero':
        lmin = _bits(mrec[:, 2])
        assert (lmin == 0x80000000).any() and (lmin == 0).any()
        # the plateau of zeros is consumed lowest slot first, across lanes
        zero_slots = mrec[(mrec[:, 0] > 0.5) & (mrec[:, 2] == 0), 1]
        np.testing.assert_array_equal(zero_slots[:5], [5, 12, 37, 70, 99])
