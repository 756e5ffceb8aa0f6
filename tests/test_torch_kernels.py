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
  reference on tie-heavy inputs;
* numpy models of what the redesigned K2 and K1 do beyond the plain
  versions' arithmetic (K2: the rounds as bits, each distance once,
  per-word minima merged on the uint bits; K1: the valid rows squeezed
  out, G lanes a candidate, the chunked vote) against the plain versions
  exactly and against the reference; K1's group-size function;
* the port's own copies of the host C sources against the reference's,
  and that no module of the port names a path of the JAX package.

The CUDA kernels themselves are held against these plain versions on a
card by tests/test_torch_cuda.py.
"""
import ast
import glob
import os
import re

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


# ----------------------------- K2's decomposition: rounds as bits -----
# numpy models of what csrc/bootstrap_radius.cu and csrc/radius_member.cu
# do beyond the plain versions' arithmetic, held against the plain
# versions exactly and against the reference.

def _plain_sqdist(a, b):
    """(len(a), len(b)) float32 squared distances, summed axis by axis
    with the product and the sum each rounded (numpy float32 has no FMA):
    the arithmetic of the kernels and the plain versions."""
    d2 = np.zeros((len(a), len(b)), np.float32)
    with np.errstate(invalid='ignore', over='ignore'):
        for k in range(a.shape[1]):
            diff = a[:, k, None] - b[None, :, k]
            d2 = d2 + diff * diff
    return d2


def _k2_model(tp, valid, masks, lanes=32):
    """numpy model of ``csrc/bootstrap_radius.cu``.

    The rounds become bits (one uint32 word per row and 32 rounds); each
    distance is computed once; lane g of a column's warp takes rows g,
    g + 32, ... and holds one minimum per round of the word, updated
    where the row's bit is set; the lanes' minima merge as uint32 bits;
    column j counts in round b where it is valid and its bit is clear;
    the maximum is taken on the bits, from the bits of 0.0.
    """
    npad = len(tp)
    assert npad % lanes == 0
    B = len(masks)
    nwords = -(-B // 32)
    selbits = np.zeros((nwords, npad), np.uint32)
    for b in range(B):
        selbits[b // 32] |= (masks[b] != 0).astype(np.uint32) << np.uint32(
            b % 32)
    bits = _plain_sqdist(tp, tp).view(np.uint32)       # [row i, column j]
    big = np.array(1e30, np.float32).view(np.uint32)
    colmax = np.zeros(npad, np.uint32)
    for w in range(nwords):
        nb = min(32, B - 32 * w)
        rounds = np.uint32(0xffffffff if nb == 32 else (1 << nb) - 1)
        need = np.where(valid != 0, ~selbits[w] & rounds, np.uint32(0))
        for b in range(nb):
            rowsel = ((selbits[w] >> np.uint32(b)) & 1).astype(bool)
            lane_min = np.where(rowsel[:, None], bits, big).reshape(
                -1, lanes, npad).min(axis=0)            # (lane, column)
            u = lane_min.min(axis=0)                    # the warp's merge
            counts = ((need >> np.uint32(b)) & 1).astype(bool)
            colmax = np.where(counts, np.maximum(colmax, u), colmax)
    return colmax.max(initial=np.uint32(0)).view(np.float32), selbits


def _k2_inputs(n, d, B, seed):
    """Padded (tpoints, valid, masks) numpy arrays: normal points with
    three duplicated pairs, masks selecting ~63% of the rows, the last
    round selecting all but one point."""
    rng = np.random.RandomState(seed)
    tp = rng.normal(size=(n, d)).astype(np.float32)
    tp[[5, 11, 20]] = tp[[6, 12, 21]]
    masks = rng.uniform(size=(B, n)) < 0.63
    masks[:, 0] = True
    masks[:, 1] = False
    masks[-1] = True
    masks[-1, (7 * B) % n] = False
    npd = round_up(n)
    mk = np.zeros((B, npd), np.uint8)
    mk[:, :n] = masks
    return pad_rows(tp, npd), pad_rows(np.ones(n, np.uint8), npd, 0), mk


@pytest.mark.parametrize('d', [2, 8, 40])
@pytest.mark.parametrize('n', [37, 100, 400])
@pytest.mark.parametrize('B', [1, 30, 32, 33, 50, 64])
def test_bootstrap_radius_bit_model(B, n, d):
    """Rounds as bits, distances once, per-word minima on the uint bits:
    equal to the plain version bit for bit, and to the reference (the
    XLA kernel and the Pallas kernel in interpret mode) within 1e-6,
    because XLA on the CPU contracts ``a + b * c`` into an FMA."""
    tp, valid, mk = _k2_inputs(n, d, B, seed=1000 * B + n + d)
    got, selbits = _k2_model(tp, valid, mk)
    assert selbits.shape == (-(-B // 32), len(tp))
    assert not (selbits[-1] >> np.uint32((B - 1) % 32 + 1)).any() \
        or B % 32 == 0
    want = kernels.bootstrap_radius_plain(*map(torch.as_tensor,
                                               (tp, valid, mk))).numpy()
    assert got.view(np.uint32) == want.view(np.uint32), (got, want)
    assert got > 0
    masks = mk[:, :n].astype(bool)
    xla = float(_radius_kernel(tp, valid.astype(bool), mk.astype(bool)))
    pallas = bootstrap_radius_pallas(tp[:n], masks, interpret=True)
    np.testing.assert_allclose(got, xla, rtol=1e-6)
    np.testing.assert_allclose(got, pallas, rtol=1e-6)


def test_bootstrap_radius_bit_model_duplicates_give_zero():
    """Every point equal: every nearest selected neighbour is at distance
    0, and the result is the carry's start, +0.0."""
    tp = np.full((64, 3), 0.25, np.float32)
    valid = np.ones(64, np.uint8)
    mk = (np.random.RandomState(0).uniform(size=(33, 64)) < 0.5).astype(
        np.uint8)
    got, _ = _k2_model(tp, valid, mk)
    want = kernels.bootstrap_radius_plain(*map(torch.as_tensor,
                                               (tp, valid, mk))).numpy()
    assert got.view(np.uint32) == want.view(np.uint32) == 0


# ------------------- K1's decomposition: compaction, groups, the vote -----

def _k1_model(tp, tmask, cands, r2, G, rows_at_a_time=8, seed=0):
    """numpy model of ``csrc/radius_member.cu`` on one tile.

    The valid rows are squeezed out (in an order the kernel does not fix:
    here a permutation); G lanes share a candidate, lane g testing rows
    g, g + G, ..., eight at a time; after each chunk the warp (32 / G
    candidates) votes, a group with a hit stops testing, and the warp
    leaves once all its groups have one. Groups past the last candidate
    count as hit from the start. Returns (member, rows tested).
    """
    rows = np.random.RandomState(seed).permutation(np.nonzero(tmask != 0)[0])
    live = tp[rows]
    nv, M = len(live), len(cands)
    within = _plain_sqdist(live, cands) <= np.float32(r2)
    per_warp = 32 // G
    nwarps = -(-M // per_warp)
    hit = np.ones(nwarps * per_warp, bool)
    hit[:M] = False
    within = np.pad(within, ((0, 0), (0, len(hit) - M)))
    left = np.zeros(nwarps, bool)
    tested = 0
    chunk = G * rows_at_a_time
    for base in range(0, nv, chunk):
        testing = ~hit & ~np.repeat(left, per_warp)
        lane_found = np.zeros((G, len(hit)), bool)
        for g in range(G):
            idx = [base + r * G + g for r in range(rows_at_a_time)
                   if base + r * G + g < nv]
            lane_found[g] = within[idx].any(axis=0)
            tested += len(idx) * int(testing.sum())
        hit |= lane_found.any(axis=0) & testing        # the folded ballot
        left |= hit.reshape(nwarps, per_warp).all(axis=1)
        if left.all():
            break
    return hit[:M], tested


def _k1_inputs(m, seed, npts=200, d=3):
    rng = np.random.RandomState(seed)
    tp = rng.normal(size=(npts, d)).astype(np.float32)
    tmask = (rng.uniform(size=npts) < 0.8).astype(np.int32)
    cands = rng.normal(size=(m, d)).astype(np.float32)
    return tp, tmask, cands


@pytest.mark.parametrize('m', [1, 33, 4096])
@pytest.mark.parametrize('G', [1, 2, 8, 32])
def test_radius_member_group_model(G, m):
    """Equal to the plain version at radii that put candidates exactly on
    the boundary; equal to the Pallas kernel in interpret mode at radii
    just above them (XLA on the CPU contracts ``a + b * c``, which may
    flip a candidate that sits exactly on the boundary)."""
    tp, tmask, cands = _k1_inputs(m, seed=G + m)
    mind = _plain_sqdist(tp[tmask != 0], cands).min(axis=0)
    radii = np.unique(np.quantile(mind, [0.1, 0.5, 0.9],
                                  method='nearest'))
    nlive = int((tmask != 0).sum())
    for r2 in radii:
        got, tested = _k1_model(tp, tmask, cands, r2, G)
        want = kernels.radius_member_plain(
            torch.as_tensor(tp), torch.as_tensor(tmask),
            torch.as_tensor(cands), float(r2)).numpy().astype(bool)
        np.testing.assert_array_equal(got, want)
        assert want[mind == r2].all() and (mind == r2).any()
        # the vote ends the walk early where candidates are inside
        assert tested <= nlive * (-(-m * G // 32) * 32 // G)
        above = float(np.float32(r2) * np.float32(1.001))
        got, _ = _k1_model(tp, tmask, cands, above, G)
        pallas = radius_member_pallas(tp, tmask.astype(bool), cands, above,
                                      interpret=True)
        np.testing.assert_array_equal(got, pallas)
    if m == 4096 and 16 * G <= nlive:       # at least two chunks of rows
        assert tested < nlive * m


@pytest.mark.parametrize('case', ['all_masked', 'r2_zero', 'r2_max',
                                  'nan_candidate'])
@pytest.mark.parametrize('G', [1, 2, 8, 32])
def test_radius_member_group_model_edges(G, case):
    tp, tmask, cands = _k1_inputs(33, seed=G)
    r2 = 0.5
    if case == 'all_masked':
        tmask[:] = 0
    elif case == 'r2_zero':
        r2 = 0.0
        live = np.nonzero(tmask)[0]
        cands[4], cands[9] = tp[live[3]], tp[np.nonzero(tmask == 0)[0][0]]
    elif case == 'r2_max':
        r2 = float(np.finfo(np.float32).max)
        cands[7] = 3e19                       # its distances overflow to inf
    else:
        cands[5, 1] = np.nan
    got, _ = _k1_model(tp, tmask, cands, r2, G)
    want = kernels.radius_member_plain(
        torch.as_tensor(tp), torch.as_tensor(tmask), torch.as_tensor(cands),
        r2).numpy().astype(bool)
    np.testing.assert_array_equal(got, want)
    pallas = radius_member_pallas(tp, tmask.astype(bool), cands, r2,
                                  interpret=True)
    np.testing.assert_array_equal(got, pallas)
    if case == 'all_masked':
        assert not got.any()
    elif case == 'r2_zero':
        assert got[4] and not got[9] and got.sum() == 1
    elif case == 'r2_max':
        assert not got[7] and got.sum() == 32
    else:
        assert not got[5] and got.any()


@pytest.mark.parametrize('d', [2, 16, 40, 100, 2048, 4096])
@pytest.mark.parametrize('npts', [3, 64, 512, 32768])
def test_member_group_size(npts, d):
    """A power of two in 1..32, non-increasing in M; many lanes at the
    region path's smallest draw, one at its largest; above d 32 a block's
    staged candidates stay within their shared memory."""
    sizes = [kernels.member_group_size(m, npts, d)
             for m in (1, 33, 4096, 8192, 32768, 131072, 1 << 20, 1 << 24)]
    assert all(g in (1, 2, 4, 8, 16, 32) for g in sizes)
    assert sizes == sorted(sizes, reverse=True)
    if d > 32:
        assert all((256 // g) * d * 4 <= 128 * 1024 for g in sizes)
    if npts >= 128 and d <= 32:
        assert sizes[0] == 32 and sizes[2] == 16 and sizes[4] == 2 \
            and sizes[5] == 1 and sizes[-1] == 1


# ------------------------------------------- the port stands alone -----

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize('name', ['counters.c', 'stepfuncs.c', 'treesweep.c',
                                  'replay.c'])
def test_native_sources_equal_the_reference(name):
    """The port builds its host library from its own copies of the C
    sources; each stays equal to the reference package's file."""
    from ultranest_torch import native
    assert native._SRC_DIR == os.path.join(_REPO, 'ultranest_torch', 'native')
    assert name in native.SOURCES
    with open(os.path.join(native._SRC_DIR, name), 'rb') as f:
        mine = f.read()
    with open(os.path.join(_REPO, 'ultranest_tpu', 'native', name),
              'rb') as f:
        assert mine == f.read()


def _port_modules():
    """The port's Python files: the package, chip_smoke.py, the ported
    examples and the language runners."""
    out = [os.path.join(_REPO, 'chip_smoke.py')]
    for root, _, files in os.walk(os.path.join(_REPO, 'ultranest_torch')):
        out += [os.path.join(root, f) for f in files if f.endswith('.py')]
    out += glob.glob(os.path.join(_REPO, 'examples', 'torch_port', '*.py'))
    out += glob.glob(os.path.join(_REPO, 'languages', '*', '*_torch.py'))
    return sorted(out)


# the runners in other languages load a Python package by name
_FOREIGN_RUNNERS = ('languages/julia/runjl_torch.jl',
                    'languages/r/runr_torch.r')


def test_port_names_no_path_of_the_reference_package():
    """No module of the port, nor chip_smoke.py, imports jax or the JAX
    package, or names a path under ``ultranest_tpu/`` in code. Docstrings
    stay free to cite the counterpart, and so does a string that is
    nothing but such a citation (``file.py:line``)."""
    citation = re.compile(r'^[\w/.]+\.py:\d+(-\d+)?$')
    modules = _port_modules()
    assert len(modules) > 20
    assert os.path.join(_REPO, 'examples', 'torch_port',
                        'testfeatures.py') in modules
    for name in _FOREIGN_RUNNERS:
        with open(os.path.join(_REPO, name)) as f:
            text = f.read()
        assert 'import("ultranest_torch")' in text, name
        assert 'ultranest_tpu")' not in text, name
    for path in modules:
        with open(path) as f:
            tree = ast.parse(f.read())
        docstrings = set()
        for node in ast.walk(tree):
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef)) \
                    and node.body and isinstance(node.body[0], ast.Expr) \
                    and isinstance(node.body[0].value, ast.Constant):
                docstrings.add(id(node.body[0].value))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or '']
            else:
                names = []
            for name in names:
                assert name.split('.')[0] not in ('jax', 'jaxlib',
                                                  'ultranest_tpu'), \
                    (path, node.lineno, name)
            if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                    and id(node) not in docstrings \
                    and 'ultranest_tpu' in node.value:
                assert citation.match(node.value), (path, node.lineno,
                                                    node.value)
