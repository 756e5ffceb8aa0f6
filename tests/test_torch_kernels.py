"""The port's three kernels against the JAX package, on the CPU.

On the CPU every wrapper of :mod:`ultranest_torch.ops.kernels` runs its
plain torch version; these tests hold those against the reference:

* K1 radius membership against the Pallas kernel in interpret mode
  (the cases of tests/test_pallas.py), exactly;
* K2 bootstrap radius against the Pallas kernel in interpret mode and
  the XLA ``_radius_kernel``, within rtol 1e-6;
* K3 consume scan against ``ultranest_tpu.segmentops.consume_scan``,
  bit for bit, with +inf padding, duplicates and plateaus.

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
