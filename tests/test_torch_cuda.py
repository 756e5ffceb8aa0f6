"""The port's CUDA kernels against their plain torch versions, on a card.

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports neither jax nor the JAX package, so it also runs where only
torch is installed:

    python -m pytest -q --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""
import collections
import time

import numpy as np
import pytest
import torch

from ultranest_torch import segmentops, tracing
from ultranest_torch.ops import cluster, kernels, pairwise
from ultranest_torch.ops.bootstrap import make_bootstrap_masks, radius_inputs

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    """The CUDA device, decided when the test runs (skip without one)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


GROUPS = (1, 2, 4, 8, 16, 32)


# d <= 32: the candidate in registers (instantiations for d <= 4, 8, 16,
# 32); d 33, 40 and 100: the generic path, candidates staged in shared
# memory; npad 32768: the live set in several tiles; M 1 and 33: ragged
# last warps and groups
@pytest.mark.parametrize('npad,m,d', [(512, 4096, 2), (512, 4096, 16),
                                      (2048, 16384, 8), (64, 130, 3),
                                      (512, 128, 100), (512, 1000, 33),
                                      (512, 4096, 40), (32768, 4096, 2),
                                      (32768, 300, 24), (512, 1, 2),
                                      (512, 33, 5), (100, 33, 32)])
def test_radius_member_equals_plain(cuda, npad, m, d):
    rng = np.random.RandomState(npad + d)
    tp = torch.as_tensor(rng.normal(size=(npad, d)).astype(np.float32),
                         device=cuda)
    tmask = (torch.arange(npad, device=cuda) < npad * 3 // 4).int()
    cands = torch.as_tensor(rng.normal(size=(m, d)).astype(np.float32),
                            device=cuda)
    # nearest valid distances in the plain arithmetic: radii taken from
    # them put a candidate exactly on the boundary
    mind = pairwise.pairwise_sqdist(tp[:npad * 3 // 4], cands).min(dim=0)
    ranked = torch.sort(mind.values).values.cpu().numpy()
    boundary = [float(ranked[int(q * (m - 1))])
                for q in np.linspace(0.1, 0.9, 17)]
    for r2 in [float(np.float32(0.05 * d)), float(np.float32(2.0 * d))] \
            + boundary:
        kernels.reset_counts()
        got = kernels.radius_member(tp, tmask, cands, r2)
        want = kernels.radius_member_plain(tp, tmask, cands, r2)
        assert torch.equal(got, want)
        assert kernels.LAUNCHES['radius_member'] == 1
        if r2 in boundary:
            on = mind.values == r2
            assert bool(on.any()) and bool(want[on].all())
    # every group size the wrapper can choose, forced
    for r2 in boundary[::8]:
        want = kernels.radius_member_plain(tp, tmask, cands, r2)
        for group in GROUPS:
            got = kernels._radius_member_cuda(tp, tmask, cands, r2, group)
            assert torch.equal(got, want), (group, r2)


@pytest.mark.parametrize('d', [2, 8, 40])
@pytest.mark.parametrize('case', ['all_masked', 'nan_rows', 'nan_candidates',
                                  'r2_zero', 'r2_max', 'scattered_mask'])
def test_radius_member_edges(cuda, case, d):
    rng = np.random.RandomState(d)
    tp = rng.normal(size=(300, d)).astype(np.float32)
    tmask = np.ones(300, np.int32)
    cands = rng.normal(size=(777, d)).astype(np.float32)
    # about half of the candidates inside
    r2 = float(np.median(((tp[:, None, :] - cands[None, :, :]) ** 2)
                         .sum(axis=2).min(axis=0)))
    if case == 'all_masked':
        tmask[:] = 0
    elif case == 'nan_rows':
        tp[::3] = np.nan
    elif case == 'nan_candidates':
        cands[::5, d - 1] = np.nan
    elif case == 'r2_zero':
        r2 = 0.0
        cands[10], tmask[7] = tp[20], 0
        cands[11] = tp[7]
    elif case == 'r2_max':
        r2 = float(np.finfo(np.float32).max)
        cands[3] = 3e19
    else:
        tmask[:] = rng.uniform(size=300) < 0.4
    a = [torch.as_tensor(x, device=cuda) for x in (tp, tmask, cands)]
    want = kernels.radius_member_plain(*a, r2)
    assert torch.equal(kernels.radius_member(*a, r2), want)
    for group in GROUPS:
        assert torch.equal(kernels._radius_member_cuda(*a, r2, group), want)
    if case == 'all_masked':
        assert int(want.sum()) == 0
    if case == 'r2_zero':
        assert int(want[10]) == 1 and int(want[11]) == 0
    if case == 'r2_max':
        assert int(want[3]) == 0 and int(want.sum()) == 776
    if case == 'nan_candidates':
        assert int(want[::5].sum()) == 0 and int(want.sum()) > 0


def test_radius_member_refuses_bad_group_and_dim(cuda):
    tp = torch.zeros((8, 2), device=cuda)
    tmask = torch.ones(8, dtype=torch.int32, device=cuda)
    cands = torch.zeros((4, 2), device=cuda)
    for group in (0, 3, 64):
        with pytest.raises(RuntimeError):
            kernels._radius_member_cuda(tp, tmask, cands, 1.0, group)
    big = kernels.MAX_MEMBER_DIM + 1
    with pytest.raises(ValueError):
        kernels.radius_member(torch.zeros((8, big), device=cuda), tmask,
                              torch.zeros((4, big), device=cuda), 1.0)


# B 30: one word of rounds; 32 and 33: the word's edge; 50 (the default
# of MLFriends.compute_maxradiussq) and 64: two words; 70: a second pass
# over the rows; d 40: the column read from shared memory; (3000, 100):
# rows in several tiles
@pytest.mark.parametrize('nrounds', [1, 30, 32, 33, 50, 64, 70])
@pytest.mark.parametrize('n,d', [(400, 2), (2048, 8), (37, 3), (300, 40),
                                 (100, 2), (200, 8), (3000, 100)])
def test_bootstrap_radius_equals_plain(cuda, n, d, nrounds):
    rng = np.random.RandomState(n)
    tp = rng.normal(size=(n, d)).astype(np.float32)
    tp[[5, 11]] = tp[[6, 12]]
    masks = make_bootstrap_masks(n, nrounds, rng=rng)
    masks[-1] = True
    masks[-1, n // 2] = False            # a round that leaves one point out
    args = radius_inputs(tp, masks, cuda)
    kernels.reset_counts()
    got = kernels.bootstrap_radius(*args)
    assert kernels.LAUNCHES['bootstrap_radius'] == 1
    want = kernels.bootstrap_radius_plain(*args)
    # bit for bit: the kernel rounds as the plain version does, and min
    # and max are exact in any order
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
        (float(got), float(want))
    assert float(got) > 0


def test_bootstrap_radius_edges(cuda):
    """No rounds and all points equal give 0.0; a round that selects
    nothing gives the sentinel, as the plain version does; a second call
    does not see the first one's result."""
    tp = np.random.RandomState(0).normal(size=(64, 3)).astype(np.float32)
    masks = make_bootstrap_masks(64, 30, rng=np.random.RandomState(1))
    args = radius_inputs(tp, masks, cuda)
    first = kernels.bootstrap_radius(*args)
    for a in (radius_inputs(tp, masks[:0], cuda),
              radius_inputs(np.full((64, 3), 0.5, np.float32), masks, cuda),
              radius_inputs(tp, np.zeros((3, 64), bool), cuda),
              radius_inputs(0.1 * tp, masks, cuda)):
        got, want = kernels.bootstrap_radius(*a), \
            kernels.bootstrap_radius_plain(*a)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert float(first) > float(got) > 0
    # valid rows need not be a prefix
    tpv, valid, mk = args
    valid = valid.clone()
    valid[::3] = 0
    got = kernels.bootstrap_radius(tpv, valid, mk)
    want = kernels.bootstrap_radius_plain(tpv, valid, mk)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# npad <= 1024: the live set in one warp's registers (128, 256, 512 as
# the port runs them, 1024 the largest); above it in one CTA's shared
# memory, past 48 KB (16384, 32768) with the opt-in attribute. 'valid':
# every row a finished walker, as on the spec path; 'ascending': every
# row valid and accepted, the chain's longest; 'special': signed zeros
# at the minimum, and -0.0, +0.0, NaN and +-inf rows.
@pytest.mark.parametrize('npad,P,kind', [
    (512, 1024, 'mixed'), (64, 200, 'mixed'), (4096, 1024, 'mixed'),
    (16384, 256, 'mixed'), (128, 300, 'mixed'), (256, 600, 'mixed'),
    (1024, 1024, 'mixed'), (32768, 256, 'mixed'), (512, 4096, 'valid'),
    (512, 1024, 'special'), (512, 0, 'mixed'), (512, 4096, 'ascending'),
    (4096, 1024, 'ascending')])
def test_consume_scan_equals_plain(cuda, npad, P, kind):
    rng = np.random.RandomState(npad)
    nlive = npad * 3 // 4
    live_L = np.full(npad, np.inf, np.float32)
    live_L[:nlive] = rng.uniform(-5, 0, nlive).astype(np.float32)
    live_L[[1, 4, 7]] = live_L[:nlive].min() - 1
    rows_L = rng.uniform(-6, 2, P).astype(np.float32)
    rows_L[::9] = live_L[rng.randint(nlive, size=len(rows_L[::9]))]
    rows_L[P - 3:] = -np.inf
    rows_valid = (rng.uniform(size=P) < 0.8).astype(np.float32)
    rows_valid[P - P // 4:] = 0.0
    if kind in ('valid', 'ascending'):
        rows_valid[:] = 1.0
    if kind == 'ascending':
        rows_L = np.linspace(-4, 6, P).astype(np.float32)
    if kind == 'special':
        live_L[:nlive] = np.abs(live_L[:nlive]) + 0.25
        live_L[[1, 4, 7, 40]] = np.array([0.0, -0.0, 0.0, -0.0], np.float32)
        rows_L[::4] = np.array([-0.0, 0.0, np.nan, np.inf, -np.inf],
                               np.float32)[np.arange(len(rows_L[::4])) % 5]
    live_u = rng.uniform(size=(npad, 2)).astype(np.float32)
    rows_u = rng.uniform(size=(P, 2)).astype(np.float32)
    a = [torch.as_tensor(x, device=cuda) for x in (live_L, rows_L,
                                                    rows_valid)]
    kernels.reset_counts()
    gL, grec = kernels.consume_scan(*a)
    assert kernels.LAUNCHES['consume_scan'] == 1
    wL, wrec = kernels.consume_scan_plain(*a)
    # bit for bit: torch.equal alone takes -0.0 for +0.0
    assert torch.equal(gL.view(torch.int32), wL.view(torch.int32))
    assert torch.equal(grec.view(torch.int32), wrec.view(torch.int32))
    if P == 0:
        return
    gu = segmentops.consume_scan(torch.as_tensor(live_u, device=cuda),
                                 a[0], torch.as_tensor(rows_u, device=cuda),
                                 a[1], a[2])
    cu = segmentops.consume_scan(*map(torch.as_tensor, (live_u, live_L,
                                                        rows_u, rows_L,
                                                        rows_valid)))
    for x, y in zip(gu, cu):
        assert torch.equal(x.cpu().view(torch.int32), y.view(torch.int32))


def test_wrappers_check_inputs(cuda):
    tp = torch.zeros((8, 2), device=cuda)
    with pytest.raises(TypeError):
        kernels.radius_member(tp, torch.ones(8, device=cuda),
                              torch.zeros((4, 2), device=cuda), 1.0)
    with pytest.raises(ValueError):
        kernels.radius_member(tp, torch.ones(8, dtype=torch.int32,
                                             device=cuda),
                              torch.zeros((4, 3), device=cuda), 1.0)
    with pytest.raises(ValueError):
        kernels.consume_scan(torch.zeros(8, device=cuda),
                             torch.zeros(3, device=cuda),
                             torch.zeros(3))


def test_large_neighbour_queries_run_on_the_card(cuda, monkeypatch):
    """Above the host threshold the neighbour helpers and the clustering
    graph run as torch on the card, and agree with the host f64 route
    (``_np_sqdist``)."""
    rng = np.random.RandomState(3)
    n = 1500
    a = rng.uniform(size=(n, 2))
    b = rng.uniform(size=(n, 2))
    r2 = 2.0 / n
    ids = rng.randint(0, 4, size=n)

    def helpers():
        return dict(
            maxr=pairwise.compute_maxradiussq(a, b, device=cuda),
            count=pairwise.count_nearby(a, b, r2, device=cuda),
            find=pairwise.find_nearby(a, b, r2, device=cuda),
            sub=pairwise.subtract_nearby(a, r2, device=cuda),
            match=pairwise.match_clusters(a, ids, b, r2, device=cuda),
            labels=cluster.connected_components(a, r2, device=cuda))

    monkeypatch.setattr(pairwise, 'HOST_WORK_THRESHOLD', 1 << 62)
    host = helpers()
    seen = []
    sqdist = pairwise.pairwise_sqdist

    def spy(x, y):
        seen.append(x.device.type)
        return sqdist(x, y)
    monkeypatch.setattr(pairwise, 'HOST_WORK_THRESHOLD', 0)
    monkeypatch.setattr(pairwise, 'pairwise_sqdist', spy)
    monkeypatch.setattr(cluster, 'pairwise_sqdist', spy)
    card = helpers()
    mean_pair = pairwise.compute_mean_pair_distance(a, ids, device=cuda)
    assert seen == ['cuda'] * 7
    np.testing.assert_allclose(card['maxr'], host['maxr'], rtol=1e-6)
    for k in ('count', 'find', 'match', 'labels'):
        np.testing.assert_array_equal(card[k], host[k], err_msg=k)
    np.testing.assert_allclose(card['sub'], host['sub'], rtol=1e-5,
                               atol=1e-6)
    d = np.sqrt(pairwise._np_sqdist(a, a))
    same = np.triu((ids[:, None] == ids[None, :]) & (ids > 0)[:, None], 1)
    np.testing.assert_allclose(mean_pair, d[same].mean(), rtol=1e-5)


def test_segment_dispatch_does_not_synchronize(cuda):
    """Queued segment dispatches never wait for the device.

    ``torch.cuda.set_sync_debug_mode('error')`` raises on any operation
    that synchronizes with the device, such as ``.item()``, ``nonzero``
    or boolean-mask indexing.
    """
    from ultranest_torch import fused
    from ultranest_torch.mlfriends import LocalAffineLayer, MLFriends
    rng = np.random.RandomState(1)
    u = 0.5 + 0.05 * rng.normal(size=(400, 3))
    layer = LocalAffineLayer()
    layer.optimize(u, u)
    region = MLFriends(u, layer, device=cuda)
    region.maxradiussq, region.enlarge = region.compute_enlargement(
        nbootstraps=30, rng=rng)
    region.create_ellipsoid()

    def loglike(x):
        return -0.5 * (((x - 0.5) / 0.05) ** 2).sum(dim=1)

    s = fused.FusedRegionSampler(loglike, None, 3, seed=2, device=cuda)
    s.segment_start(u, -0.5 * (((u - 0.5) / 0.05) ** 2).sum(axis=1),
                    ndraw=4096)
    for method_i in range(len(fused.METHOD_CYCLE)):
        s._seg_method_i = method_i
        s.segment_launch(region)          # warm: caches, pinned blocks
    torch.cuda.synchronize()
    kernels.reset_counts()
    torch.cuda.set_sync_debug_mode('error')
    try:
        for method_i in range(len(fused.METHOD_CYCLE)):
            s._seg_method_i = method_i
            s.segment_launch(region)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    assert kernels.LAUNCHES['radius_member'] == 4
    assert kernels.LAUNCHES['consume_scan'] == 4
    for _ in range(8):
        rec = s.segment_fetch()
        assert np.isfinite(rec['Lmin']).all()


def test_gauss_run_on_card(cuda):
    """A small run through the main path on the card, gated on logZ."""
    from ultranest_torch import ReactiveNestedSampler
    from ultranest_torch.models.problems import gauss
    prob = gauss(3)
    s = ReactiveNestedSampler(
        prob.param_names, prob.loglike, vectorized=True, seed=4,
        torch_loglike=prob.torch_loglike, device=cuda, ndraw_min=1024,
        ndraw_max=8192)
    kernels.reset_counts()
    res = s.run(min_num_live_points=200, viz_callback=False,
                show_status=False, max_num_improvement_loops=0, min_ess=0,
                dlogz=0.5, frac_remain=0.1)
    assert s._segment_exits
    assert abs(res['logz'] - prob.logz) < max(4 * res['logzerr'], 1.0)
    for name in kernels.REGION_KERNELS:
        assert kernels.LAUNCHES[name] > 0, name


@pytest.mark.parametrize('npts,m,d', [(512, 4096, 16), (512, 32768, 2),
                                      (1024, 16384, 8)])
def test_radius_member_t_equals_plain_and_k1(cuda, npts, m, d):
    """K1t at the membership shootout's shapes, 65 boundary radii."""
    from ultranest_torch.evaluate import bench_membership
    kernels.reset_counts()
    assert bench_membership.check_shape(npts, m, d, cuda) >= 65
    assert kernels.LAUNCHES['radius_member_t'] == 65
    assert kernels.LAUNCHES['radius_member'] == 65


# d <= 32: the candidate in registers; d 33, 40, 100: candidates staged in
# shared memory from axis-major rows; N 32768: the live set in several
# tiles; M 1, 33: ragged last warps and groups
@pytest.mark.parametrize('npts,m,d', [(512, 4096, 16), (512, 32768, 2),
                                      (1024, 16384, 8), (512, 4096, 40),
                                      (512, 1000, 33), (512, 128, 100),
                                      (32768, 4096, 2), (32768, 300, 24),
                                      (64, 130, 3), (512, 1, 2),
                                      (100, 33, 32)])
def test_radius_member_t_groups_and_signed_mask(cuda, npts, m, d):
    """K1t with every group size forced, at boundary radii, with a mask
    of 1, 1, 0, -1: a negative entry is an invalid row, as in the plain
    version."""
    from ultranest_torch.evaluate import bench_membership
    rng = np.random.RandomState(npts + d)
    tp = torch.as_tensor(rng.normal(size=(npts, d)).astype(np.float32),
                         device=cuda)
    cd = torch.as_tensor(rng.normal(size=(m, d)).astype(np.float32),
                         device=cuda)
    tm = torch.as_tensor(np.array([1, 1, 0, -1], np.int32)[
        np.arange(npts) % 4], device=cuda)
    tp_t, cd_t = tp.T.contiguous(), cd.T.contiguous()
    radii, mind = bench_membership.boundary_radii(tp[tm > 0], cd, nradii=17)
    sign_matters = False
    for r2 in radii:
        want = kernels.radius_member_t_plain(tp_t, tm, cd_t, r2)
        kernels.reset_counts()
        assert torch.equal(kernels.radius_member_t(tp_t, tm, cd_t, r2), want)
        assert kernels.LAUNCHES['radius_member_t'] == 1
        for group in GROUPS:
            got = kernels._radius_member_t_cuda(tp_t, tm, cd_t, r2, group)
            assert torch.equal(got, want), (group, r2)
        on = mind == r2
        assert bool(on.any()) and bool(want[on].all())
        # K1 on the same rows laid out row-major, its mask the valid rows
        assert torch.equal(kernels.radius_member(tp, (tm > 0).int(), cd, r2),
                           want)
        sign_matters |= not torch.equal(
            want, kernels.radius_member_t_plain(tp_t, tm.abs(), cd_t, r2))
    assert sign_matters or m == 1


@pytest.mark.parametrize('d', [2, 8, 40])
@pytest.mark.parametrize('case', ['all_masked', 'all_negative', 'nan_rows',
                                  'nan_candidates', 'r2_zero', 'r2_max'])
def test_radius_member_t_edges(cuda, case, d):
    rng = np.random.RandomState(d)
    tp = rng.normal(size=(300, d)).astype(np.float32)
    tm = np.ones(300, np.int32)
    cd = rng.normal(size=(777, d)).astype(np.float32)
    r2 = float(np.median(((tp[:, None, :] - cd[None, :, :]) ** 2)
                         .sum(axis=2).min(axis=0)))
    if case == 'all_masked':
        tm[:] = 0
    elif case == 'all_negative':
        tm[:] = -1
    elif case == 'nan_rows':
        tp[::3] = np.nan
    elif case == 'nan_candidates':
        cd[::5, d - 1] = np.nan
    elif case == 'r2_zero':
        r2 = 0.0
        cd[10], tm[7] = tp[20], -1
        cd[11] = tp[7]
    else:
        r2 = float(np.finfo(np.float32).max)
        cd[3] = 3e19
    a = [torch.as_tensor(np.ascontiguousarray(x), device=cuda)
         for x in (tp.T, tm, cd.T)]
    want = kernels.radius_member_t_plain(*a, r2)
    assert torch.equal(kernels.radius_member_t(*a, r2), want)
    for group in GROUPS:
        assert torch.equal(kernels._radius_member_t_cuda(*a, r2, group), want)
    if case in ('all_masked', 'all_negative'):
        assert int(want.sum()) == 0
    if case == 'r2_zero':
        assert int(want[10]) == 1 and int(want[11]) == 0
    if case == 'r2_max':
        assert int(want[3]) == 0 and int(want.sum()) == 776
    if case == 'nan_candidates':
        assert int(want[::5].sum()) == 0 and int(want.sum()) > 0


def test_radius_member_t_refuses_bad_group_and_dim(cuda):
    tp_t = torch.zeros((2, 8), device=cuda)
    tm = torch.ones(8, dtype=torch.int32, device=cuda)
    cd_t = torch.zeros((2, 4), device=cuda)
    for group in (0, 3, 64):
        with pytest.raises(RuntimeError):
            kernels._radius_member_t_cuda(tp_t, tm, cd_t, 1.0, group)
    big = kernels.MAX_MEMBER_DIM + 1
    with pytest.raises(ValueError):
        kernels.radius_member_t(torch.zeros((big, 8), device=cuda), tm,
                                torch.zeros((big, 4), device=cuda), 1.0)
    # the largest dimension it takes: 8 candidates a block in shared memory
    d = kernels.MAX_MEMBER_DIM
    tp_t = torch.randn((d, 8), device=cuda)
    cd_t = torch.randn((d, 40), device=cuda)
    r2 = 2.0 * d
    assert torch.equal(kernels.radius_member_t(tp_t, tm, cd_t, r2),
                       kernels.radius_member_t_plain(tp_t, tm, cd_t, r2))


def test_consume_scan_spec_shape_equals_plain(cuda):
    """K3 at the spec path's shape: 4096 walker rows, all valid, into a
    live set of 400 padded to 512."""
    rng = np.random.RandomState(11)
    npad, nlive, P = 512, 400, 4096
    live_L = np.full(npad, np.inf, np.float32)
    live_L[:nlive] = rng.uniform(-60, -50, nlive).astype(np.float32)
    rows_L = rng.uniform(-62, -45, P).astype(np.float32)
    rows_L[::97] = live_L[rng.randint(nlive, size=len(rows_L[::97]))]
    a = [torch.as_tensor(x, device=cuda)
         for x in (live_L, rows_L, np.ones(P, np.float32))]
    gL, grec = kernels.consume_scan(*a)
    wL, wrec = kernels.consume_scan_plain(*a)
    assert torch.equal(gL, wL) and torch.equal(grec, wrec)
    assert 0 < int(wrec[:, 0].sum()) < P


def _spec_sampler(cuda, d=8, popsize=256, nlive=200, seed=3):
    from ultranest_torch.mlfriends import ScalingLayer, SimpleRegion
    from ultranest_torch.models.problems import asymgauss
    from ultranest_torch.popfused import FusedPopulationSliceSampler
    prob = asymgauss(d)
    rng = np.random.RandomState(seed)
    # live points from a box around the peak, as a mid-run live set
    sigma = np.logspace(-1, -2, d)
    centers = (np.sin(np.arange(d) / 2.0) * (1 - 5 * sigma) + 1.0) / 2.0
    u = np.clip(centers + 2 * sigma * rng.uniform(-1, 1, size=(nlive, d)),
                1e-3, 1 - 1e-3)
    layer = ScalingLayer()
    layer.optimize(u, u)
    region = SimpleRegion(u, layer, device=cuda)
    region.maxradiussq, region.enlarge = region.compute_enlargement(
        nbootstraps=30, rng=rng)
    region.create_ellipsoid()
    s = FusedPopulationSliceSampler(popsize=popsize, nsteps=2 * d,
                                    torch_loglike=prob.torch_loglike,
                                    seed=seed, device=cuda)
    return s, region, u, prob.loglike(u)


def test_spec_dispatch_reads_the_host_as_stated(cuda):
    """A spec segment dispatch waits for the card only in its flag reads.

    Under ``set_sync_debug_mode('error')`` any implicit synchronisation
    (``.item()``, ``nonzero``, a copy from pageable memory) raises. The
    walk's own reads go through a CUDA event, one every
    ``SPEC_CHECK_EVERY`` rounds, one check behind the queued rounds:
    ``reads == rounds // SPEC_CHECK_EVERY - 1`` for a walk that stopped
    on its flag (PERF.md, "Host reads per dispatch").
    """
    from ultranest_torch.popfused import SPEC_CHECK_EVERY, spec_max_rounds
    s, region, u, L = _spec_sampler(cuda)
    s.segment_start(u, L)
    s.segment_launch(region)              # warm: caches, pinned blocks
    torch.cuda.synchronize()
    kernels.reset_counts()
    stats = []
    torch.cuda.set_sync_debug_mode('error')
    try:
        for _ in range(3):
            s.segment_launch(region)
            stats.append(s.walk_log[-1])
    finally:
        torch.cuda.set_sync_debug_mode('default')
    assert kernels.LAUNCHES['consume_scan'] == 3
    cap = spec_max_rounds(s.nsteps, s.max_it, s.spec_depth)
    for st in stats:
        assert st['rounds'] < cap, st
        assert st['reads'] == st['rounds'] // SPEC_CHECK_EVERY - 1, st
        assert st['reads'] <= -(-cap // SPEC_CHECK_EVERY)
    for _ in range(4):
        rec = s.segment_fetch()
        assert rec['done_frac'] == 1.0 and rec['accept'].any()
        assert np.isfinite(rec['jump2']).all() and rec['ref2_dev'] > 0
        assert rec['nc_useful'] <= rec['nc']


def test_asymgauss_spec_run_on_card(cuda):
    """A small run of the spec path on the card, gated on logZ."""
    from ultranest_torch import ReactiveNestedSampler
    from ultranest_torch.mlfriends import ScalingLayer, SimpleRegion
    from ultranest_torch.models.problems import asymgauss
    from ultranest_torch.popfused import FusedPopulationSliceSampler
    prob = asymgauss(8)
    s = ReactiveNestedSampler(prob.param_names, prob.loglike,
                              vectorized=True, seed=2, device=cuda)
    s.transform_layer_class = ScalingLayer
    s.stepsampler = FusedPopulationSliceSampler(
        popsize=512, nsteps=16, torch_loglike=prob.torch_loglike, seed=2,
        device=cuda)
    kernels.reset_counts()
    res = s.run(min_num_live_points=200, viz_callback=False,
                show_status=False, max_num_improvement_loops=0, min_ess=0,
                dlogz=2.0, frac_remain=0.1, region_class=SimpleRegion,
                cluster_num_live_points=0)
    assert s._segment_exits
    assert kernels.LAUNCHES['consume_scan'] > 0
    assert sum(kernels.PLAIN_CALLS.values()) == 0
    assert abs(res['logz']) < max(4 * res['logzerr'], 1.5)


@pytest.mark.parametrize('engine', ['sync', 'async', 'rwalk'])
def test_engine_dispatch_reads_the_host_as_stated(cuda, engine):
    """Each engine's segment dispatch waits for the card only in the
    flag reads of :func:`ultranest_torch.popfused._drive_rounds`, and
    runs as CUDA graphs.

    Under ``set_sync_debug_mode('error')`` any implicit synchronisation
    raises. The async walk is the spec walk at depth 1: ``reads ==
    rounds // SPEC_CHECK_EVERY - 1``. The sync walk's rounds run on
    across step boundaries, a graph of ``SYNC_CHECK_EVERY`` rounds a
    replay, its flag read one chunk behind: ``reads == rounds //
    SYNC_CHECK_EVERY - 1``. The random walk has a fixed trip count, is
    one graph replayed once and reads nothing.
    """
    from ultranest_torch.popfused import (FusedPopulationRandomWalkSampler,
                                          SPEC_CHECK_EVERY,
                                          SYNC_CHECK_EVERY)
    s, region, u, L = _spec_sampler(cuda)
    if engine == 'rwalk':
        s = FusedPopulationRandomWalkSampler(
            popsize=s.popsize, nsteps=s.nsteps, scale=0.1,
            torch_loglike=s.torch_loglike, seed=3, device=cuda)
    else:
        s.engine = engine
    s.segment_start(u, L)
    s.segment_launch(region)              # warm: caches, pinned blocks
    torch.cuda.synchronize()
    kernels.reset_counts()
    stats = []
    torch.cuda.set_sync_debug_mode('error')
    try:
        for _ in range(3):
            s.segment_launch(region)
            stats.append(s.walk_log[-1])
    finally:
        torch.cuda.set_sync_debug_mode('default')
    assert kernels.LAUNCHES['consume_scan'] == 3
    for st in stats:
        assert st['nsteps'] == s.nsteps
        assert st['graph'] and st['captures'] == 0, st
        if engine == 'rwalk':
            assert st['reads'] == 0 and st['rounds'] == s.nsteps, st
            assert st['replays'] == 1, st
        elif engine == 'sync':
            assert st['rounds'] < s.nsteps * s.max_it, st
            assert st['rounds'] % SYNC_CHECK_EVERY == 0, st
            assert st['reads'] == st['rounds'] // SYNC_CHECK_EVERY - 1, st
            assert st['replays'] == st['rounds'] // SYNC_CHECK_EVERY, st
        else:
            assert st['reads'] == st['rounds'] // SPEC_CHECK_EVERY - 1, st
    for _ in range(4):
        rec = s.segment_fetch()
        assert rec['done_frac'] == 1.0 and rec['accept'].any()
        assert np.isfinite(rec['jump2']).all()
        assert rec['nc_useful'] == rec['nc'] > 0


def test_governed_gauss_run_on_card(cuda):
    """A small adaptive-nsteps run on the card: nsteps grows, every walk
    ran at the nsteps of its dispatch, logZ within the bench gate."""
    from ultranest_torch import ReactiveNestedSampler
    from ultranest_torch.mlfriends import ScalingLayer, SimpleRegion
    from ultranest_torch.models.problems import gauss
    from ultranest_torch.popfused import FusedPopulationSliceSampler
    prob = gauss(ndim=10, sigma=0.1)
    s = ReactiveNestedSampler(prob.param_names, prob.loglike,
                              vectorized=True, seed=1, device=cuda)
    s.transform_layer_class = ScalingLayer
    ss = s.stepsampler = FusedPopulationSliceSampler(
        popsize=256, nsteps=2, torch_loglike=prob.torch_loglike, seed=1,
        adaptive_nsteps=True, max_nsteps=64, device=cuda)
    kernels.reset_counts()
    res = s.run(min_num_live_points=200, viz_callback=False,
                show_status=False, max_num_improvement_loops=0, min_ess=0,
                dlogz=2.0, frac_remain=0.1, region_class=SimpleRegion,
                cluster_num_live_points=0)
    assert s._segment_exits and ss.nsteps > 2, ss.nsteps
    walked = [w['nsteps'] for w in ss.walk_log]
    assert walked == sorted(walked) and walked[-1] == ss.nsteps
    assert kernels.LAUNCHES['consume_scan'] > 0
    assert sum(kernels.PLAIN_CALLS.values()) == 0
    assert abs(res['logz']) < max(4 * res['logzerr'], 2.0)


@pytest.mark.parametrize('n,d', [(400, 2), (4096, 8)])
def test_label_propagation_on_card(cuda, n, d):
    """Device label propagation equals connected_components at the
    MLFriends radius of the points (their largest nearest-neighbour
    distance, doubled), the labels being the smallest member index."""
    rng = np.random.RandomState(n + d)
    pts = np.concatenate([rng.normal(c, 0.05, size=(n // 4, d))
                          for c in rng.uniform(0, 1, size=(4, d))])
    d2 = pairwise.pairwise_sqdist(torch.as_tensor(pts, dtype=torch.float32,
                                                  device=cuda),
                                  torch.as_tensor(pts, dtype=torch.float32,
                                                  device=cuda))
    d2.fill_diagonal_(float('inf'))
    r2 = 4 * float(d2.min(dim=1).values.max())
    got = cluster.label_propagation_components(pts, r2, device=cuda)
    want = cluster.connected_components(pts, r2, device=cuda)
    np.testing.assert_array_equal(got, want)
    assert 1 <= len(np.unique(got)) < n


def _graph_points(n, d, seed=0):
    """(u, t, r2): *n* points of dimension *d* in 18 blobs of the unit
    cube, whitened per axis into t, and the MLFriends-like radius of t
    (its largest nearest-neighbour distance, doubled): the blobs are the
    components."""
    rng = np.random.RandomState(seed + n + d)
    centres = rng.uniform(0.1, 0.9, size=(18, d))
    u = (centres[rng.randint(18, size=n)]
         + rng.normal(0, 0.01, size=(n, d))).clip(1e-3, 1 - 1e-3)
    t = (u - u.mean(axis=0)) / u.std(axis=0) if n > 1 else u
    tt = torch.as_tensor(t, dtype=torch.float32)
    d2 = pairwise.pairwise_sqdist(tt, tt)
    d2.fill_diagonal_(float('inf'))
    return u, t, 4 * float(d2.min(dim=1).values.max()) if n > 1 else 1.0


def _graph_against_routes(cuda, u, t, r2, monkeypatch):
    """K8 on (u, t, r2) against its plain version, label propagation on
    the card (labels equal) and subtract_nearby's torch route on the card
    (1e-5 relative); labels alone, and a second call bit-equal."""
    n = len(t)
    tt = torch.as_tensor(t, dtype=torch.float32, device=cuda)
    uu = torch.as_tensor(u, dtype=torch.float32, device=cuda)
    kernels.reset_counts()
    out = kernels.radius_graph(tt, uu, r2)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['radius_graph'] == 1
    assert sum(kernels.PLAIN_CALLS.values()) == 0
    labels, centred = kernels.radius_graph_parts(out, n)
    want_labels, want_centred = kernels.radius_graph_parts(
        kernels.radius_graph_plain(tt, uu, r2), n)
    assert torch.equal(labels, want_labels)
    np.testing.assert_array_equal(
        labels.cpu().numpy(),
        cluster.label_propagation_components(t, r2, device=cuda))
    np.testing.assert_allclose(centred.cpu().numpy(),
                               want_centred.cpu().numpy(), rtol=1e-5,
                               atol=1e-6)
    monkeypatch.setattr(pairwise, 'HOST_WORK_THRESHOLD', 0)
    np.testing.assert_allclose(
        centred.cpu().numpy(), pairwise.subtract_nearby(u, r2, device=cuda),
        rtol=1e-5, atol=1e-6)
    monkeypatch.undo()
    alone = kernels.radius_graph(tt, None, r2)
    torch.cuda.synchronize()
    assert torch.equal(alone, labels)
    again = kernels.radius_graph(tt, uu, r2)
    torch.cuda.synchronize()
    assert torch.equal(again, out)
    assert kernels.LAUNCHES['radius_graph'] == 3
    return labels


# the rebuilds' shapes (400 and 800 live points, 864 the widest of an
# improvement pass, d 8), then the edges: one point, one block, the cap
# at d 32 and at d 8
@pytest.mark.parametrize('n,d', [(400, 2), (800, 2), (864, 2), (400, 8),
                                 (1, 2), (33, 5), (384, 32), (1536, 8)])
def test_radius_graph_equals_plain_and_the_card_routes(cuda, n, d,
                                                       monkeypatch):
    u, t, r2 = _graph_points(n, d)
    labels = _graph_against_routes(cuda, u, t, r2, monkeypatch)
    if n >= 400:
        assert 10 <= len(torch.unique(labels)) <= 18
    # a radius equal to a pair's distance (the nearest neighbour's of a
    # middle point): that pair is adjacent (<=)
    if n > 1:
        tt = torch.as_tensor(t, dtype=torch.float32)
        d2 = pairwise.pairwise_sqdist(tt, tt)
        d2.fill_diagonal_(float('inf'))
        r2b = float(d2.min(dim=1).values.median())
        _graph_against_routes(cuda, u, t, r2b, monkeypatch)


@pytest.mark.parametrize('d', [2, 8])
def test_radius_graph_cap_and_beyond(cuda, d):
    """At the cap the rebuild's route takes K8, one point beyond it the
    host path; both agree with label propagation and the centring."""
    cap = kernels.MAX_GRAPH_ELEMS // d
    for n, route in ((cap, 'graph'), (cap + 1, 'graph_host')):
        u, t, r2 = _graph_points(n, d, seed=1)
        kernels.reset_counts()
        spans = tracing.Spans()
        with spans.running():
            labels, centred = cluster.radius_graphs(t, r2, u, device=cuda)
        torch.cuda.synchronize()
        assert spans[route + '#'] == 1
        assert kernels.LAUNCHES['radius_graph'] == (route == 'graph')
        np.testing.assert_array_equal(
            labels, cluster.label_propagation_components(t, r2, device=cuda))
        np.testing.assert_allclose(
            centred, pairwise.subtract_nearby(u, r2, device=cuda),
            rtol=1e-5, atol=1e-6)


def test_eggbox_rebuilds_take_k8(cuda):
    """Every transform layer of an eggbox run on the card comes from K8:
    one launch and one ``layer/graph`` a ``create_new``, no host graph."""
    from ultranest_torch import ReactiveNestedSampler, mlfriends
    from ultranest_torch.models.problems import eggbox
    prob = eggbox()
    s = ReactiveNestedSampler(
        prob.param_names, prob.loglike, transform=prob.transform,
        vectorized=True, seed=5, torch_loglike=prob.torch_loglike,
        torch_transform=prob.torch_transform, device=cuda,
        ndraw_min=4096, ndraw_max=32768)
    made = []
    create_new = mlfriends.LocalAffineLayer.create_new

    def counted(self, *a, **k):
        made.append(len(a[0]))
        return create_new(self, *a, **k)
    mlfriends.LocalAffineLayer.create_new = counted
    try:
        kernels.reset_counts()
        res = s.run(min_num_live_points=400, viz_callback=False,
                    show_status=False, max_num_improvement_loops=0,
                    min_ess=0, dlogz=0.5, frac_remain=0.1)
    finally:
        mlfriends.LocalAffineLayer.create_new = create_new
    spans = s._segment_phase_s
    graph = sum(v for k, v in spans.items() if k.endswith('/graph#'))
    assert made and graph == len(made) == kernels.LAUNCHES['radius_graph']
    assert not any(k.endswith('graph_host#') for k in spans)
    assert sum(kernels.PLAIN_CALLS.values()) == 0
    assert abs(res['logz'] - 235.856) < max(4 * res['logzerr'], 1.0)


def test_deadline_raises_behind_a_spin_kernel(cuda):
    """A read queued behind ~2 s of device work, with a 0.3 s deadline,
    raises DeviceLostError; the same read without a deadline completes."""
    import time
    from ultranest_torch.parallel import launch
    x = torch.arange(4, device=cuda)
    torch.cuda.synchronize()
    launch.fetch_with_deadline(x, deadline=5.0)
    torch.cuda._sleep(4_000_000_000)       # ~2 s at the H100's 1.98 GHz
    handle = launch.start_fetch(x)
    t0 = time.monotonic()
    with pytest.raises(launch.DeviceLostError):
        launch.finish_fetch(handle, deadline=0.3)
    assert 0.3 <= time.monotonic() - t0 < 1.0
    np.testing.assert_array_equal(launch.finish_fetch(handle, deadline=0),
                                  [0, 1, 2, 3])


def test_contbox_torch_transform_on_card(cuda):
    """A ``.torch`` contbox transform on the card against its host
    closure, in float64 (the envelopes taken in the input's dtype)."""
    from ultranest_torch.hotstart import get_auxiliary_contbox_parameterization
    rng = np.random.RandomState(3)
    upoints = rng.normal(0.5, 0.03, size=(400, 2)).clip(1e-3, 1 - 1e-3)
    names, aux_ll, aux_tr, _ = get_auxiliary_contbox_parameterization(
        ['a', 'b'], lambda x: -((x - 0.5) ** 2).sum(axis=1), lambda x: x,
        upoints, np.ones(400) / 400, vectorized=True,
        torch_loglike=lambda x: -((x - 0.5) ** 2).sum(dim=1))
    u = rng.uniform(0.01, 0.99, size=(256, 3))
    u[:2, -1] = [0.0, 1.0]
    got = aux_tr.torch(torch.as_tensor(u, device=cuda))
    assert got.device.type == 'cuda'
    np.testing.assert_allclose(got.cpu().numpy(), aux_tr(u), rtol=1e-12,
                               atol=1e-14)
    got32 = aux_tr.torch(torch.as_tensor(u, dtype=torch.float32,
                                         device=cuda)).cpu().numpy()
    np.testing.assert_allclose(got32, aux_tr(u), atol=1e-4)
    np.testing.assert_allclose(
        aux_ll.torch(torch.as_tensor(aux_tr(u), device=cuda)).cpu().numpy(),
        aux_ll(aux_tr(u)), rtol=1e-12)


def test_collectives_on_a_world_one_nccl_group(cuda):
    """all_gather_rows, psum, pmax and pmean on CUDA tensors over a
    one-rank NCCL group return their inputs, on the card."""
    import socket

    import torch.distributed as dist

    from ultranest_torch import parallel
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    dist.init_process_group('nccl', init_method='tcp://127.0.0.1:%d' % port,
                            world_size=1, rank=0)
    try:
        mesh = parallel.make_mesh()
        assert mesh.device_type == 'cuda'
        assert dist.get_backend(mesh.get_group()) == 'nccl'
        x = torch.arange(12, dtype=torch.float32, device=cuda).reshape(6, 2)
        c = torch.tensor([2**40 + 3, 7], dtype=torch.int64, device=cuda)
        got = parallel.all_gather_rows(x, mesh)
        assert got.device == x.device and torch.equal(got, x)
        assert torch.equal(parallel.psum(c, mesh), c)
        assert torch.equal(parallel.pmax(x, mesh), x)
        assert torch.equal(parallel.pmean(x, mesh), x)
    finally:
        dist.destroy_process_group()


def _spec_round_inputs(cuda, P, D, d, nsteps=6, seed=0):
    """A spec-walk state mid-dispatch, its round's bank row and the
    likelihoods of its candidates, with the cases K5 must get right:
    walkers done already, walkers at their last step, rounds without a
    hit, directions with zero axes (both signs) and points on a face."""
    from ultranest_torch import popfused
    rng = np.random.RandomState(seed + P + D + d)
    f32 = np.float32
    walk = popfused._SpecWalk(P, D, d, nsteps, 5, P, cuda)
    st = walk.state
    u = rng.uniform(0.05, 0.95, size=(P, d)).astype(f32)
    u[::7, 0] = 0.0
    u[3::7, -1] = 1.0
    v = (rng.normal(size=(P, d)) * 0.1).astype(f32)
    v[::5, 0] = 0.0
    v[1::5, 0] = -0.0
    st['u'].copy_(torch.as_tensor(u))
    st['v'].copy_(torch.as_tensor(v))
    tl, tr = kernels.cube_intersection(st['u'], st['v'])
    st['tl'].copy_(tl)
    st['tr'].copy_(tr)
    st['L'].copy_(torch.as_tensor(rng.normal(size=P).astype(f32)))
    st['step'].copy_(torch.as_tensor(rng.randint(0, nsteps, size=P)))
    st['done'].copy_(torch.as_tensor(rng.uniform(size=P) < 0.2))
    st['it'].fill_(2)
    xibank = walk.xibank.copy_(torch.as_tensor(
        rng.uniform(size=(5, P, D)).astype(f32)))
    dirbank = (rng.normal(size=(nsteps, P, d)) * 0.1).astype(f32)
    dirbank[:, ::3, 1 % d] = 0.0
    dirbank[:, 1::3, 0] = -0.0
    dirbank = walk.dirbank.copy_(torch.as_tensor(dirbank))
    Lp = torch.as_tensor(rng.normal(size=P * D).astype(f32), device=cuda)
    tin = torch.as_tensor(rng.uniform(size=P * D) < 0.8, device=cuda)
    Lmin = walk.Lmin.fill_(0.9)
    return st, xibank, dirbank, Lp, tin, Lmin


def _same_bits(a, b):
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


@pytest.mark.parametrize('P,D,d', [(4096, 8, 50), (2048, 8, 100),
                                   (256, 8, 30), (128, 8, 8), (256, 8, 10),
                                   (128, 1, 8), (100, 40, 3), (33, 3, 1)])
@pytest.mark.parametrize('with_tin', [True, False])
def test_spec_kernels_equal_plain(cuda, P, D, d, with_tin):
    """K4 and K5 bit for bit against their plain versions on the card."""
    st, xibank, dirbank, Lp, tin, Lmin = _spec_round_inputs(cuda, P, D, d)
    tin = tin if with_tin else None
    kernels.reset_counts()
    got = kernels.spec_propose(st['u'], st['v'], st['tl'], st['tr'], xibank,
                               st['it'])
    want = kernels.spec_propose_plain(st['u'], st['v'], st['tl'], st['tr'],
                                      xibank, st['it'])
    for a, b in zip(got, want):
        assert _same_bits(a, b)
    ts, tlc, trc, _ = want
    plain = {k: t.clone() for k, t in st.items()}
    kernels.spec_update(Lp, tin, ts, tlc, trc, Lmin, dirbank, st)
    kernels.spec_update_plain(Lp, tin, ts, tlc, trc, Lmin, dirbank, plain)
    torch.cuda.synchronize()
    for k in kernels.SPEC_STATE:
        assert _same_bits(st[k], plain[k]), k
    assert kernels.LAUNCHES['spec_propose'] == 1 == \
        kernels.LAUNCHES['spec_update']
    assert sum(kernels.PLAIN_CALLS.values()) == 0
    assert int(st['it']) == 3 and int(st['nw']) > 0


def _graph_walk_inputs(cuda, P=512, D=8, d=8, nsteps=12, seed=5):
    from ultranest_torch import popfused
    from ultranest_torch.models.problems import asymgauss
    prob = asymgauss(d)
    rng = np.random.RandomState(seed)
    nlive = 200
    u = np.clip(0.5 + 0.05 * rng.normal(size=(nlive, d)), 0.01, 0.99)
    L = prob.loglike(u).astype(np.float32)
    live_u = torch.as_tensor(u, dtype=torch.float32, device=cuda)
    live_L = torch.as_tensor(L, device=cuda)
    axes = torch.diag(live_u.std(dim=0))
    g = torch.Generator(device=cuda).manual_seed(seed)
    R = popfused.spec_max_rounds(nsteps, 64, D) + 3
    banks = popfused.draw_spec_banks(g, P, D, nsteps, R, nlive, d)
    return prob, banks, live_u, live_L, nlive, axes, live_L.min(), nsteps


def test_graph_walk_equals_host_loop_and_counts_replays(cuda):
    """The rounds as CUDA graphs give the host loop's bits; each replay
    adds its graph's launches to LAUNCHES, a capture adds none."""
    from ultranest_torch import popfused
    prob, banks, live_u, live_L, nlive, axes, Lmin, nsteps = \
        _graph_walk_inputs(cuda)

    def ev(rows):
        return prob.torch_loglike(rows).to(torch.float32), None
    args = (banks, live_u, live_L, nlive, axes, Lmin, 1.0, ev, nsteps)
    host = {}
    kernels.reset_counts()
    want = popfused.spec_walk(*args, stats=host)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES['spec_propose'] == host['rounds']
    graphs = popfused.SpecGraphs('asymgauss')
    for n in range(2):
        stats = {}
        kernels.reset_counts()
        got = popfused.spec_walk(*args, stats=stats, graphs=graphs)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert _same_bits(a, b)
        assert stats['graph'] and stats['rounds'] == host['rounds']
        assert stats['reads'] == host['reads']
        # the round cap is no multiple of SPEC_CHECK_EVERY: a chunk
        # graph and a one-round graph
        assert stats['captures'] == (2 if n == 0 else 0)
        assert stats['rounds'] < banks['xibank'].shape[0]
        # the warm-up round before a capture launches for real
        assert kernels.LAUNCHES['spec_propose'] == \
            kernels.LAUNCHES['spec_update'] == stats['rounds'] + (n == 0)
        assert stats['replays'] == stats['rounds'] // \
            popfused.SPEC_CHECK_EVERY
    assert sum(kernels.PLAIN_CALLS.values()) == 0


def test_graph_dispatch_syncs_only_at_its_flag_reads(cuda):
    """A spec segment dispatch of the sampler runs as graphs; under
    ``set_sync_debug_mode('error')`` nothing but its flag reads waits."""
    s, region, u, L = _spec_sampler(cuda)
    s.segment_start(u, L)
    s.segment_launch(region)              # captures
    torch.cuda.synchronize()
    assert s.walk_log[-1]['graph'] and s.walk_log[-1]['captures'] == 1
    kernels.reset_counts()
    torch.cuda.set_sync_debug_mode('error')
    try:
        for _ in range(3):
            s.segment_launch(region)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    walks = s.walk_log[-3:]
    assert all(w['graph'] and w['captures'] == 0 and w['replays'] > 0
               for w in walks)
    rounds = sum(w['rounds'] for w in walks)
    assert kernels.LAUNCHES['spec_propose'] == rounds == \
        kernels.LAUNCHES['spec_update']
    for _ in range(4):
        assert s.segment_fetch()['done_frac'] == 1.0


def test_uncapturable_likelihood_warns_and_runs_the_kernels(cuda):
    """A likelihood that reads a value to the host cannot be captured:
    one warning names it, the walk logs ``graph`` False, runs K4 and K5
    from the host loop and gives the capturable likelihood's bits; the
    stream and the allocator stay usable."""
    from ultranest_torch import popfused
    prob, banks, live_u, live_L, nlive, axes, Lmin, nsteps = \
        _graph_walk_inputs(cuda, P=256, seed=7)

    def ev(rows):
        return prob.torch_loglike(rows).to(torch.float32), None

    def reads_the_host(rows):
        if float(rows[0, 0].item()) > 2.0:      # never: a host read
            rows = rows * 1.0
        return ev(rows)
    args = (banks, live_u, live_L, nlive, axes, Lmin, 1.0)
    want = popfused.spec_walk(*args, ev, nsteps)
    graphs = popfused.SpecGraphs('reads_the_host')
    stats = {}
    kernels.reset_counts()
    with pytest.warns(RuntimeWarning, match='reads_the_host'):
        got = popfused.spec_walk(*args, reads_the_host, nsteps, stats=stats,
                                 graphs=graphs)
    torch.cuda.synchronize()
    assert graphs.failed and not stats['graph']
    assert kernels.LAUNCHES['spec_propose'] >= stats['rounds'] > 0
    for a, b in zip(got, want):
        assert _same_bits(a, b)
    assert torch.cuda.current_stream() == torch.cuda.default_stream()
    again = {}
    popfused.spec_walk(*args, reads_the_host, nsteps, stats=again,
                       graphs=graphs)
    assert not again['graph'] and again['captures'] == 0
    ok = {}
    got = popfused.spec_walk(*args, ev, nsteps, stats=ok,
                             graphs=popfused.SpecGraphs('ev'))
    for a, b in zip(got, want):
        assert _same_bits(a, b)
    assert ok['graph']


# --- K4 and K5 as redesigned for Hopper ------------------------------------

def _edge_round_inputs(cuda, P, D, d, seed=11):
    """:func:`_spec_round_inputs` with NaN chain values (a NaN in the
    bank, a bracket of -inf to +inf), chain values of zero (a bracket of
    -1 to 1 cut at its middle), zeros of both signs in the points,
    directions and brackets, and NaN and tied likelihoods."""
    st, xibank, dirbank, Lp, tin, Lmin = _spec_round_inputs(cuda, P, D, d,
                                                            seed=seed)
    it = int(st['it'])
    xibank[it, ::11, 0] = float('nan')
    st['tl'][1::13] = -float('inf')
    st['tr'][1::13] = float('inf')
    st['tl'][2::13] = -1.0
    st['tr'][2::13] = 1.0
    xibank[it, 2::13, :] = 0.5
    st['tl'][3::13] = -0.0
    st['tr'][4::13] = 0.0
    st['u'][5::13, 0] = -0.0
    st['v'][6::13, :] = 0.0
    st['v'][7::13, :] = -0.0
    Lp[::9] = float('nan')
    Lp[4::9] = Lmin
    return st, xibank, dirbank, Lp, tin, Lmin


# P not a multiple of K4's 256-vector tile nor of K5's walkers a block;
# D 1 and 40 (two ballots of 32); d 1 and 3 (scalar rows), 8, 16, 17,
# 50 (8-byte rows), 100 (16-byte rows; K5's coordinates 65 to 128, four
# a lane), 130 (K5's coordinates above 128, read after the ballot)
@pytest.mark.parametrize('P,D,d', [(4097, 8, 50), (2047, 8, 100),
                                   (37, 1, 1), (129, 1, 3), (255, 8, 8),
                                   (77, 8, 16), (300, 3, 17), (65, 5, 50),
                                   (31, 8, 100), (70, 12, 130),
                                   (5, 40, 8), (1, 8, 3)])
@pytest.mark.parametrize('with_tin', [True, False])
def test_spec_kernels_at_the_edges(cuda, P, D, d, with_tin):
    """K4 and K5 bit for bit against their plain versions on NaN chain
    values, signed zeros and NaN likelihoods, at ragged tiles."""
    st, xibank, dirbank, Lp, tin, Lmin = _edge_round_inputs(cuda, P, D, d)
    tin = tin if with_tin else None
    prop = (st['u'], st['v'], st['tl'], st['tr'], xibank, st['it'])
    got = kernels.spec_propose(*prop)
    want = kernels.spec_propose_plain(*prop)
    for a, b in zip(got, want):
        assert _same_bits(a, b)
    assert torch.isnan(want[0]).any()
    ts, tlc, trc, _ = want
    plain = {k: t.clone() for k, t in st.items()}
    kernels.spec_update(Lp, tin, ts, tlc, trc, Lmin, dirbank, st)
    kernels.spec_update_plain(Lp, tin, ts, tlc, trc, Lmin, dirbank, plain)
    torch.cuda.synchronize()
    for k in kernels.SPEC_STATE:
        assert _same_bits(st[k], plain[k]), k


@pytest.mark.parametrize('d', [100, 50, 3])
def test_spec_propose_on_unaligned_rows(cuda, d):
    """Points and directions that are views one float into a buffer:
    K4 falls back to narrower accesses and keeps the bits."""
    P, D = 96, 8
    st, xibank, _, _, _, _ = _spec_round_inputs(cuda, P, D, d)
    u = torch.empty(P * d + 1, device=cuda)[1:].view(P, d).copy_(st['u'])
    v = torch.empty(P * d + 1, device=cuda)[1:].view(P, d).copy_(st['v'])
    assert kernels.propose_vector_width(d, u, v) == 1
    assert kernels.propose_vector_width(d, st['u'], st['v']) == \
        (4 if d % 4 == 0 else 2 if d % 2 == 0 else 1)
    prop = (u, v, st['tl'], st['tr'], xibank, st['it'])
    for a, b in zip(kernels.spec_propose(*prop),
                    kernels.spec_propose_plain(*prop)):
        assert _same_bits(a, b)


def test_depth_probe_times_a_graph_and_decides_the_same_twice(cuda):
    """The probe times the likelihood as a captured graph's replay; two
    samplers probed afresh choose the same depth (the bench's depth 8
    for both problems)."""
    from ultranest_torch import popfused
    from ultranest_torch.models.problems import asymgauss, rosenbrock
    for prob, popsize in ((asymgauss(50), 4096), (rosenbrock(8), 128)):
        depths = []
        for _ in range(2):
            popfused._PROBE_CACHE.clear()
            s = popfused.FusedPopulationSliceSampler(
                popsize=popsize, nsteps=4, torch_loglike=prob.torch_loglike,
                torch_transform=prob.torch_transform, device=cuda)
            s._resolve_spec_depth(prob.ndim)
            assert s.spec_probe['how'] == 'graph'
            assert 0 <= s.spec_probe['t_row_s'] < 1e-3
            assert 0 < s.spec_probe['fixed_s'] + s.spec_probe['t_row_s'] \
                < 1e-3
            depths.append(s.spec_depth)
        assert depths[0] == depths[1] == 8, (prob.name, depths)
    popfused._PROBE_CACHE.clear()


def _walk_wall(popfused, ev, cuda, D, P=512, d=8, nsteps=12, trials=3):
    """Best wall seconds of one spec walk at depth *D* run as graphs (its
    graphs captured before)."""
    _, banks, live_u, live_L, nlive, axes, Lmin, _ = _graph_walk_inputs(
        cuda, P=P, D=D, d=d, nsteps=nsteps)
    graphs = popfused.SpecGraphs('heavy')
    args = (banks, live_u, live_L, nlive, axes, Lmin, 1.0, ev, nsteps)
    best = float('inf')
    for i in range(trials + 1):
        stats = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        popfused.spec_walk(*args, stats=stats, graphs=graphs)
        torch.cuda.synchronize()
        assert stats['graph']
        if i:
            best = min(best, time.perf_counter() - t0)
    return best


def test_depth_probe_lowers_the_depth_of_a_costly_likelihood(cuda):
    """A likelihood whose device time grows with its rows (a 4096-wide
    layer a row, in float32): the graph-timed probe charges it to t_row,
    lowers the depth below 8 on both of two calls, and the walk at that
    depth takes no more wall time than at depth 8."""
    from ultranest_torch import popfused
    from ultranest_torch.models.problems import asymgauss
    prob = asymgauss(8)
    g = torch.Generator(device=cuda).manual_seed(3)
    w1 = torch.randn((8, 4096), device=cuda, generator=g)
    w2 = torch.randn((4096, 4096), device=cuda, generator=g) / 64

    def costly(x):
        h = torch.tanh(x @ w1) @ w2
        return prob.torch_loglike(x) + 0.0 * torch.tanh(h[:, 0])
    depths = []
    for _ in range(2):
        popfused._PROBE_CACHE.clear()
        s = popfused.FusedPopulationSliceSampler(
            popsize=512, nsteps=12, torch_loglike=costly, device=cuda)
        s._resolve_spec_depth(8)
        p = s.spec_probe
        assert p['how'] == 'graph'
        assert p['t_row_s'] > 0.22 * (p['round_overhead_s'] + p['fixed_s'])
        depths.append(s.spec_depth)
    popfused._PROBE_CACHE.clear()
    assert depths[0] == depths[1] < 8, depths

    def ev(rows):
        return costly(rows).to(torch.float32), None
    lowered = _walk_wall(popfused, ev, cuda, depths[0])
    at8 = _walk_wall(popfused, ev, cuda, 8)
    assert lowered <= at8, (depths[0], lowered, at8)


def test_round_overhead_replays_the_host_loops_rounds(cuda):
    """A, the round without the likelihood, from a captured chunk of
    rounds: a positive device time, and the state the host loop's rounds
    with the same constant likelihood leave."""
    from ultranest_torch import popfused
    P, D, d = 512, 8, 10
    st, xibank, dirbank, Lp, _, Lmin = _spec_round_inputs(cuda, P, D, d,
                                                          nsteps=40)
    st['it'].zero_()
    st['done'].zero_()
    st['step'].zero_()
    # the same rounds from the host, on a walk started from st
    walk = popfused._SpecWalk(P, D, d, 40, 8, P, cuda)
    walk.xibank.copy_(torch.rand((8, P, D), device=cuda))
    walk.dirbank.copy_(dirbank)
    walk.Lmin.copy_(Lmin)
    walk.evaluate = lambda rows: (Lp, None)
    walk.start = st
    walk.init()
    for _ in range(8):
        walk.round()
    want = walk.state
    a = popfused.round_overhead(st, walk.xibank, dirbank, Lmin, Lp,
                                trials=3)
    torch.cuda.synchronize()
    assert 0 < a < 1e-3
    for k in want:
        assert _same_bits(st[k], want[k]), k
    assert 0 < popfused.measure_round_overhead(256, 8, 8, 16, device=cuda,
                                               trials=2) < 1e-3


def test_depth_probe_of_an_uncapturable_likelihood_times_the_eager_call(
        cuda):
    """A likelihood that reads a value to the host cannot be captured:
    the probe's capture marks the sampler's graphs failed (one warning
    naming it), so its walks will run from the host loop, and the probe
    times the eager calls they will pay."""
    from ultranest_torch import popfused
    from ultranest_torch.models.problems import asymgauss
    prob = asymgauss(8)

    def reads_the_host(x):
        if float(x[0, 0].item()) > 2.0:      # never: a host read
            x = x * 1.0
        return prob.torch_loglike(x)
    popfused._PROBE_CACHE.clear()
    s = popfused.FusedPopulationSliceSampler(
        popsize=128, nsteps=4, torch_loglike=reads_the_host, device=cuda)
    with pytest.warns(RuntimeWarning, match='reads_the_host'):
        s._resolve_spec_depth(8)
    assert s.spec_probe['how'] == 'eager' and s._spec_graphs().failed
    assert s.spec_probe['t_row_s'] + s.spec_probe['fixed_s'] > 0
    popfused._PROBE_CACHE.clear()


# --- K6 and K7: the sync and random walks' rounds ---------------------------

def _sync_round_inputs(cuda, P, d, kind, nsteps=5, max_it=6, seed=0):
    """A sync-walk state on the card and one round's inputs: K4's bank
    rows and the likelihoods of its rows, with walkers done already,
    zero axes (both signs) in the directions, points on a face and, by
    *kind*: 'mid' a round inside a step; 'last_it' the step's last
    iteration (its boundary); 'all_accept' every walker accepting (its
    boundary); 'all_rejected' none; 'last_step' the last step's
    boundary; 'finished' every step ran (a no-op round)."""
    from ultranest_torch import popfused
    rng = np.random.RandomState(seed + P + d)
    f32 = np.float32
    walk = popfused._SyncWalk(P, d, nsteps, max_it, cuda)
    st = walk.state
    u = rng.uniform(0.05, 0.95, size=(P, d)).astype(f32)
    u[::7, 0] = 0.0
    u[3::7, -1] = 1.0
    v = (rng.normal(size=(P, d)) * 0.1).astype(f32)
    v[::5, 0] = 0.0
    v[1::5, 0] = -0.0
    st['u'].copy_(torch.as_tensor(u))
    st['v'].copy_(torch.as_tensor(v))
    tl, tr = kernels.cube_intersection(st['u'], st['v'])
    st['tl'].copy_(tl)
    st['tr'].copy_(tr)
    st['un'].copy_(st['u'] + 0.01)
    st['Ln'].copy_(torch.as_tensor(rng.normal(size=P).astype(f32)))
    st['done'].copy_(torch.as_tensor(rng.uniform(size=P) < 0.3))
    st['nc'].fill_(12345)
    s = {'last_step': nsteps - 1, 'finished': nsteps}.get(kind, 2)
    it = max_it - 1 if kind in ('last_it', 'last_step') else 2
    st['s'].fill_(s)
    st['it'].fill_(it)
    st['row'].fill_(min(s * max_it + it, nsteps * max_it - 1))
    st['flag'].fill_(kind == 'finished')
    st['accs'][:s].copy_(torch.as_tensor(rng.uniform(size=s).astype(f32)))
    st['widths'][:s].copy_(torch.as_tensor(rng.uniform(size=s).astype(f32)))
    tbank = walk.tbank.copy_(torch.as_tensor(
        rng.uniform(size=(nsteps * max_it, P, 1)).astype(f32)))
    dirbank = (rng.normal(size=(nsteps, P, d)) * 0.1).astype(f32)
    dirbank[:, ::3, 1 % d] = 0.0
    dirbank[:, 1::3, 0] = -0.0
    dirbank = walk.dirbank.copy_(torch.as_tensor(dirbank))
    Lp = rng.normal(size=P).astype(f32)
    if kind == 'all_accept':
        Lp[:] = 5.0
    if kind == 'all_rejected':
        Lp[:] = -5.0
    Lp = torch.as_tensor(Lp, device=cuda)
    tin = torch.as_tensor(rng.uniform(size=P) < 0.8, device=cuda)
    Lmin = walk.Lmin.fill_(0.3)
    return st, tbank, dirbank, Lp, tin, Lmin, max_it, walk


SYNC_KINDS = ('mid', 'last_it', 'all_accept', 'all_rejected', 'last_step',
              'finished')


# K6's forms: chosen from P and d (-1), forced to the one block, the
# grid, radix selection, both; rank counting takes P <= SYNC_RANK_KEYS
SYNC_FORMS = (-1, 0, 1, 2, 3)


def _sync_forms(P):
    from ultranest_torch.ops import kernels as k
    return [f for f in SYNC_FORMS if f < 0 or f & k.SYNC_FORM_RADIX
            or P <= k.SYNC_RANK_KEYS]


def _p_by_d(grid, extra):
    """(P, d) cases of a grid of P x d and *extra* pairs, each named
    "d-P" as a P and a d parametrisation stacked name their cases."""
    pairs = [(P, d) for d in grid[1] for P in grid[0]] + list(extra)
    return [pytest.param(P, d, id='%d-%d' % (d, P)) for P, d in pairs]


# P 64 to 4096 at d 2, 8 and 50, the shapes of chip_smoke.SYNC_SHAPES
# ((64, 2), (128, 8), (4096, 50), (65, 3)) among them; P 1 and 65; P at
# and just above the one block's reach at each d (P * d <= 12800 and
# P <= 2048: sync_update.cu's kSingleElems and kSingleWalkers; 2048 /
# 2049 at d 2, 1600 / 1601 at d 8, 256 / 257 at d 50)
@pytest.mark.parametrize('P,d', _p_by_d(
    ((1, 64, 65, 128, 1000, 2048, 4096), (2, 8, 50)),
    [(65, 3), (2049, 2), (1600, 8), (1601, 8), (256, 50), (257, 50)]))
def test_sync_kernels_equal_plain(cuda, P, d):
    """K4 at D = 1 on the sync walk's bank rows and K6 bit for bit against
    their plain versions: inside a step, at its boundary, every walker
    accepting or none, the last step and a finished dispatch; with the
    filter's rows and without; K6 in every form (one block or a grid
    whose last block ends the step; rank counting or radix selection),
    each one launch."""
    forms = _sync_forms(P)
    for kind in SYNC_KINDS:
        st, tbank, dirbank, Lp, tin, Lmin, max_it, _ = _sync_round_inputs(
            cuda, P, d, kind)
        prop = (st['u'], st['v'], st['tl'], st['tr'], tbank, st['row'])
        kernels.reset_counts()
        got = kernels.spec_propose(*prop)
        want = kernels.spec_propose_plain(*prop)
        for a, b in zip(got, want):
            assert _same_bits(a, b), kind
        ts, tlc, trc, _ = want
        for t in (tin, None):
            plain = {k: x.clone() for k, x in st.items()}
            kernels.sync_update_plain(Lp, t, ts, tlc, trc, Lmin, dirbank,
                                      max_it, plain)
            for form in forms:
                mine = {k: x.clone() for k, x in st.items()}
                kernels._sync_update_cuda(Lp, t, ts, tlc, trc, Lmin,
                                          dirbank, max_it, mine, form)
                torch.cuda.synchronize()
                bad = [k for k in kernels.SYNC_STATE
                       if not _same_bits(mine[k], plain[k])]
                assert not bad, (kind, t is None, form, bad)
                if kind == 'finished':
                    assert all(_same_bits(mine[k], st[k])
                               for k in kernels.SYNC_STATE)
                if kind in ('last_it', 'all_accept'):
                    assert int(mine['s']) == 3 and int(mine['it']) == 0
                    assert int(mine['row']) == 3 * max_it
                if kind == 'last_step':
                    assert bool(mine['flag'])
                    assert int(mine['row']) == int(st['row'])
        assert kernels.LAUNCHES['spec_propose'] == 1
        assert kernels.LAUNCHES['sync_update'] == 2 * len(forms)
        assert sum(kernels.PLAIN_CALLS.values()) == 0


def _median_state(cuda, w, nsteps=5, max_it=6):
    """A sync state on the card at its step's last round, every walker
    done, its final brackets of widths *w* (tl +0; a -0 width from tr
    -0)."""
    P = len(w)
    st, tbank, dirbank, Lp, tin, Lmin, _, _ = _sync_round_inputs(
        cuda, P, 3, 'all_accept', nsteps=nsteps, max_it=max_it)
    w = np.asarray(w, dtype=np.float32)
    st['done'].fill_(True)
    st['tl'].zero_()
    st['tr'].copy_(torch.as_tensor(w))
    st['tr'][torch.as_tensor((w == 0) & np.signbit(w), device=cuda)] = -0.0
    ts = torch.zeros((P, 1), device=cuda)
    return st, (Lp, None, ts, st['tl'].clone(), st['tr'].clone(), Lmin,
                dirbank, max_it)


def test_sync_median_selects_the_order_statistics(cuda):
    """K6's median at a step boundary, in every form, on brackets with
    repeated widths, infinite ones (zero directions) and odd and even P,
    against torch's sorted values; and at every free case of the plain
    version (ties, NaN, both zeros, P 1, every width equal): K6 gives
    the key selection's numpy model bit for bit (a NaN as the card's
    NaN), and the plain version's bits but where a -0 and a +0 width
    meet at the median rank, its value there."""
    from test_torch_sync_round import MEDIAN_CASES, _key_median
    rng = np.random.RandomState(3)
    cases = {'P %d' % P: rng.choice([0.25, 0.5, 0.5, 1.0, np.inf], size=P)
             for P in (1, 2, 3, 64, 257, 1000, 1001, 1025, 4096)}
    cases.update(MEDIAN_CASES)
    cases['NaN and zeros, P 3001'] = rng.choice(
        [np.nan, -0.0, 0.0, 0.125, 3.0], size=3001)
    for name, w in cases.items():
        st, args = _median_state(cuda, w)
        plain = {k: x.clone() for k, x in st.items()}
        kernels.sync_update_plain(*args, plain)
        model = torch.tensor(_key_median(w))
        w = np.asarray(w, dtype=np.float32)
        zeros = w[w == 0]
        free = np.signbit(zeros).any() and not np.signbit(zeros).all()
        for form in _sync_forms(len(w)):
            mine = {k: x.clone() for k, x in st.items()}
            kernels._sync_update_cuda(*args, mine, form)
            got = mine['widths'][2].cpu()
            # NaN: the card's NaN, not the host's
            assert _same_bits(got, model) or bool(got.isnan()) and \
                bool(model.isnan()), (name, form, got, model)
            assert _same_bits(mine['accs'], plain['accs']), (name, form)
            if free:
                assert float(mine['widths'][2]) == float(plain['widths'][2])
            else:
                assert _same_bits(mine['widths'], plain['widths']), \
                    (name, form)
            assert int(mine['s']) == 3 and not mine['tick'].any()


def test_sync_round_is_one_kernel_node(cuda):
    """A round captured in a CUDA graph: K4 and K6 are one kernel node
    each, in every form (the grid's last block ends the round inside its
    one launch)."""
    from ultranest_torch import popfused
    for P, d in ((64, 2), (128, 8), (4096, 50)):
        st, tbank, dirbank, Lp, tin, Lmin, max_it, walk = \
            _sync_round_inputs(cuda, P, d, 'mid')
        ts, tlc, trc, _ = kernels.spec_propose(
            st['u'], st['v'], st['tl'], st['tr'], tbank, st['row'])
        for form in _sync_forms(P):
            nodes = _kernel_nodes(lambda: kernels._sync_update_cuda(
                Lp, tin, ts, tlc, trc, Lmin, dirbank, max_it, st, form))
            assert len(nodes) == 1 and 'sync_update' in nodes[0], nodes
        walk.evaluate = lambda r: (r[:, 0] * 1.0, None)
        nodes = _kernel_nodes(walk.round)
        assert sum('sync_update' in n for n in nodes) == 1, nodes
        assert sum('spec_propose' in n for n in nodes) == 1, nodes


def _kernel_nodes(fn):
    from ultranest_torch.evaluate.graph_nodes import graph_kernel_names
    return graph_kernel_names(fn, torch.device('cuda'))


def _rwalk_step_case(cuda, P, d, seed):
    rng = np.random.RandomState(seed)
    f32 = np.float32
    up = rng.uniform(-0.05, 1.05, size=(P, d)).astype(f32)
    up[::9] = rng.uniform(0.2, 0.8, size=up[::9].shape)
    up[1::11] = 0.0
    up[2::13] = 1.0
    up[3::17, 0] = np.nan
    Lev = rng.normal(size=P).astype(f32)
    Lev[::19] = np.nan
    Lev[1::23] = np.inf
    Lev[2::29] = -np.inf
    st = dict(u=torch.as_tensor(rng.uniform(size=(P, d)).astype(f32),
                                device=cuda),
              L=torch.as_tensor(rng.normal(size=P).astype(f32), device=cuda),
              nacc=torch.full((), 5, dtype=torch.int64, device=cuda),
              nc=torch.full((), 9, dtype=torch.int64, device=cuda))
    m = torch.as_tensor((rng.normal(size=(P, d)) * 0.05).astype(f32),
                        device=cuda)
    m[::7, 0] = -0.0
    up, Lev = (torch.as_tensor(x, device=cuda) for x in (up, Lev))
    tin = torch.as_tensor(rng.uniform(size=P) < 0.8, device=cuda)
    return up, Lev, st, m, tin


# P 64 to 4096 at d 2, 8 and 50, chip_smoke.RWALK_SHAPES ((128, 8),
# (4096, 50), (63, 3)) among them; P 1; d above a warp
@pytest.mark.parametrize('P,d', _p_by_d(
    ((64, 128, 1000, 2048, 4096), (2, 8, 50)),
    [(1, 8), (63, 3), (100, 33), (30, 70)]))
def test_rwalk_accept_equals_plain(cuda, P, d):
    """K7 bit for bit against its plain version: the prologue, a middle
    step (accept, then the next proposal in place) and the last step (no
    proposal); rows outside the cube, on its faces and corners, NaN
    coordinates, NaN and infinite likelihoods; with the filter's rows and
    without."""
    up, Lev, st, m, tin = _rwalk_step_case(cuda, P, d, P + d)
    Lmin = torch.tensor(-0.5, dtype=torch.float32, device=cuda)
    scale = torch.tensor(0.3, dtype=torch.float32, device=cuda)
    kernels.reset_counts()
    mine, plain = up.clone(), up.clone()
    kernels.rwalk_accept(None, None, mine, None, st, m, scale)
    kernels.rwalk_accept_plain(None, None, plain, None, st, m, scale)
    assert _same_bits(mine, plain)
    assert kernels.LAUNCHES == collections.Counter(rwalk_accept=1)
    for t in (tin, None):
        for nxt in (m, None):
            kernels.reset_counts()
            mine = {k: x.clone() for k, x in st.items()}
            plain = {k: x.clone() for k, x in st.items()}
            up_mine, up_plain = up.clone(), up.clone()
            kernels.rwalk_accept(Lev, t, up_mine, Lmin, mine, nxt, scale)
            kernels.rwalk_accept_plain(Lev, t, up_plain, Lmin, plain, nxt,
                                       scale)
            torch.cuda.synchronize()
            for k in kernels.RWALK_STATE:
                assert _same_bits(mine[k], plain[k]), (k, t is None)
            assert _same_bits(up_mine, up_plain), (t is None, nxt is None)
            assert kernels.LAUNCHES == collections.Counter(rwalk_accept=1)
            assert sum(kernels.PLAIN_CALLS.values()) == 0
            assert int(mine['nacc']) > 5 or P < 8


# the engines' shapes (P 64 to 128, d 2 and 8, nsteps 8 to 40), the
# random-walk run's (128, 8, 40), and wider ones
@pytest.mark.parametrize('nsteps,P,d', [(40, 128, 8), (16, 128, 8),
                                        (8, 64, 2), (12, 63, 3),
                                        (40, 4096, 50), (5, 1, 8)])
def test_rwalk_products_batched_against_per_step(cuda, nsteps, P, d):
    """The walk's products are one matmul a step, each the bits of the
    reference scan's ``eps[s] @ axes.T`` (:func:`popfused._rwalk_products`);
    whether one batched matmul of every step would give the same bits is
    printed: on an H100 it did not at the random-walk run's P 128, d 8,
    so the walk keeps one a step."""
    from ultranest_torch import popfused
    g = torch.Generator(device=cuda).manual_seed(nsteps + P + d)
    eps = torch.randn((nsteps, P, d), generator=g, device=cuda)
    axes = torch.randn((d, d), generator=g, device=cuda) * 0.1
    per_step = popfused._rwalk_products(eps, axes,
                                        torch.empty_like(eps))
    for s in range(nsteps):
        assert _same_bits(per_step[s], eps[s] @ axes.T)
    batched = torch.matmul(eps, axes.T)
    same = _same_bits(batched, per_step)
    print('rwalk products nsteps %d P %d d %d: batched %s per step'
          % (nsteps, P, d, '==' if same else '!='))


def _engine_walk_inputs(cuda, engine, P=128, d=8, nsteps=16, max_it=64,
                        seed=5):
    """A live set of asymgauss in d around its peak and one dispatch's
    banks of *engine*, on the card."""
    from ultranest_torch import popfused
    from ultranest_torch.models.problems import asymgauss
    prob = asymgauss(d)
    rng = np.random.RandomState(seed)
    nlive = 200
    u = np.clip(0.5 + 0.05 * rng.normal(size=(nlive, d)), 0.01, 0.99)
    L = prob.loglike(u).astype(np.float32)
    live_u = torch.as_tensor(u, dtype=torch.float32, device=cuda)
    live_L = torch.as_tensor(L, device=cuda)
    axes = torch.diag(live_u.std(dim=0))
    g = torch.Generator(device=cuda).manual_seed(seed)
    if engine == 'sync':
        banks = popfused.draw_sync_banks(g, P, nsteps, max_it, nlive, d)
    else:
        banks = popfused.draw_rwalk_banks(g, P, nsteps, nlive, d)

    def ev(rows):
        return prob.torch_loglike(rows).to(torch.float32), None
    return (banks, live_u, live_L, axes, live_L.min()), ev


@pytest.mark.parametrize('engine', ['sync', 'rwalk'])
def test_engine_graph_walk_equals_host_loop(cuda, engine):
    """The sync and random walks as CUDA graphs give the host loop's bits
    (K4 and K6, or K7, launched eagerly) and the bits of the loops of
    torch operators they replace (P 128: the accepting fraction is the
    same division whether torch multiplies by 1/P or not); each replay
    adds its graph's launches, a capture's warm-up launches once."""
    from test_torch_sync_round import _old_rwalk_walk, _old_sync_walk
    from ultranest_torch import popfused
    args, ev = _engine_walk_inputs(cuda, engine)
    walk = popfused.sync_walk if engine == 'sync' else popfused.rwalk_walk
    scale = 0.8 if engine == 'sync' else 0.3
    host = {}
    kernels.reset_counts()
    want = walk(*args, scale, ev, stats=host)
    torch.cuda.synchronize()
    names = ('spec_propose', 'sync_update') if engine == 'sync' \
        else ('rwalk_accept',)
    # K7 once more a dispatch, for its prologue
    prologue = int(engine == 'rwalk')
    for k in names:
        assert kernels.LAUNCHES[k] == host['rounds'] + prologue
    assert sum(kernels.PLAIN_CALLS.values()) == 0
    if engine == 'sync':
        old = _old_sync_walk(*args, scale, ev)
        pairs = zip((0, 1, 3, 4, 6, 7), (0, 1, 2, 3, 4, 5))
    else:
        old = _old_rwalk_walk(*args, scale, ev)
        pairs = zip((0, 1, 3, 4, 6), (0, 1, 2, 3, 4))
    for i, j in pairs:
        assert _same_bits(want[i], old[j]), (engine, i)
    graphs = popfused.SpecGraphs('asymgauss')
    for n in range(2):
        stats = {}
        kernels.reset_counts()
        got = walk(*args, scale, ev, stats=stats, graphs=graphs)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert _same_bits(a, b), engine
        assert stats['graph'] and stats['captures'] == (n == 0)
        if engine == 'sync':
            every = popfused.SYNC_CHECK_EVERY
            # both read one chunk behind on the card
            assert stats['rounds'] == host['rounds']
            assert stats['reads'] == host['reads'] == \
                stats['rounds'] // every - 1
            assert stats['replays'] == stats['rounds'] // every
            warm = 1
        else:
            assert stats['replays'] == 1 and stats['reads'] == 0
            warm = stats['rounds'] + prologue
        for k in names:
            assert kernels.LAUNCHES[k] == \
                stats['rounds'] + prologue + (n == 0) * warm
    assert sum(kernels.PLAIN_CALLS.values()) == 0


@pytest.mark.parametrize('engine', ['sync', 'rwalk'])
def test_uncapturable_likelihood_runs_the_engine_kernels(cuda, engine):
    """A likelihood that reads a value to the host cannot be captured: one
    warning names it, the walk logs ``graph`` False and runs K4 and K6,
    or K7, from the host loop, never their plain versions, with the
    capturable likelihood's bits."""
    from ultranest_torch import popfused
    args, ev = _engine_walk_inputs(cuda, engine, P=64, seed=7)
    walk = popfused.sync_walk if engine == 'sync' else popfused.rwalk_walk

    def reads_the_host(rows):
        if float(rows[0, 0].item()) > 2.0:      # never: a host read
            rows = rows * 1.0
        return ev(rows)
    want = walk(*args, 0.5, ev)
    graphs = popfused.SpecGraphs('reads_the_host')
    stats = {}
    kernels.reset_counts()
    with pytest.warns(RuntimeWarning, match='reads_the_host'):
        got = walk(*args, 0.5, reads_the_host, stats=stats, graphs=graphs)
    torch.cuda.synchronize()
    assert graphs.failed and not stats['graph']
    names = ('spec_propose', 'sync_update') if engine == 'sync' \
        else ('rwalk_accept',)
    for k in names:
        assert kernels.LAUNCHES[k] >= stats['rounds'] > 0
    assert sum(kernels.PLAIN_CALLS.values()) == 0
    for a, b in zip(got, want):
        assert _same_bits(a, b)
    again = {}
    walk(*args, 0.5, reads_the_host, stats=again, graphs=graphs)
    assert not again['graph'] and again['captures'] == 0


@pytest.mark.parametrize('engine', ['sync', 'rwalk'])
def test_engine_dispatch_syncs_only_at_its_flag_reads(cuda, engine):
    """A sync or random-walk dispatch replayed from its captured graphs
    under ``set_sync_debug_mode('error')``: nothing but the sync walk's
    flag reads (CUDA events) waits, and the random walk reads nothing;
    the bits are the capturing run's."""
    from ultranest_torch import popfused
    args, ev = _engine_walk_inputs(cuda, engine)
    walk = popfused.sync_walk if engine == 'sync' else popfused.rwalk_walk
    scale = 0.8 if engine == 'sync' else 0.3
    graphs = popfused.SpecGraphs('asymgauss')
    want = walk(*args, scale, ev, graphs=graphs)
    torch.cuda.synchronize()
    kernels.reset_counts()
    stats = {}
    torch.cuda.set_sync_debug_mode('error')
    try:
        got = walk(*args, scale, ev, stats=stats, graphs=graphs)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    torch.cuda.synchronize()
    assert stats['graph'] and stats['captures'] == 0
    for a, b in zip(got, want):
        assert _same_bits(a, b), engine
    names = ('spec_propose', 'sync_update') if engine == 'sync' \
        else ('rwalk_accept',)
    # K7 once more, for its prologue
    prologue = int(engine == 'rwalk')
    for k in names:
        assert kernels.LAUNCHES[k] == stats['rounds'] + prologue
    if engine == 'sync':
        assert stats['reads'] == stats['rounds'] // \
            popfused.SYNC_CHECK_EVERY - 1
    else:
        assert stats['reads'] == 0


def test_rwalk_step_is_the_likelihood_and_k7(cuda):
    """The random walk's graph: the products before the first step, K7's
    prologue, then each step is the likelihood's kernels and K7, and no
    other kernel."""
    from ultranest_torch import popfused
    args, ev = _engine_walk_inputs(cuda, 'rwalk', nsteps=6)
    banks, live_u, live_L, axes, Lmin = args
    nsteps, P, d = banks['eps'].shape
    rwalk = popfused._RwalkWalk(P, d, nsteps, cuda)
    rwalk.load(banks, live_u, live_L, axes, Lmin, 0.3, ev)
    rwalk.init()
    rwalk.round()                   # first calls outside the capture
    torch.cuda.synchronize()
    walk = _kernel_nodes(rwalk.round)
    products = _kernel_nodes(
        lambda: popfused._rwalk_products(rwalk.eps, rwalk.axes, rwalk.m))
    like = _kernel_nodes(lambda: ev(rwalk.up))
    assert sum('rwalk_step_kernel' in n for n in walk) == nsteps + 1, walk
    assert len(walk) == len(products) + 1 + nsteps * (len(like) + 1), \
        (walk, products, like)
