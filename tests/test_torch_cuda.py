"""The port's CUDA kernels against their plain torch versions, on a card.

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports neither jax nor the JAX package, so it also runs where only
torch is installed:

    python -m pytest -q --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from ultranest_torch import segmentops
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
    flag reads of :func:`ultranest_torch.popfused._drive`.

    Under ``set_sync_debug_mode('error')`` any implicit synchronisation
    raises. The async walk is the spec walk at depth 1: ``reads ==
    rounds // SPEC_CHECK_EVERY - 1``. The sync walk drives one shrink
    loop per step, each read with no lag: ``reads == rounds //
    SYNC_CHECK_EVERY``. The random walk has a fixed trip count and reads
    nothing.
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
        if engine == 'rwalk':
            assert st['reads'] == 0 and st['rounds'] == s.nsteps, st
        elif engine == 'sync':
            assert s.max_it % SYNC_CHECK_EVERY == 0
            assert st['rounds'] % SYNC_CHECK_EVERY == 0, st
            assert st['reads'] == st['rounds'] // SYNC_CHECK_EVERY, st
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
