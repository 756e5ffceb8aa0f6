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


@pytest.mark.parametrize('npad,m,d', [(512, 4096, 2), (512, 4096, 16),
                                      (2048, 16384, 8), (64, 130, 3),
                                      (512, 128, 100)])
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


@pytest.mark.parametrize('n,d', [(400, 2), (2048, 8), (37, 3), (300, 40)])
def test_bootstrap_radius_equals_plain(cuda, n, d):
    rng = np.random.RandomState(n)
    tp = rng.normal(size=(n, d)).astype(np.float32)
    args = radius_inputs(tp, make_bootstrap_masks(n, 30, rng=rng), cuda)
    got = float(kernels.bootstrap_radius(*args))
    want = float(kernels.bootstrap_radius_plain(*args))
    np.testing.assert_allclose(got, want, rtol=1e-6)


# 16384: the live set needs the opt-in dynamic shared memory above 48 KB
@pytest.mark.parametrize('npad,P', [(512, 1024), (64, 200), (4096, 1024),
                                    (16384, 256)])
def test_consume_scan_equals_plain(cuda, npad, P):
    rng = np.random.RandomState(npad)
    nlive = npad * 3 // 4
    live_L = np.full(npad, np.inf, np.float32)
    live_L[:nlive] = rng.uniform(-5, 0, nlive).astype(np.float32)
    live_L[[1, 4, 7]] = live_L[:nlive].min() - 1
    rows_L = rng.uniform(-6, 2, P).astype(np.float32)
    rows_L[::9] = live_L[rng.randint(nlive, size=len(rows_L[::9]))]
    rows_L[-3:] = -np.inf
    rows_valid = (rng.uniform(size=P) < 0.8).astype(np.float32)
    rows_valid[-P // 4:] = 0.0
    live_u = rng.uniform(size=(npad, 2)).astype(np.float32)
    rows_u = rng.uniform(size=(P, 2)).astype(np.float32)
    a = [torch.as_tensor(x, device=cuda) for x in (live_L, rows_L,
                                                    rows_valid)]
    gL, grec = kernels.consume_scan(*a)
    wL, wrec = kernels.consume_scan_plain(*a)
    assert torch.equal(gL, wL) and torch.equal(grec, wrec)
    gu = segmentops.consume_scan(torch.as_tensor(live_u, device=cuda),
                                 a[0], torch.as_tensor(rows_u, device=cuda),
                                 a[1], a[2])
    cu = segmentops.consume_scan(*map(torch.as_tensor, (live_u, live_L,
                                                        rows_u, rows_L,
                                                        rows_valid)))
    for x, y in zip(gu, cu):
        assert torch.equal(x.cpu(), y)


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
    for name in kernels.KERNELS:
        assert kernels.LAUNCHES[name] > 0, name
