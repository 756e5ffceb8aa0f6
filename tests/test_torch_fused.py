"""The port's fused proposal against the JAX package, on the CPU.

The deterministic stage (filter -> transform -> likelihood, then the
acceptance budget and the compaction) is fed the same candidates ``u``
as the reference's own pieces (``fused._inside_ellipsoid``,
``fused._radius_member`` and the budget/compaction of
``ultranest_tpu/fused.py:483-534``), against the same region. The draws
of the four proposal methods cannot match JAX's random streams, so they
are tested by distribution: every draw lies inside its proposal region,
and a KS test checks its radial (or coordinate) distribution.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

import ultranest_tpu.fused as jfused
import ultranest_tpu.mlfriends as jml
import ultranest_torch.fused as tfused
import ultranest_torch.mlfriends as tml
from ultranest_torch.convert import (live_from_state, reference_state,
                                     region_from_reference)
from ultranest_torch.ops.pairwise import pad_rows, round_up

HIGHEST = jax.lax.Precision.HIGHEST


def _loglike_np(x):
    return -0.5 * (((x - 0.5) / 0.1) ** 2).sum(axis=1)


def _loglike_torch(x):
    return -0.5 * (((x - 0.5) / 0.1) ** 2).sum(dim=1)


def _transform_torch(u):
    return u * 2.0 - 0.5


def _transform_jax(u):
    return u * 2.0 - 0.5


def _reference_region(kind, seed=1):
    rng = np.random.RandomState(seed)
    if kind == 'blobs':
        u = np.concatenate([0.3 + 0.03 * rng.normal(size=(150, 3)),
                            0.65 + 0.04 * rng.normal(size=(100, 3))])
        layer = jml.LocalAffineLayer()
    else:
        u = 0.5 + 0.1 * rng.normal(size=(200, 2))
        layer = jml.ScalingLayer()
    layer.optimize(u, u)
    region = jml.MLFriends(u, layer)
    region.maxradiussq, region.enlarge = region.compute_enlargement(
        nbootstraps=30, rng=np.random.RandomState(seed))
    region.create_ellipsoid()
    return region


def _candidates(region, n, seed):
    rng = np.random.RandomState(seed)
    d = region.u.shape[1]
    near = region.u[rng.randint(len(region.u), size=n // 2)] \
        + rng.normal(size=(n // 2, d)) * 0.03
    return np.concatenate([near, rng.uniform(-0.05, 1.05, (n - n // 2, d))]
                          ).astype(np.float32)


def _reference_stage(region, u, mult_ok, tregion=None):
    """The reference's filter on the same candidates (fused.py:483-499)."""
    d = u.shape[1]
    layer = region.transformLayer
    if hasattr(layer, 'T') and np.ndim(layer.T) == 2:
        T, ctr = jfused._as_f32(layer.T), jfused._as_f32(layer.ctr)
    else:
        T = jfused._as_f32(np.diag(1.0 / np.ravel(layer.std)))
        ctr = jfused._as_f32(np.ravel(layer.mean))
    npts = len(region.unormed)
    tpoints = pad_rows(np.asarray(region.unormed, np.float32),
                       round_up(npts))
    tmask = jnp.arange(len(tpoints)) < npts
    uj = jnp.asarray(u)
    in_cube = jnp.logical_and(uj > 0, uj < 1).all(axis=1)
    member = jnp.logical_and(in_cube, jfused._inside_ellipsoid(
        uj, jnp.asarray(region.ellipsoid_center, jnp.float32),
        jnp.asarray(region.ellipsoid_invcov, jnp.float32),
        jnp.float32(region.enlarge)))
    member = jnp.logical_and(member, jnp.asarray(mult_ok))
    t = jnp.dot(uj - ctr[None, :], T, preferred_element_type=jnp.float32,
                precision=HIGHEST)
    member = jnp.logical_and(member, jfused._radius_member(
        t, jnp.asarray(tpoints), tmask,
        jnp.float32(min(region.maxradiussq, jfused._F32MAX))))
    v = _transform_jax(uj)
    if tregion is not None:
        tc, ti, te = jfused.tregion_geometry(tregion, v.shape[1])
        member = jnp.logical_and(member, jfused._inside_ellipsoid(
            v, jnp.asarray(tc), jnp.asarray(ti), te))
    logl = jnp.where(member, -0.5 * (((v - 0.5) / 0.1) ** 2).sum(axis=1),
                     -jnp.inf)
    return np.asarray(member), np.asarray(v), np.asarray(logl), tpoints, d


@pytest.mark.parametrize('kind,with_tregion', [('blobs', False),
                                               ('blobs', True),
                                               ('gauss', False)])
def test_filter_stage_matches_reference(kind, with_tregion):
    ref_region = _reference_region(kind)
    port_region = region_from_reference(reference_state(ref_region), 'cpu')
    u = _candidates(ref_region, 4096, seed=2)
    mult_ok = np.random.RandomState(3).uniform(size=len(u)) < 0.9
    tregion_ref = tregion_port = None
    if with_tregion:
        tregion_ref = jml.WrappingEllipsoid(ref_region.u * 2.0 - 0.5)
        tregion_ref.enlarge = tregion_ref.compute_enlargement(
            nbootstraps=30, rng=np.random.RandomState(4))
        tregion_ref.create_ellipsoid()
        tregion_port = region_from_reference(reference_state(tregion_ref),
                                             'cpu')
    member_ref, v_ref, logl_ref, tpoints, d = _reference_stage(
        ref_region, u, mult_ok, tregion_ref)
    geo = tfused.region_geometry(port_region, d, tregion_port, 'cpu')
    member, v, logl = tfused.filter_stage(
        torch.as_tensor(u), torch.as_tensor(mult_ok), geo,
        torch.as_tensor(tpoints),
        (torch.arange(len(tpoints)) < len(ref_region.u)).int(),
        _transform_torch, _loglike_torch)
    assert 0.05 < member_ref.mean() < 0.95
    np.testing.assert_array_equal(member.numpy(), member_ref)
    np.testing.assert_allclose(v.numpy(), v_ref, rtol=1e-6)
    # the likelihoods sum 3 terms in f32: a few ulp apart at most
    np.testing.assert_allclose(logl.numpy(), logl_ref, rtol=1e-6)


def _reference_compaction(u, logl, member, Lmin, budget, kreturn,
                          segment):
    """fused.py:500-534, on the same arrays."""
    u, logl, member = map(jnp.asarray, (u, logl, member))
    if segment:
        accepted0 = jnp.logical_and(member, logl > Lmin)
        wb = jnp.cumsum(accepted0.astype(jnp.int32)) <= min(budget, kreturn)
        valid = jnp.logical_and(accepted0, wb)
        order = jnp.argsort(jnp.logical_not(valid), stable=True)[:kreturn]
        return (u[order], logl[order], valid[order].astype(jnp.float32),
                jnp.sum(jnp.logical_and(member, wb)))
    accepted = jnp.logical_and(member, logl > Lmin)
    within = jnp.cumsum(accepted.astype(jnp.int32)) <= min(budget, kreturn)
    member = jnp.logical_and(member, within)
    accepted = jnp.logical_and(accepted, within)
    order = jnp.argsort(jnp.logical_not(accepted), stable=True)
    sel = order[:min(kreturn, len(u))]
    return (u[sel], logl[sel], jnp.minimum(jnp.sum(accepted), len(sel)),
            jnp.sum(member))


@pytest.mark.parametrize('segment', [False, True])
@pytest.mark.parametrize('budget', [64, 5000])
def test_budget_and_compaction_match_reference(segment, budget):
    rng = np.random.RandomState(budget)
    n = 4096
    u = rng.uniform(size=(n, 2)).astype(np.float32)
    member = rng.uniform(size=n) < 0.6
    logl = np.where(member, rng.normal(size=n), -np.inf).astype(np.float32)
    Lmin = float(np.float32(-0.3))
    ref = _reference_compaction(u, logl, member, Lmin, budget, 1024,
                                segment)
    tu, tl, tm = map(torch.as_tensor, (u, logl, member))
    if segment:
        got = tfused.compact_segment(tu, tl, tm, torch.tensor(Lmin), budget,
                                     1024)
    else:
        got = tfused.compact_classic(tu, tu, tl, tm, Lmin, budget, 1024)
        got = (got[0], got[2], got[3], got[4])
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _sampler_and_geo(region, d):
    s = tfused.FusedRegionSampler(_loglike_torch, None, d, seed=5,
                                  device='cpu')
    geo = tfused.region_geometry(region, d, None, 'cpu')
    npts = len(region.unormed)
    tpoints = torch.as_tensor(pad_rows(np.asarray(region.unormed,
                                                  np.float32),
                                       round_up(npts)))
    tmask = (torch.arange(len(tpoints)) < npts).int()
    s._seed_dispatch()
    return s, geo, tpoints, tmask, npts


def _ks_uniform(x):
    return scipy.stats.kstest(np.ravel(x), 'uniform').pvalue


@pytest.mark.parametrize('kind', ['blobs', 'gauss'])
def test_draws_lie_in_their_regions(kind):
    region = region_from_reference(reference_state(_reference_region(kind)),
                                   'cpu')
    d = region.u.shape[1]
    s, geo, tpoints, tmask, npts = _sampler_and_geo(region, d)
    n = 20000
    ctr = geo['ctr'].double().numpy()
    T = geo['T'].double().numpy()

    u, ok = s.draw(tfused.METHOD_CUBE, n, geo, tpoints, tmask, npts)
    u = u.numpy()
    assert ok.all() and (u >= 0).all() and (u < 1).all()
    assert _ks_uniform(u) > 1e-3

    u, ok = s.draw(tfused.METHOD_ELLIPSOID, n, geo, tpoints, tmask, npts)
    du = u.double().numpy() - geo['ell_ctr'].double().numpy()
    mahal = ((du @ geo['ell_invcov'].double().numpy()) * du).sum(axis=1)
    assert ok.all() and (mahal <= geo['enlarge'] * (1 + 1e-4)).all()
    assert _ks_uniform(np.clip(mahal / geo['enlarge'], 0, 1) ** (d / 2)) \
        > 1e-3

    u, ok = s.draw(tfused.METHOD_TBOX, n, geo, tpoints, tmask, npts)
    t = (u.double().numpy() - ctr) @ T
    lo = geo['tbox_lo'].double().numpy()
    hi = geo['tbox_hi'].double().numpy()
    span = hi - lo
    assert ok.all()
    assert (t >= lo - 1e-4 * span).all() and (t <= hi + 1e-4 * span).all()
    assert _ks_uniform(np.clip((t - lo) / span, 0, 1)) > 1e-3

    u, ok = s.draw(tfused.METHOD_POINTS, n, geo, tpoints, tmask, npts)
    t = (u.double().numpy() - ctr) @ T
    d2 = ((t[:, None, :] - region.unormed[None, :, :]) ** 2).sum(axis=2)
    assert (d2.min(axis=1) <= geo['maxradiussq'] * (1 + 1e-4)).all()
    # 1/multiplicity acceptance: overlapping balls thin the draws
    assert ok.any()


def test_point_balls_uniform_in_radius():
    """Isolated balls: each draw's radius to its centre follows r^d ~ U."""
    g = np.linspace(0.1, 0.9, 5)
    u = np.array([[a, b] for a in g for b in g])
    layer = tml.ScalingLayer()
    layer.optimize(u, u)
    region = tml.MLFriends(u, layer, device='cpu')
    region.maxradiussq = float((0.2 / np.ravel(layer.std)).min() ** 2) \
        / 16
    region.enlarge = 10.0
    region.create_ellipsoid()
    s, geo, tpoints, tmask, npts = _sampler_and_geo(region, 2)
    uu, ok = s.draw(tfused.METHOD_POINTS, 20000, geo, tpoints, tmask, npts)
    assert ok.all()                 # the balls do not overlap
    t = (uu.double().numpy() - geo['ctr'].double().numpy()) \
        @ geo['T'].double().numpy()
    d2 = ((t[:, None, :] - region.unormed[None, :, :]) ** 2).sum(axis=2)
    r2 = d2.min(axis=1) / geo['maxradiussq']
    assert (r2 <= 1 + 1e-4).all()
    assert _ks_uniform(np.clip(r2, 0, 1)) > 1e-3     # r^2 = (r^d), d=2


def test_segment_dispatch_records_replay():
    """One CPU segment dispatch: accepted rows lie in the region and the
    records replay the consume rule on the returned rows."""
    ref_region = _reference_region('blobs')
    state = reference_state(ref_region, live_L=_loglike_np(ref_region.u))
    region = region_from_reference(state, 'cpu')
    live_u, live_L = live_from_state(state)
    s = tfused.FusedRegionSampler(_loglike_torch, None, 3, seed=6,
                                  device='cpu')
    s.segment_start(live_u, live_L, ndraw=4096)
    s.segment_launch(region)
    rec = s.segment_fetch()
    acc = rec['accept']
    assert acc.any() and rec['nc'] > 0
    assert region.inside(rec['u'][acc]).all()
    lL = np.asarray(live_L, np.float32).astype(float)
    for i in range(len(rec['L'])):
        w = int(np.argmin(lL))
        assert rec['worst'][i] == w and rec['Lmin'][i] == lL[w]
        assert rec['rank'][i] == (lL < rec['L'][i]).sum()
        if acc[i]:
            assert rec['L'][i] > lL[w]
            lL[w] = rec['L'][i]
    live_u2, live_L2 = s._seg_state
    np.testing.assert_array_equal(np.sort(live_L2.numpy()[:len(lL)]),
                                  np.sort(lL.astype(np.float32)))


def test_segment_pending_counts_dispatches_in_flight_as_the_reference():
    """``segment_pending`` (``ultranest_tpu/fused.py:774-777``) through a
    segment start, two launches, two fetches and the stop, on both
    packages' samplers fed the same live set and region."""
    ref_region = _reference_region('blobs')
    state = reference_state(ref_region, live_L=_loglike_np(ref_region.u))
    region = region_from_reference(state, 'cpu')
    live_u, live_L = live_from_state(state)
    port = tfused.FusedRegionSampler(_loglike_torch, None, 3, seed=6,
                                     device='cpu')
    ref = jfused.FusedRegionSampler(
        lambda x: -0.5 * (((x - 0.5) / 0.1) ** 2).sum(axis=1), None, 3,
        seed=6)
    seen = []

    def both():
        seen.append((ref.segment_pending(), port.segment_pending()))

    both()
    for s, reg in ((ref, ref_region), (port, region)):
        s.segment_start(live_u, live_L, ndraw=1024)
    both()
    for s, reg in ((ref, ref_region), (port, region)):
        s.segment_launch(reg)
    both()
    for s, reg in ((ref, ref_region), (port, region)):
        s.segment_launch(reg)
    both()
    for s in (ref, port):
        s.segment_fetch()
    both()
    for s in (ref, port):
        s.segment_fetch()
    both()
    for s, reg in ((ref, ref_region), (port, region)):
        s.segment_launch(reg)
    both()
    for s in (ref, port):
        s.segment_stop()
    both()
    assert [r for r, _ in seen] == [p for _, p in seen] == \
        [0, 0, 1, 2, 1, 0, 1, 0]
