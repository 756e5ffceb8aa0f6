"""The port's sync, async and random-walk engines against the JAX package.

* Each walk fed the draws the reference's own key splits give
  (``ultranest_tpu/popfused.py:697-905,1597-1631``, rebuilt here in JAX
  from the same key) against the reference's walk with that key: equal
  ``done``, ``idx0`` and billed counts, ``uf``/``Lf`` within 1e-6 and
  the width or acceptance rate within rtol 1e-6; in classic mode
  (the walk alone) and in segment mode (walk + whitening + consume scan
  + pack, against the reference's ``_build_segment_single``).
* One small end-to-end run per engine on the CPU, against the JAX
  package's run of the same configuration through logZ.

The test likelihood, ``-max|x - c|``, is exact in float32 whatever the
order of its reductions; the random walk's region axes are diagonal
(``ScalingLayer``), so its matmul is exact too. XLA on the CPU contracts
the walks' own ``a + b * c`` into fused multiply-adds, so the float
outputs may differ in the last bits; the 1e-6 tolerance covers that and
nothing more.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ultranest_tpu
import ultranest_tpu.mlfriends as jml
import ultranest_tpu.models as jmodels
import ultranest_tpu.popfused as jpop
import ultranest_torch
import ultranest_torch.mlfriends as tml
import ultranest_torch.popfused as tpop
from ultranest_torch import convert
from ultranest_torch.models import problems
from ultranest_torch.ops import kernels
from ultranest_torch.ops.pairwise import pad_rows, round_up

P, NSTEPS, MAX_IT = 48, 6, 64
CENTER = np.array([0.5, 0.45, 0.55, 0.6, 0.4])


def _loglike_np(x):
    return -np.abs(x - CENTER[:x.shape[1]]).max(axis=1)


def _loglike_jax(x):
    return -jnp.abs(x - CENTER[:x.shape[1]]).max(axis=1)


def _loglike_torch(x):
    c = torch.as_tensor(CENTER[:x.shape[1]], dtype=x.dtype)
    return -torch.abs(x - c).amax(dim=1)


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5))
def _spec_draws(key, nlive, P_, nsteps, max_rounds, x_dim):
    """The async engine's draws (``popfused.py:727-747``), depth 1."""
    kstart, kdir, kt = jax.random.split(key, 3)
    tbank = jax.random.uniform(kt, (max_rounds, P_))
    kde1, kde2, kax, kchoice = jax.random.split(kdir, 4)
    return dict(
        xibank=tbank[..., None],
        i1=jax.random.randint(kde1, (nsteps, P_), 0, nlive),
        i2=jax.random.randint(kde2, (nsteps, P_), 0, nlive - 1),
        jx=jax.random.randint(kax, (nsteps, P_), 0, x_dim),
        pick=jax.random.uniform(kchoice, (nsteps, P_)),
        idx0=jax.random.randint(kstart, (P_,), 0, nlive))


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5))
def _sync_draws(key, nlive, P_, nsteps, max_it, x_dim):
    """The sync engine's draws (``popfused.py:821-863``): the per-step
    key splits and, for every step, the whole shrink-key chain."""
    kstart, ksteps = jax.random.split(key)

    def per_step(ks):
        kde1, kde2, kax, kchoice, kshrink = jax.random.split(ks, 5)

        def shrink(kk, _):
            kk, k1 = jax.random.split(kk)
            return kk, jax.random.uniform(k1, (P_,))
        _, tb = jax.lax.scan(shrink, kshrink, None, length=max_it)
        return (jax.random.randint(kde1, (P_,), 0, nlive),
                jax.random.randint(kde2, (P_,), 0, nlive - 1),
                jax.random.randint(kax, (P_,), 0, x_dim),
                jax.random.uniform(kchoice, (P_,)), tb)
    i1, i2, jx, pick, tbank = jax.vmap(per_step)(
        jax.random.split(ksteps, nsteps))
    return dict(tbank=tbank, i1=i1, i2=i2, jx=jx, pick=pick,
                idx0=jax.random.randint(kstart, (P_,), 0, nlive))


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _rwalk_draws(key, nlive, P_, nsteps, x_dim):
    """The random walk's draws (``popfused.py:1603-1608``)."""
    kstart, keps = jax.random.split(key)
    return dict(eps=jax.random.normal(keps, (nsteps, P_, x_dim)),
                idx0=jax.random.randint(kstart, (P_,), 0, nlive))


def _banks(engine, key, nlive, d, harvest=False):
    """The reference's draws for *key*, as the port's banks."""
    n32 = jnp.int32(nlive)
    if engine == 'sync':
        draws = _sync_draws(key, n32, P, NSTEPS, MAX_IT, d)
    elif engine == 'rwalk':
        draws = _rwalk_draws(key, n32, P, NSTEPS, d)
    else:
        # async: max_it * nsteps rounds in classic mode, the depth-1
        # spec cap in segment mode
        rounds = MAX_IT * NSTEPS if harvest else \
            tpop.spec_max_rounds(NSTEPS, MAX_IT, 1)
        draws = _spec_draws(key, n32, P, NSTEPS, rounds, d)
    return convert.walk_banks('cpu', **{k: np.asarray(v)
                                        for k, v in draws.items()})


def _state(d, seed, nlive=60):
    """Live points, a reference SimpleRegion and its packed geometry."""
    rng = np.random.RandomState(seed)
    u = np.clip(CENTER[:d] + 0.12 * rng.normal(size=(nlive, d)), 0.01, 0.99)
    L = _loglike_np(u).astype(np.float32)
    layer = jml.ScalingLayer()
    layer.optimize(u, u)
    region = jml.SimpleRegion(u, layer)
    axes = np.diag(np.asarray(layer.axes, np.float32)) \
        if np.ndim(layer.axes) == 1 else np.asarray(layer.axes, np.float32)
    return u.astype(np.float32), L, region, axes


def _treg(d, on):
    """Packed p-space ellipsoid [ctr, invcov, enlarge], or the dummy."""
    if not on:
        return np.zeros(1, np.float32)
    return np.concatenate([np.full(d, 0.5), np.eye(d).ravel() / 0.3 ** 2,
                           [1.0]]).astype(np.float32)


def _samplers(engine, d, treg_on, **kw):
    common = dict(popsize=P, nsteps=NSTEPS, seed=0, **kw)
    if engine == 'rwalk':
        ref = jpop.FusedPopulationRandomWalkSampler(
            jax_loglike=_loglike_jax, **common)
        port = tpop.FusedPopulationRandomWalkSampler(
            torch_loglike=_loglike_torch, device='cpu', **common)
    else:
        ref = jpop.FusedPopulationSliceSampler(
            jax_loglike=_loglike_jax, engine=engine, **common)
        port = tpop.FusedPopulationSliceSampler(
            torch_loglike=_loglike_torch, engine=engine, device='cpu',
            **common)
    if treg_on:
        ref._treg_key = (True, d)
        port._treg_key = (True, d)
    return ref, port


def _ref_classic(ref, engine, npad, d):
    build = {'sync': '_build', 'async': '_build_async',
             'rwalk': '_build_rwalk'}[engine]
    return getattr(ref, build)(npad, d)


CASES = [('sync', 3, 0, False), ('sync', 5, 1, True),
         ('async', 3, 2, False), ('async', 4, 3, True),
         ('rwalk', 3, 4, False), ('rwalk', 5, 5, True)]


@pytest.mark.parametrize('engine,d,seed,treg_on', CASES)
def test_classic_walk_matches_reference_draws(engine, d, seed, treg_on):
    u, L, region, axes = _state(d, seed)
    nlive = len(u)
    npad = round_up(nlive)
    live_u = pad_rows(u, npad)
    live_L = pad_rows(L, npad, fill=-np.inf)
    Lmin = np.float32(np.sort(L)[nlive // 4])
    treg = _treg(d, treg_on)
    # async in classic mode stops at harvest_frac of the walkers
    kw = dict(harvest_frac=0.75) if engine == 'async' else {}
    ref, port = _samplers(engine, d, treg_on, **kw)
    key = np.array([7 + seed, 11 * seed + 3], np.uint32)
    want = np.asarray(_ref_classic(ref, engine, npad, d)(
        key, live_u, live_L, np.int32(nlive), axes, Lmin, np.float32(0.8),
        treg))
    rows, scal = want[:-1], want[-1]

    banks = _banks(engine, key, nlive, d, harvest=True)
    axes_t, _, treg_t = convert.walk_inputs(axes, axes, treg, 'cpu')
    got = [a.numpy() for a in port._walk(
        banks, torch.as_tensor(live_u), torch.as_tensor(live_L), nlive,
        axes_t, float(Lmin), 0.8, treg_t)]
    uf, Lf, done, idx0, nc, nu, width, eff = got
    np.testing.assert_array_equal(idx0, rows[:, d + 2])
    np.testing.assert_array_equal(done, rows[:, d + 1] > 0.5)
    assert nc == scal[0] and nu == scal[3], (nc, nu, scal)
    np.testing.assert_allclose(uf, rows[:, :d], rtol=0, atol=1e-6)
    np.testing.assert_allclose(Lf, rows[:, d], rtol=0, atol=1e-6)
    # [ncall, efficiency, width (rwalk: acceptance rate), nuseful]
    np.testing.assert_allclose(eff, scal[1], rtol=1e-6)
    np.testing.assert_allclose(width, scal[2], rtol=1e-6)
    assert done.any() and nu == nc
    if engine == 'async':
        # walkers finishing in one round may overshoot the target
        assert done.sum() >= int(np.ceil(0.75 * P)) or \
            port.walk_log[-1]['rounds'] == MAX_IT * NSTEPS
        assert port.walk_log[-1]['reads'] == port.walk_log[-1]['rounds']
    if engine == 'rwalk':
        assert 0 < eff < 1 and port.walk_log[-1]['reads'] == 0
    if engine == 'sync':
        st = port.walk_log[-1]
        assert st['rounds'] % tpop.SYNC_CHECK_EVERY == 0
        assert st['reads'] == st['rounds'] // tpop.SYNC_CHECK_EVERY > 0


@pytest.mark.parametrize('engine,d,seed,treg_on', CASES)
def test_segment_dispatch_matches_reference(engine, d, seed, treg_on):
    """Walk + consume, against ``_build_segment_single`` (async: the
    spec kernel at depth 1, ``popfused.py:1236-1241``)."""
    u, L, region, axes = _state(d, seed + 10)
    nlive = len(u)
    npad = round_up(nlive)
    live_u = pad_rows(u, npad)
    live_L = pad_rows(L, npad, fill=np.inf)
    treg = _treg(d, treg_on)
    ref, port = _samplers(engine, d, treg_on)
    ref._seg_ndim = port._seg_ndim = d
    tpack = ref._pack_whiten(region)
    key = np.array([3 + seed, 5 * seed + 1], np.uint32)
    want = [np.asarray(a) for a in ref._build_segment_single(npad, d)(
        key, live_u, live_L, np.int32(nlive), axes, np.float32(1.0), treg,
        tpack)]

    banks = _banks(engine, key, nlive, d)
    axes_t, tpack_t, treg_t = convert.walk_inputs(axes, tpack, treg, 'cpu')
    kernels.reset_counts()
    lu2, lL2, packed, counts = [a.numpy() for a in port._run_segment(
        banks, torch.as_tensor(live_u), torch.as_tensor(live_L), nlive,
        axes_t, 1.0, treg_t, tpack_t)]
    assert kernels.PLAIN_CALLS['consume_scan'] == 1
    if engine == 'async':
        assert banks['xibank'].shape[2] == 1
    np.testing.assert_allclose(lu2, want[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(lL2, want[1], rtol=0, atol=1e-6)
    rows, scal = packed[:-1], packed[-1]
    wrows, wscal = want[2][:-1], want[2][-1]
    assert packed.shape == want[2].shape == (P + 1, d + 7)
    np.testing.assert_allclose(rows[:, :d + 1], wrows[:, :d + 1], rtol=0,
                               atol=1e-6)
    # [accept, worst, Lmin, rank, flags, jump2]
    for c in (1, 2, 4, 5):
        np.testing.assert_array_equal(rows[:, d + c], wrows[:, d + c])
    np.testing.assert_allclose(rows[:, d + 3], wrows[:, d + 3], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(rows[:, d + 6], wrows[:, d + 6], rtol=1e-5,
                               atol=1e-9)
    # [nc, done_frac, width, nuseful, ref2, 0...]
    assert list(counts) == [scal[0], scal[3]] == [wscal[0], wscal[3]]
    # a mean of 0/1 flags, divided in another order
    np.testing.assert_allclose(scal[1], wscal[1], rtol=1e-6)
    np.testing.assert_allclose(scal[2], wscal[2], rtol=1e-6)
    np.testing.assert_allclose(scal[4], wscal[4], rtol=1e-6)
    assert rows[:, d + 1].sum() > 0


def test_async_segment_walks_the_spec_walk_at_depth_one(monkeypatch):
    """The async engine's segment dispatch is ``spec_walk`` with D = 1;
    its classic dispatch caps the rounds at ``max_it * nsteps``."""
    seen = []
    walk = tpop.spec_walk

    def spy(banks, *a, **kw):
        seen.append(tuple(banks['xibank'].shape))
        return walk(banks, *a, **kw)
    monkeypatch.setattr(tpop, 'spec_walk', spy)
    u, L, region, _ = _state(3, 4)
    port = tpop.FusedPopulationSliceSampler(
        popsize=P, nsteps=NSTEPS, torch_loglike=_loglike_torch,
        engine='async', max_it=3, device='cpu')
    treg_region = tml.SimpleRegion(u.astype(float), _port_layer(u),
                                   device='cpu')
    port.segment_start(u, L)
    port.segment_launch(treg_region)
    port.segment_fetch()
    port._pending = port._launch(treg_region, float(np.sort(L)[3]),
                                 u.astype(float), L.astype(float))
    port._harvest(treg_region, lambda x: x, _loglike_np,
                  float(np.sort(L)[3]))
    assert seen == [(tpop.spec_max_rounds(NSTEPS, 3, 1), P, 1),
                    (3 * NSTEPS, P, 1)]


def _port_layer(u):
    layer = tml.ScalingLayer()
    layer.optimize(u.astype(float), u.astype(float))
    return layer


# --- end to end ------------------------------------------------------------

RUN = dict(viz_callback=False, show_status=False, max_num_improvement_loops=0,
           min_ess=0, dlogz=2.0, frac_remain=0.1)
# the reference's engine tests (tests/test_popfused.py:40-107): sync on
# the default region, async and the random walk on a SimpleRegion with
# a ScalingLayer
ENGINE_RUNS = {
    'sync': dict(prob=('gauss', dict(ndim=2, sigma=0.1)), popsize=64,
                 nsteps=8, live=100),
    'async': dict(prob=('asymgauss', dict(ndim=8, sigma_min=0.02)),
                  popsize=128, nsteps=16, live=200),
    'rwalk': dict(prob=('asymgauss', dict(ndim=8, sigma_min=0.02)),
                  popsize=128, nsteps=40, scale=0.1, live=200),
}


def _run(pkg, engine, seed):
    cfg = dict(ENGINE_RUNS[engine])
    name, kw = cfg.pop('prob')
    run = dict(RUN, min_num_live_points=cfg.pop('live'))
    if pkg == 'jax':
        prob = getattr(jmodels, name)(**kw)
        s = ultranest_tpu.ReactiveNestedSampler(
            prob.param_names, prob.loglike, vectorized=True, seed=seed)
        fn = dict(jax_loglike=prob.jax_loglike)
        layer, region, mod = jml.ScalingLayer, jml.SimpleRegion, jpop
    else:
        prob = getattr(problems, name)(**kw)
        s = ultranest_torch.ReactiveNestedSampler(
            prob.param_names, prob.loglike, vectorized=True, seed=seed,
            device='cpu')
        fn = dict(torch_loglike=prob.torch_loglike, device='cpu')
        layer, region, mod = tml.ScalingLayer, tml.SimpleRegion, tpop
    if engine != 'sync':
        s.transform_layer_class = layer
        run.update(region_class=region, cluster_num_live_points=0)
    if engine == 'rwalk':
        s.stepsampler = mod.FusedPopulationRandomWalkSampler(
            seed=seed, **fn, **cfg)
    else:
        s.stepsampler = mod.FusedPopulationSliceSampler(
            seed=seed, engine=engine, **fn, **cfg)
    kernels.reset_counts()
    return s, s.run(**run)


def _gate(engine, res):
    """The reference tests' gates (``tests/test_popfused.py:51,70,106``)."""
    if engine == 'sync':
        return abs(res['logz']) < 1.0
    return abs(res['logz']) < 3 * max(res['logzerr'], 0.5)


@pytest.mark.parametrize('engine', sorted(ENGINE_RUNS))
def test_engine_run_matches_jax_package(engine):
    """Segment mode on the CPU, gated as the reference's engine tests
    gate, and within 4 sigma of the JAX package's logZ pooled over two
    seeds."""
    ours, theirs = [], []
    for seed in (1, 2):
        port, res = _run('torch', engine, seed)
        assert port._segment_exits, 'segment path never engaged'
        assert kernels.PLAIN_CALLS['consume_scan'] > 0
        assert sum(kernels.LAUNCHES.values()) == 0          # no card here
        assert np.isfinite(res['samples']).all()
        ss = port.stepsampler
        assert ss.ncalls == ss.ncalls_useful > 0 and ss.logstat
        assert all(w['nsteps'] == ss.nsteps for w in ss.walk_log)
        ours.append(res)
        theirs.append(_run('jax', engine, seed)[1])
    for res in ours + theirs:
        assert _gate(engine, res), (res['logz'], res['logzerr'])
    if engine == 'rwalk':
        assert port.stepsampler.scale != 0.1

    def pooled(rs):
        return (np.mean([r['logz'] for r in rs]),
                np.sqrt(np.sum([r['logzerr'] ** 2 for r in rs])) / len(rs))
    (m1, e1), (m2, e2) = pooled(ours), pooled(theirs)
    assert abs(m1 - m2) < 4 * np.hypot(e1, e2), (m1, e1, m2, e2)
    assert sorted(ours[0]) == sorted(theirs[0])
