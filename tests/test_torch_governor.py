"""The port's adaptive-nsteps governor and spec-depth probe, on the CPU.

* The same sequences of jump-distance readings, segment records and
  insertion ranks fed to the JAX package's sampler and the port's give
  the same nsteps trajectory, the same growth, grace and streak state
  and the same ``logstat`` (``ultranest_tpu/popfused.py:1043-1141,
  1469-1510``).
* After a doubling the next dispatch draws its banks at the new nsteps,
  and the records of dispatches launched before it are ignored.
* ``optimal_spec_depth`` equals the reference's on a grid; the probe is
  off on a CPU device by default and memoised per model and shape.
* A governed 10-d gaussian run grows nsteps and agrees with the JAX
  package's logZ.
"""
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
from ultranest_torch.models import problems
from ultranest_torch.ops import kernels

STATE = ('nsteps', '_nsteps_grew', '_gm_grace', '_gm_low_streak')


def _loglike_torch(x):
    return -((x - 0.5) ** 2).sum(dim=1)


def _pair(nsteps=8, popsize=64, **kw):
    ref = jpop.FusedPopulationSliceSampler(
        popsize=popsize, nsteps=nsteps, jax_loglike=lambda x: -x.sum(axis=1),
        adaptive_nsteps=True, **kw)
    port = tpop.FusedPopulationSliceSampler(
        popsize=popsize, nsteps=nsteps, torch_loglike=_loglike_torch,
        adaptive_nsteps=True, device='cpu', **kw)
    return ref, port


def _state_of(s):
    return tuple(getattr(s, k) for k in STATE)


GM = 0.8
# (far_frac, nchains, at: 'now' or 'stale', rel_jump_gm, gm_target)
SEQUENCES = {
    # far-enough fraction below 1/2 doubles up to the ceiling
    'growth': [(0.3, 100, 'now', None, None)] * 5,
    # comfortably decorrelated chains that never grew decay gently
    'decay': [(0.95, 100, 'now', None, None)] * 6,
    # records launched at an older nsteps, and too few chains, change
    # nothing
    'stale': [(0.2, 100, 'now', None, None), (0.1, 100, 'stale', None, None),
              (0.1, 7, 'now', None, None), (0.2, 100, 'now', None, None)],
    # a low GM relative jump: two lows in a row double, the grace after
    # a growth absorbs two lows, a normal reading ends the grace
    'gm_streak': [(0.95, 100, 'now', 0.5 * GM, GM)] * 7
    + [(0.95, 100, 'now', GM, GM), (0.95, 100, 'now', 0.5 * GM, GM),
       (0.95, 100, 'now', 0.5 * GM, GM)],
    # the ceiling stops growth however low the readings go
    'max_nsteps': [(0.1, 100, 'now', 0.1 * GM, GM)] * 4,
}


@pytest.mark.parametrize('name', sorted(SEQUENCES))
def test_adapt_nsteps_decisions_match_reference(name):
    kw = dict(max_nsteps=32) if name == 'max_nsteps' else {}
    ref, port = _pair(nsteps=32 if name == 'decay' else 8, **kw)
    if name == 'decay':
        # a chain length above the floor that no growth produced
        ref.nsteps_min = port.nsteps_min = 8
    traj = []
    prev = None
    for far, nch, at, gm, target in SEQUENCES[name]:
        for s in (ref, port):
            at_nsteps = s.nsteps if at == 'now' else prev
            s._adapt_nsteps(far, nch, at_nsteps, rel_jump_gm=gm,
                            gm_target=target)
        assert _state_of(port) == _state_of(ref)
        prev = port.nsteps if prev is None else prev
        traj.append(port.nsteps)
    assert len(set(traj)) > 1 or name == 'stale'
    if name == 'max_nsteps':
        assert traj[-1] == 32
    if name == 'decay':
        assert traj == [22, 15, 10, 8, 8, 8]


def _regions(rng, d=6, nlive=80):
    """A reference SimpleRegion and the port's copy of it."""
    u = np.clip(0.5 + 0.1 * rng.normal(size=(nlive, d)), 0.01, 0.99)
    layer = jml.ScalingLayer()
    layer.optimize(u, u)
    tlayer = tml.ScalingLayer()
    tlayer.optimize(u, u)
    return jml.SimpleRegion(u, layer), tml.SimpleRegion(u, tlayer,
                                                        device='cpu')


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_segment_diagnose_logstat_matches_reference(seed):
    """Segment records drive the same logstat rows and nsteps steps."""
    rng = np.random.RandomState(seed)
    ref, port = _pair()
    jreg, treg = _regions(rng)
    ref2 = 0.3
    traj = []
    for k in range(14):
        # chains that travel a short, then a long way, with a stale
        # record among them
        mu = [-3.0, -1.0, 0.5, 2.0][min(k // 4, 3)]
        n = 64
        rec = dict(accept=rng.uniform(size=n) < 0.9,
                   jump2=ref2 * np.exp(rng.normal(mu, 1.0, size=n)),
                   done_frac=1.0, ref2_dev=ref2 if k % 3 else 0.0)
        at = port.nsteps if k != 5 else port.nsteps // 2
        ref._segment_diagnose(dict(rec), at, jreg)
        port._segment_diagnose(dict(rec), at, treg)
        assert _state_of(port) == _state_of(ref)
        traj.append(port.nsteps)
    np.testing.assert_allclose(port.logstat, ref.logstat, rtol=1e-12)
    assert len(port.logstat) == 14 and traj[-1] > 8


RANKS = {
    # uniform insertion ranks: no alarm
    'uniform': lambda rng, n: rng.randint(0, 101, size=n),
    # ranks crowding the bottom: the 4-sigma alarm doubles nsteps
    'biased': lambda rng, n: np.minimum(rng.randint(0, 101, size=n),
                                        rng.randint(0, 101, size=n)),
}


@pytest.mark.parametrize('kind', sorted(RANKS))
def test_insertion_rank_alarm_matches_reference(kind):
    rng = np.random.RandomState(3)
    ref, port = _pair(max_nsteps=64)
    traj = []
    for k in range(12):
        ranks = RANKS[kind](rng, 400)
        # a batch launched before a growth only resets the accumulator
        rec_nsteps = port.nsteps if k != 4 else port.nsteps // 2
        for s in (ref, port):
            s.observe_insertion_ranks(ranks, 100, rec_nsteps)
        assert _state_of(port) == _state_of(ref)
        assert port._mww_acc.N == ref._mww_acc.N
        traj.append(port.nsteps)
    if kind == 'biased':
        assert traj[-1] == 64 and port._nsteps_grew
    else:
        assert traj[-1] == 8 and not port._nsteps_grew


def test_doubling_redraws_banks_and_ignores_stale_records():
    """Dispatches queued at the old nsteps are ignored after a growth;
    the next dispatch walks at the new nsteps."""
    rng = np.random.RandomState(4)
    _, treg = _regions(rng, d=3)
    u = treg.u.astype(np.float32)
    L = -((u - 0.5) ** 2).sum(axis=1)
    port = tpop.FusedPopulationSliceSampler(
        popsize=32, nsteps=4, torch_loglike=_loglike_torch,
        adaptive_nsteps=True, device='cpu', spec_depth=4)
    port.segment_start(u, L)
    port.segment_launch(treg)
    port.segment_launch(treg)
    port.segment_fetch()
    port._adapt_nsteps(0.1, 32, 4)                  # a growth: 4 -> 8
    assert port.nsteps == 8 and port._gm_grace == 2
    rec = port.segment_fetch()                      # launched at 4
    assert rec['nsteps'] == 4 and port.logstat[-1][3] == 4.0
    assert port.nsteps == 8 and port._gm_grace == 2
    port.segment_launch(treg)
    assert [w['nsteps'] for w in port.walk_log] == [4, 4, 8]
    banks = port._draw_banks(len(u), 3)
    assert banks['i1'].shape == (8, 32)
    assert banks['xibank'].shape[0] == tpop.spec_max_rounds(8, 64, 4)
    assert port.segment_fetch()['nsteps'] == 8


# --- the spec-depth probe --------------------------------------------------

@pytest.mark.parametrize('overhead', [350e-6, tpop.ROUND_OVERHEAD_S, 5e-3])
def test_optimal_spec_depth_matches_reference(overhead):
    for t_row in np.logspace(-7, -1, 25):
        for dmax in (1, 2, 4, 8, 16):
            assert tpop.optimal_spec_depth(t_row, dmax, overhead) == \
                jpop.optimal_spec_depth(t_row, dmax, overhead), \
                (t_row, dmax, overhead)


def test_spec_depth_probe_is_off_on_cpu_and_memoised(monkeypatch):
    calls = []

    def slow_loglike(x):
        # ~10 ms per popsize-row batch: far above the round overhead,
        # so depth 1 wins
        import time
        time.sleep(0.01 * x.shape[0] / 64)
        return -((x - 0.5) ** 2).sum(dim=1)
    probe = tpop.FusedPopulationSliceSampler._probe_likelihood_cost

    def counted(self, x_dim):
        calls.append(x_dim)
        return probe(self, x_dim)
    monkeypatch.setattr(tpop.FusedPopulationSliceSampler,
                        '_probe_likelihood_cost', counted)
    monkeypatch.setattr(tpop, '_PROBE_CACHE', {})
    u = np.random.RandomState(0).uniform(size=(40, 2)).astype(np.float32)
    L = -((u - 0.5) ** 2).sum(axis=1)

    def started(popsize=64, **kw):
        s = tpop.FusedPopulationSliceSampler(
            popsize=popsize, nsteps=4, torch_loglike=slow_loglike,
            device='cpu', **kw)
        s.segment_start(u, L)
        return s
    assert started().spec_depth == 8 and calls == []
    assert started(engine='async', spec_depth_auto=True).spec_depth == 8
    assert calls == []
    assert started(spec_depth_auto=True).spec_depth == 1
    assert started(spec_depth_auto=True).spec_depth == 1
    assert calls == [2]                     # memoised: probed once
    s = started(spec_depth_auto=True, popsize=32)
    assert s.spec_depth == 1 and calls == [2, 2]
    # the probe times the rows of one round at the configured depth
    t_row = tpop._PROBE_CACHE[(slow_loglike, None, 64, 2, 8,
                               torch.device('cpu'))]['t_row_s']
    assert 0.005 < t_row < 0.1


# --- end to end ------------------------------------------------------------

RUN = dict(min_num_live_points=150, viz_callback=False, show_status=False,
           max_num_improvement_loops=0, min_ess=0, dlogz=2.0,
           frac_remain=0.1, cluster_num_live_points=0)
GOVERNED = dict(popsize=128, nsteps=2, spec_depth=8, engine='spec',
                adaptive_nsteps=True, max_nsteps=64)


def _governed_run(pkg, seed):
    if pkg == 'jax':
        prob = jmodels.gauss(ndim=10, sigma=0.1)
        s = ultranest_tpu.ReactiveNestedSampler(
            prob.param_names, prob.loglike, vectorized=True, seed=seed)
        s.transform_layer_class = jml.ScalingLayer
        s.stepsampler = jpop.FusedPopulationSliceSampler(
            jax_loglike=prob.jax_loglike, seed=seed, **GOVERNED)
        return s, s.run(region_class=jml.SimpleRegion, **RUN)
    prob = problems.gauss(ndim=10, sigma=0.1)
    s = ultranest_torch.ReactiveNestedSampler(
        prob.param_names, prob.loglike, vectorized=True, seed=seed,
        device='cpu')
    s.transform_layer_class = tml.ScalingLayer
    s.stepsampler = tpop.FusedPopulationSliceSampler(
        torch_loglike=prob.torch_loglike, seed=seed, device='cpu',
        **GOVERNED)
    fed = []
    observe = s.stepsampler.observe_insertion_ranks

    def spy(ranks, nlive, rec_nsteps=None):
        fed.append((len(ranks), nlive, rec_nsteps))
        return observe(ranks, nlive, rec_nsteps)
    s.stepsampler.observe_insertion_ranks = spy
    kernels.reset_counts()
    return s, s.run(region_class=tml.SimpleRegion, **RUN), fed


def test_governed_gauss_run_grows_nsteps_and_matches_jax_package():
    ours, theirs = [], []
    for seed in (1, 2):
        port, res, fed = _governed_run('torch', seed)
        ss = port.stepsampler
        assert port._segment_exits and ss.nsteps > 2, ss.nsteps
        walked = [w['nsteps'] for w in ss.walk_log]
        assert walked == sorted(walked) and walked[-1] == ss.nsteps
        assert {row[3] for row in ss.logstat} <= set(walked)
        # the integrator feeds the accepted insertions of every segment
        # with the chain length its dispatch was launched at (None: one
        # rank from the classic loop)
        assert all(n == 150 and (r in walked or r is None and k == 1)
                   for k, n, r in fed)
        assert len({r for _, _, r in fed} - {None}) >= 2
        assert np.isfinite(res['samples']).all()
        ours.append(res)
        ref, res_ref = _governed_run('jax', seed)
        assert ref.stepsampler.nsteps > 2
        theirs.append(res_ref)
    for res in ours + theirs:
        assert abs(res['logz']) < max(4 * res['logzerr'], 2.0), \
            (res['logz'], res['logzerr'])
    m1, m2 = (np.mean([r['logz'] for r in rs]) for rs in (ours, theirs))
    e1, e2 = (np.sqrt(np.sum([r['logzerr'] ** 2 for r in rs])) / 2
              for rs in (ours, theirs))
    assert abs(m1 - m2) < 4 * np.hypot(e1, e2), (m1, e1, m2, e2)
