"""The spec-depth probe and the round overhead A it is weighed against,
on the CPU.

* ``optimal_spec_depth`` equals the JAX package's
  (``ultranest_tpu/popfused.py:43``) over a grid of likelihood cost per
  batch, round overhead and configured depth.
* On the CPU the probe times the eager call with the host clock and
  returns seconds per popsize-row batch: the rows of one round at the
  configured depth, divided by the depth. It never tries a CUDA graph.
* ``round_overhead``, the helper that measures A, runs rounds with the
  likelihood replaced by a constant, and leaves the walk's state as the
  real rounds (the spec walk's, ``popfused._SpecWalk.round``) with that
  likelihood leave it.

The card's side (the probe as a captured graph's replay, the same depth
on two calls, A from a captured chunk) is in ``tests/test_torch_cuda.py``.
"""
import time

import numpy as np
import pytest
import torch

import ultranest_tpu.popfused as jpop
import ultranest_torch.popfused as tpop


def _same_bits(a, b):
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


@pytest.mark.parametrize('overhead', [1e-6, 1e-5, 3e-5, tpop.ROUND_OVERHEAD_S,
                                      350e-6, 5e-3])
@pytest.mark.parametrize('dmax', [1, 2, 3, 4, 8, 16])
def test_optimal_spec_depth_matches_the_jax_package(overhead, dmax):
    for t_row in np.logspace(-8, -1, 57):
        assert tpop.optimal_spec_depth(t_row, dmax, overhead) == \
            jpop.optimal_spec_depth(t_row, dmax, overhead), \
            (t_row, dmax, overhead)


def _sampler(loglike, popsize=32, **kw):
    return tpop.FusedPopulationSliceSampler(
        popsize=popsize, nsteps=4, torch_loglike=loglike, device='cpu',
        spec_depth_auto=True, **kw)


@pytest.mark.parametrize('depth', [8, 4, 2])
def test_probe_on_the_cpu_times_the_host_clock_per_batch(depth, monkeypatch):
    """A likelihood that sleeps 10 ms per 32 rows costs 10 ms per
    popsize-row batch whatever the depth and nothing beyond its rows;
    the probe reads the host clock on popsize x depth rows and on one
    popsize batch, and takes no graph. (The bounds leave room for the
    sleeps' overshoot on a busy host: the batch cost is a difference of
    two timings.)"""
    rows_seen = []

    def sleepy(x):
        rows_seen.append(x.shape[0])
        time.sleep(1e-2 * x.shape[0] / 32)
        return -((x - 0.5) ** 2).sum(dim=1)

    def no_graph(*a, **kw):
        raise AssertionError('a CUDA graph on the CPU')
    monkeypatch.setattr(tpop, 'graph_call_seconds', no_graph)
    monkeypatch.setattr(tpop, '_PROBE_CACHE', {})
    s = _sampler(sleepy, spec_depth=depth)
    probe = s._probe_likelihood_cost(2)
    assert probe['how'] == 'host'
    assert rows_seen == [32 * depth] * 4 + [32] * 4
    assert 7e-3 <= probe['t_row_s'] < 2e-2
    assert 0 <= probe['fixed_s'] < 5e-3
    del rows_seen[:]
    s._resolve_spec_depth(2)
    assert len(rows_seen) == 8
    got = s.spec_probe
    assert got['how'] == 'host' and got['depth_from'] == depth
    assert got['round_overhead_s'] == tpop.ROUND_OVERHEAD_S
    assert 7e-3 <= got['t_row_s'] < 2e-2
    assert s.spec_depth == got['depth'] == tpop.optimal_spec_depth(
        got['t_row_s'], depth, tpop.ROUND_OVERHEAD_S + got['fixed_s'])
    # 10 ms a batch is far above A: depth 1 wins from 4 and 8 (from 2 it
    # does not win by the 20% a change needs)
    assert s.spec_depth == (1 if depth > 2 else 2)
    # a second sampler of the same model reads the memo
    again = _sampler(sleepy, spec_depth=depth)
    again._resolve_spec_depth(2)
    assert len(rows_seen) == 8
    assert again.spec_probe == got


def test_probe_counts_a_likelihoods_fixed_cost_in_the_round(monkeypatch):
    """A likelihood whose call costs 4 ms whatever its rows has no cost
    per batch: the round's fixed cost takes it, and the depth stays."""
    def fixed_cost(x):
        time.sleep(4e-3)
        return -((x - 0.5) ** 2).sum(dim=1)
    monkeypatch.setattr(tpop, '_PROBE_CACHE', {})
    s = _sampler(fixed_cost)
    s._resolve_spec_depth(2)
    got = s.spec_probe
    assert got['t_row_s'] < 1e-3 and 3e-3 < got['fixed_s'] < 2e-2
    # timing the rows of one round alone and dividing by the depth would
    # charge 0.5 ms a batch, and lower the depth
    assert tpop.optimal_spec_depth(4e-3 / 8, 8) < 8
    assert s.spec_depth == got['depth'] == 8


def test_probe_is_not_run_where_it_is_off():
    s = _sampler(lambda x: -x.sum(dim=1))
    s.spec_depth_auto = False
    s._resolve_spec_depth(2)
    assert s.spec_probe is None and s.spec_depth == 8


def _walk_state(P, D, d, nsteps, seed):
    """A spec walk mid-dispatch on the CPU, with its bank, directions,
    threshold and a constant likelihood."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    walk = tpop._SpecWalk(P, D, d, nsteps, 8, P, 'cpu')
    st = walk.state
    st['u'].copy_(torch.as_tensor(rng.uniform(0.05, 0.95, (P, d)).astype(f32)))
    st['v'].copy_(torch.as_tensor((0.1 * rng.normal(size=(P, d))).astype(f32)))
    tl, tr = tpop._cube_intersection(st['u'], st['v'])
    st['tl'].copy_(tl)
    st['tr'].copy_(tr)
    st['step'].copy_(torch.as_tensor(rng.randint(0, nsteps, P)))
    st['done'].copy_(torch.as_tensor(rng.uniform(size=P) < 0.1))
    walk.xibank.copy_(torch.as_tensor(rng.uniform(size=(8, P, D))
                                      .astype(f32)))
    walk.dirbank.copy_(torch.as_tensor((0.1 * rng.normal(size=(nsteps, P, d)))
                                       .astype(f32)))
    Lconst = torch.as_tensor(rng.normal(size=P * D).astype(f32))
    walk.Lmin.copy_(torch.quantile(Lconst, 0.75))
    walk.evaluate = lambda rows: (Lconst, None)
    return walk, Lconst


@pytest.mark.parametrize('P,D,d,rounds', [(64, 8, 5, 1), (64, 8, 5, 8),
                                          (33, 1, 3, 4), (20, 4, 12, 6)])
def test_round_overhead_leaves_the_state_of_real_rounds(P, D, d, rounds):
    """The rounds A is measured on are the walk's rounds with the
    likelihood replaced by a constant."""
    walk, Lconst = _walk_state(P, D, d, 5, P + d)
    st = {k: t.clone() for k, t in walk.state.items()}
    for _ in range(rounds):
        walk.round()
    want = walk.state
    a = tpop.round_overhead(st, walk.xibank, walk.dirbank, walk.Lmin, Lconst,
                            rounds=rounds, trials=3)
    assert 0 < a < 1.0
    for k in want:
        assert _same_bits(st[k], want[k]), k
    assert int(st['it']) == rounds
    # the constant likelihood hits: walkers accept and move
    assert int(st['nw']) > 0 and int(st['ncr']) > 0


def test_measure_round_overhead_on_the_cpu():
    """The one-call helper runs at a spec problem's shape and returns
    seconds a round (host clock here; a device time only on a card)."""
    a = tpop.measure_round_overhead(128, 8, 8, 16, device='cpu', trials=2)
    assert 0 < a < 1.0
