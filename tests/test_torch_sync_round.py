"""The sync and random walks as kernels and graphs (K4 at depth 1 with K6
``sync_update``, K7 ``rwalk_accept``), on the CPU.

* ``spec_propose_plain`` at D = 1 and ``sync_update_plain`` reproduce
  the sync walk's host loop of torch operators (kept here as it was,
  ``_old_sync_walk``) bit for bit: P 63 to 128, d 2, 5 and 8, the p-space
  filter on and off, steps that end at ``max_it`` with walkers that
  never accept, steps where every walker accepts in its first
  iteration, odd P for the median; the walk's rounds are the loop's
  shrink iterations, rounded up to a whole chunk of
  ``SYNC_CHECK_EVERY``;
* rounds run after the flag change nothing, and the bank row stays in
  range;
* ``rwalk_accept_plain`` reproduces the random walk's scan body (kept
  here as it was, ``_old_rwalk_walk``), with rows outside the cube, on
  its faces and NaN likelihoods;
* the graph drivers of both walks, with the CUDA graph replaced by a
  stand-in that runs the round body: their reads, rounds, replays and
  launches as stated, their outputs bit-equal to the host loop's.

The walks here are the port's alone: ``tests/test_torch_engines.py``
holds them to the JAX package's draws.
"""
import collections
import math

import numpy as np
import pytest
import torch

from ultranest_torch import popfused
from ultranest_torch.ops import kernels
from ultranest_torch.ops.pairwise import pad_rows, round_up
from torch_port_helpers import StandInGraphs

NSTEPS = 6
CENTER = np.array([0.5, 0.45, 0.55, 0.6, 0.4, 0.5, 0.52, 0.47])


def _loglike(x):
    c = torch.as_tensor(CENTER[:x.shape[1]], dtype=x.dtype)
    return -torch.abs(x - c).amax(dim=1)


def _evaluator(filtered):
    """The likelihood, behind a p-space filter (a slab on the first axis)
    where *filtered*."""
    if not filtered:
        return lambda rows: (_loglike(rows), None)

    def ev(rows):
        tin = rows[:, 0] < 0.62
        return torch.where(tin, _loglike(rows), -math.inf), tin
    return ev


def _bits(t):
    t = t.detach().cpu() if torch.is_tensor(t) else torch.as_tensor(t)
    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 \
        else t


def _assert_bits(a, b):
    assert torch.equal(_bits(a), _bits(b))


def _inputs(P, d, seed, nlive=80, max_it=16):
    """Live points around CENTER, a region's diagonal axes and one
    dispatch's sync banks."""
    rng = np.random.RandomState(seed)
    u = np.clip(CENTER[:d] + 0.12 * rng.normal(size=(nlive, d)), 0.01, 0.99)
    u = u.astype(np.float32)
    L = _loglike(torch.as_tensor(u)).numpy()
    npad = round_up(nlive)
    live_u = torch.as_tensor(pad_rows(u, npad))
    live_L = torch.as_tensor(pad_rows(L, npad, fill=np.inf))
    axes = torch.as_tensor(np.diag(u.std(axis=0)).astype(np.float32))
    g = torch.Generator().manual_seed(seed)
    banks = popfused.draw_sync_banks(g, P, NSTEPS, max_it, nlive, d)
    return banks, live_u, live_L, axes, L


# --------------------------------------------------------------------------
# the sync walk as it was: a host loop of torch operators, one shrink loop
# a step, its flag read every `every` iterations (the no-op iterations
# after every walker accepted bill nothing and change nothing)


def _old_cube_intersection(u, v):
    nz = v != 0
    a = torch.where(nz, (0.0 - u) / v, -np.inf)
    b = torch.where(nz, (1.0 - u) / v, np.inf)
    return torch.minimum(a, b).amax(dim=1), torch.maximum(a, b).amin(dim=1)


def _old_median(x):
    s = torch.sort(x).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def _old_sync_walk(banks, live_u, live_L, axes, Lmin, scale, evaluate,
                   every=2):
    tbank = banks['tbank']
    nsteps, max_it, P = tbank.shape
    dirbank = popfused._direction_bank(banks, live_u, axes, scale)
    idx0 = banks['idx0']
    u = live_u[idx0]
    L = live_L[idx0]
    dev = u.device
    nc = torch.zeros((), dtype=torch.int64, device=dev)
    acc_rates, widths = [], []
    iterations = 0
    for s in range(nsteps):
        v = dirbank[s]
        tl, tr = _old_cube_intersection(u, v)
        state = (tl, tr, u, L, torch.zeros(P, dtype=torch.bool, device=dev),
                 nc)
        it = 0
        while it < max_it:
            tlc, trc, unew, Lnew, done, nc = state
            running = ~done.all()
            iterations += int(running)
            t = tlc + tbank[s][it] * (trc - tlc)
            up = u + t[:, None] * v
            Lp, tin = evaluate(up)
            billed = P if tin is None else tin.sum()
            nc = nc + running * billed
            acc = (Lp > Lmin) & ~done
            unew = torch.where(acc[:, None], up, unew)
            Lnew = torch.where(acc, Lp, Lnew)
            done = done | acc
            rej = ~done
            tlc = torch.where(rej & (t < 0), t, tlc)
            trc = torch.where(rej & (t >= 0), t, trc)
            state = (tlc, trc, unew, Lnew, done, nc)
            it += 1
            if it % every == 0 and bool(done.all()):
                break
        tlf, trf, u, L, done, nc = state
        acc_rates.append(done.to(torch.float32).mean())
        widths.append(_old_median(trf - tlf))
    return (u, L, idx0, nc, torch.stack(widths).mean(),
            torch.stack(acc_rates).mean(), iterations)


# (P, d, filter on, threshold kind, max_it): 'mixed' a quantile of the
# live values; 'stuck' near the peak, so that steps end at max_it with
# walkers that never accept; 'first' -inf, every walker accepting in its
# first iteration
SYNC_CASES = [
    (64, 2, False, 'mixed', 16), (64, 5, True, 'mixed', 16),
    (100, 2, True, 'mixed', 16), (100, 8, False, 'mixed', 16),
    (128, 8, True, 'mixed', 16), (128, 5, False, 'mixed', 16),
    (64, 8, False, 'stuck', 4), (100, 5, True, 'stuck', 4),
    (128, 2, False, 'first', 16), (100, 8, False, 'first', 16),
    (63, 2, False, 'mixed', 16), (101, 5, True, 'mixed', 16),
    (127, 8, False, 'stuck', 3)]


def _threshold(kind, L):
    if kind == 'first':
        return -math.inf
    if kind == 'stuck':
        return float(np.float32(-0.004))
    return float(np.sort(L)[len(L) // 3])


@pytest.mark.parametrize('P,d,filtered,kind,max_it', SYNC_CASES)
def test_sync_walk_equals_the_old_host_loop(P, d, filtered, kind, max_it):
    banks, live_u, live_L, axes, L = _inputs(P, d, P + 10 * d, max_it=max_it)
    Lmin = _threshold(kind, L)
    ev = _evaluator(filtered)
    want = _old_sync_walk(banks, live_u, live_L, axes, Lmin, 0.8, ev)
    kernels.reset_counts()
    stats = {}
    got = popfused.sync_walk(banks, live_u, live_L, axes, Lmin, 0.8, ev,
                             stats=stats)
    uf, Lf, done, idx0, nc, nu, width, acc_rate = got
    for a, b in zip((uf, Lf, idx0, nc, width, acc_rate),
                    want[:2] + want[2:6]):
        _assert_bits(a, b)
    assert done.all() and nu is nc
    iterations = want[-1]
    every = popfused.SYNC_CHECK_EVERY
    # the rounds are the loop's shrink iterations, up to a whole chunk,
    # read with no lag on the CPU
    assert stats['rounds'] == min(-(-iterations // every) * every,
                                  NSTEPS * max_it)
    assert stats['reads'] == -(-stats['rounds'] // every)
    assert stats['graph'] is False and stats['replays'] == 0
    assert kernels.PLAIN_CALLS['spec_propose'] == \
        kernels.PLAIN_CALLS['sync_update'] == stats['rounds']
    if kind == 'first':
        assert iterations == NSTEPS and float(acc_rate) == 1.0
    if kind == 'stuck':
        # some step ran out of iterations with walkers still rejecting
        assert float(acc_rate) < 1.0
        assert (Lf == live_L[idx0]).any()


def _sync_walk_after(P, d, max_it, rounds, seed=3):
    """A sync walk on the CPU started, then *rounds* rounds run."""
    banks, live_u, live_L, axes, L = _inputs(P, d, seed, max_it=max_it)
    walk = popfused._SyncWalk(P, d, NSTEPS, max_it, 'cpu')
    walk.load(banks, live_u, live_L, axes, float(np.sort(L)[len(L) // 3]),
              0.8, _evaluator(True))
    walk.init()
    for _ in range(rounds):
        walk.round()
    return walk


def test_rounds_after_the_flag_change_nothing():
    P, d, max_it = 64, 5, 4
    walk = _sync_walk_after(P, d, max_it, NSTEPS * max_it)
    st = walk.state
    # every step ran within the cap: the flag is up, the bank row is the
    # last one
    assert bool(st['flag']) and int(st['s']) == NSTEPS
    assert int(st['row']) == NSTEPS * max_it - 1
    before = {k: t.clone() for k, t in st.items()}
    for _ in range(5):
        walk.round()
    for k in kernels.SYNC_STATE:
        _assert_bits(st[k], before[k])


def test_step_boundary_renews_every_walker():
    """After a step's last iteration: u is the step's accepted point, v
    the next direction, the bracket its full chord, nobody done, the
    step's fraction and median written, the bank row at the next step."""
    P, d, max_it = 65, 2, 16
    walk = _sync_walk_after(P, d, max_it, 0)
    st = walk.state
    n = 0
    while int(st['s']) == 0:
        un_before = st['un'].clone()
        done_before = st['done'].clone()
        walk.round()
        n += 1
    assert int(st['row']) == max_it and int(st['it']) == 0
    assert not st['done'].any() and not bool(st['flag'])
    _assert_bits(st['v'], walk.dirbank[1])
    tl, tr = kernels.cube_intersection(st['u'], st['v'])
    _assert_bits(st['tl'], tl)
    _assert_bits(st['tr'], tr)
    _assert_bits(st['u'], st['un'])
    assert float(st['accs'][0]) > 0 and float(st['widths'][0]) > 0
    assert float(st['accs'][1]) == float(st['widths'][1]) == 0.0
    # walkers done before the last iteration kept their point
    _assert_bits(st['un'][done_before], un_before[done_before])
    assert n <= max_it


# --------------------------------------------------------------------------
# the random walk as it was: nsteps steps of torch operators


def _old_rwalk_walk(banks, live_u, live_L, axes, Lmin, scale, evaluate):
    eps = banks['eps']
    nsteps, P, _ = eps.shape
    idx0 = banks['idx0']
    u = live_u[idx0]
    L = live_L[idx0]
    nacc = torch.zeros((), dtype=torch.int64, device=u.device)
    nc = torch.zeros((), dtype=torch.int64, device=u.device)
    axes_t = axes.T
    for s in range(nsteps):
        up = u + scale * (eps[s] @ axes_t)
        inside = ((up > 0) & (up < 1)).all(dim=1)
        Lev, tin = evaluate(up)
        Lp = torch.where(inside, Lev, -math.inf)
        acc = inside & (Lp > Lmin)
        u = torch.where(acc[:, None], up, u)
        L = torch.where(acc, Lp, L)
        nacc = nacc + acc.sum()
        nc = nc + (inside if tin is None else inside & tin).sum()
    acc_rate = nacc.to(torch.float32) / float(P * nsteps)
    return u, L, idx0, nc, acc_rate


def _rwalk_inputs(P, d, seed, nsteps=12):
    banks, live_u, live_L, axes, L = _inputs(P, d, seed)
    g = torch.Generator().manual_seed(seed + 1)
    banks = popfused.draw_rwalk_banks(g, P, nsteps, len(L), d)
    return banks, live_u, live_L, axes, L


@pytest.mark.parametrize('P,d,filtered,scale', [
    (64, 2, False, 0.5), (128, 8, True, 0.3), (100, 5, False, 4.0),
    (63, 8, True, 1.0)])
def test_rwalk_walk_equals_the_old_scan(P, d, filtered, scale):
    """Scale 4 sends most proposals out of the cube."""
    banks, live_u, live_L, axes, L = _rwalk_inputs(P, d, P + d)
    Lmin = float(np.sort(L)[len(L) // 3])
    ev = _evaluator(filtered)
    want = _old_rwalk_walk(banks, live_u, live_L, axes, Lmin, scale, ev)
    kernels.reset_counts()
    stats = {}
    got = popfused.rwalk_walk(banks, live_u, live_L, axes, Lmin, scale, ev,
                              stats=stats)
    uf, Lf, done, idx0, nc, nu, acc_rate = got
    for a, b in zip((uf, Lf, idx0, nc, acc_rate), want):
        _assert_bits(a, b)
    assert done.all() and nu is nc and 0 < float(acc_rate) < 1
    assert stats == dict(reads=0, rounds=banks['eps'].shape[0],
                         graph=False, replays=0, captures=0, capture_s=0.0)
    # a call a step and one for K7's prologue
    assert kernels.PLAIN_CALLS['rwalk_accept'] == banks['eps'].shape[0] + 1


def test_rwalk_accept_plain_at_the_edges():
    """Rows on a face (0 or 1 is outside), NaN coordinates and NaN or
    infinite likelihoods, the filter's rows, against a numpy model."""
    rng = np.random.RandomState(5)
    P, d = 40, 3
    up = rng.uniform(-0.2, 1.2, size=(P, d)).astype(np.float32)
    up[0] = [0.0, 0.5, 0.5]
    up[1] = [0.5, 1.0, 0.5]
    up[2] = [0.5, np.nan, 0.5]
    up[3:8] = rng.uniform(0.1, 0.9, size=(5, d))
    Lev = rng.normal(size=P).astype(np.float32)
    Lev[3] = np.nan
    Lev[4] = np.inf
    Lev[5] = -np.inf
    tin = rng.uniform(size=P) < 0.7
    u0 = rng.uniform(size=(P, d)).astype(np.float32)
    L0 = rng.normal(size=P).astype(np.float32)
    Lmin = np.float32(-0.3)
    for t in (tin, None):
        st = dict(u=torch.as_tensor(u0.copy()), L=torch.as_tensor(L0.copy()),
                  nacc=torch.zeros((), dtype=torch.int64),
                  nc=torch.full((), 7, dtype=torch.int64))
        kernels.rwalk_accept(torch.as_tensor(Lev),
                             None if t is None else torch.as_tensor(t),
                             torch.as_tensor(up), torch.tensor(Lmin), st)
        with np.errstate(invalid='ignore'):
            inside = ((up > 0) & (up < 1)).all(axis=1)
            acc = inside & (np.where(inside, Lev, -np.inf) > Lmin)
        assert not inside[:3].any() and acc.sum() > 3
        np.testing.assert_array_equal(
            st['u'].numpy(), np.where(acc[:, None], up, u0))
        np.testing.assert_array_equal(st['L'].numpy(),
                                      np.where(acc, Lev, L0))
        assert int(st['nacc']) == acc.sum()
        billed = inside if t is None else inside & t
        assert int(st['nc']) == 7 + billed.sum()


# --------------------------------------------------------------------------
# the graph drivers, the CUDA graph replaced by a stand-in


@pytest.mark.parametrize('finishing', [False, True])
def test_sync_graph_loop_reads_and_rounds(finishing):
    P, d, max_it = 64, 2, 13
    every = popfused.SYNC_CHECK_EVERY
    R = NSTEPS * max_it
    assert R % every
    banks, live_u, live_L, axes, L = _inputs(P, d, 11, max_it=max_it)
    # 1e30: no walker ever accepts, every step runs max_it iterations and
    # the flag rises at the cap
    # below every start: each step ends once every walker accepted
    Lmin = float(L.min()) - 0.01 if finishing else 1e30
    # (a walker that starts outside the filter's slab never accepts)
    ev = _evaluator(not finishing)
    host, graph = {}, {}
    want = popfused.sync_walk(banks, live_u, live_L, axes, Lmin, 0.8, ev,
                              stats=host)
    graphs = StandInGraphs('stand-in')
    kernels.reset_counts()
    got = popfused.sync_walk(banks, live_u, live_L, axes, Lmin, 0.8, ev,
                             stats=graph, graphs=graphs)
    for a, b in zip(got, want):
        _assert_bits(a, b)
    assert graph['graph'] and graph['captures'] == len(graphs.captured)
    assert graphs.captured == [every, 1]
    assert kernels.LAUNCHES['spec_propose'] == \
        kernels.LAUNCHES['sync_update'] == graph['rounds']
    # a CPU flag is read at once, whether the rounds ran as graphs or not
    assert graph['reads'] == host['reads']
    assert graph['rounds'] == host['rounds']
    if finishing:
        assert graph['rounds'] < R and graph['rounds'] % every == 0
        assert graph['reads'] == graph['rounds'] // every
        assert graph['replays'] == graph['rounds'] // every
    else:
        assert graph['rounds'] == R
        assert graph['reads'] == -(-R // every)
        assert graph['replays'] == R // every + R % every
        assert float(got[-1]) == 0.0
    # read one chunk behind, as on a card: the flag's chunk and one more
    # run, the rounds past the flag as exact no-ops, and one read fewer
    # waits
    walk = popfused._SyncWalk(P, d, NSTEPS, max_it, 'cpu')
    walk.load(banks, live_u, live_L, axes, Lmin, 0.8, ev)
    walk.init()
    reads, rounds = popfused._drive_rounds(walk.run_rounds, R, every, 1)
    for k, w in zip(('un', 'Ln', 'nc'), (0, 1, 4)):
        _assert_bits(walk.state[k], want[w])
    _assert_bits(walk.state['widths'].mean(), want[-2])
    _assert_bits(walk.state['accs'].mean(), want[-1])
    if finishing:
        assert rounds < R and rounds % every == 0
        assert reads == rounds // every - 1
        assert rounds - host['rounds'] == every
    else:
        assert rounds == R
        assert reads == -(-R // every) - 1
    again = {}
    popfused.sync_walk(banks, live_u, live_L, axes, Lmin, 0.8, ev,
                       stats=again, graphs=graphs)
    assert again['captures'] == 0 and again['graph']
    assert again['rounds'] == graph['rounds']


def test_rwalk_graph_is_the_whole_walk():
    P, d = 64, 8
    banks, live_u, live_L, axes, L = _rwalk_inputs(P, d, 4)
    nsteps = banks['eps'].shape[0]
    Lmin = float(np.sort(L)[len(L) // 3])
    ev = _evaluator(True)
    want = popfused.rwalk_walk(banks, live_u, live_L, axes, Lmin, 0.3, ev)
    graphs = StandInGraphs('stand-in')
    kernels.reset_counts()
    stats = {}
    got = popfused.rwalk_walk(banks, live_u, live_L, axes, Lmin, 0.3, ev,
                              stats=stats, graphs=graphs)
    for a, b in zip(got, want):
        _assert_bits(a, b)
    assert graphs.captured == [1]
    assert stats['graph'] and stats['replays'] == 1 and \
        stats['captures'] == 1
    assert stats['reads'] == 0 and stats['rounds'] == nsteps
    # one replay launches every step's K7 and K7's prologue
    assert kernels.LAUNCHES['rwalk_accept'] == nsteps + 1
    again = {}
    popfused.rwalk_walk(banks, live_u, live_L, axes, Lmin, 0.3, ev,
                        stats=again, graphs=graphs)
    assert again['captures'] == 0 and again['replays'] == 1


def test_sync_and_rwalk_samplers_log_their_walks_on_the_cpu():
    """The walk log of both samplers carries the graph keys; on the CPU
    no graph runs and none is made."""
    banks, live_u, live_L, axes, L = _inputs(48, 3, 2, max_it=8)
    for s in (popfused.FusedPopulationSliceSampler(
            popsize=48, nsteps=NSTEPS, torch_loglike=_loglike, engine='sync',
            max_it=8, device='cpu'),
            popfused.FusedPopulationRandomWalkSampler(
            popsize=48, nsteps=NSTEPS, torch_loglike=_loglike, device='cpu')):
        b = s._draw_banks(len(L), 3)
        s._walk(b, live_u, live_L, len(L), axes, float(np.sort(L)[20]), 0.5,
                torch.zeros(1))
        st = s.walk_log[-1]
        assert st['graph'] is False and st['captures'] == 0 and \
            st['replays'] == 0 and st['capture_s'] == 0.0
        assert getattr(s, '_graphs', None) is None


# --------------------------------------------------------------------------
# K6's median at a step boundary: every free case of the plain version,
# against a numpy model of the selection K6 makes (the least key whose
# count of keys at or below it exceeds the rank)


def _key_median(w):
    """The median of float32 widths *w* as K6 selects it: two order
    statistics of order-preserving 32-bit keys (-0 below +0, NaN above
    +inf), their midpoint rounded as float32."""
    w = np.asarray(w, dtype=np.float32)
    b = w.view(np.uint32)
    keys = np.where(np.isnan(w), np.uint32(0xffffffff),
                    np.where(b & 0x80000000, ~b, b | 0x80000000))
    keys = keys.astype(np.uint32)
    le = (keys[None, :] <= keys[:, None]).sum(axis=1)
    n = len(w)
    pair = []
    for r in ((n - 1) // 2, n // 2):
        k = keys[le > r].min()
        if k == 0xffffffff:
            pair.append(np.float32(np.nan))
        else:
            k = np.uint32(k & 0x7fffffff) if k & 0x80000000 else ~k
            pair.append(np.array([k], dtype=np.uint32).view(np.float32)[0])
    with np.errstate(invalid='ignore'):
        return (pair[0] + pair[1]) * np.float32(0.5)


def _boundary_widths(w):
    """sync_update_plain's median over final brackets of widths *w*: every
    walker done, the step's last round (tl 0, tr w; a -0 width from tr -0
    and tl +0)."""
    w = np.asarray(w, dtype=np.float32)
    P, d = len(w), 2
    st = popfused._SyncWalk(P, d, 2, 4, 'cpu').state
    st['done'].fill_(True)
    tr = torch.as_tensor(w)
    st['tr'].copy_(tr)
    st['tl'].zero_()
    neg_zero = (w == 0) & np.signbit(w)
    st['tr'][torch.as_tensor(neg_zero)] = -0.0
    dirbank = torch.full((2, P, d), 0.1)
    z = torch.zeros(P)
    kernels.sync_update_plain(z, None, z[:, None], z, z, torch.tensor(0.0),
                              dirbank, 4, st)
    assert int(st['s']) == 1
    return st['widths'][0]


MEDIAN_CASES = {
    'one walker': [0.3],
    'two walkers': [0.7, 0.1],
    'odd P, ties at the median': [0.5, 0.25, 0.5, 0.5, 1.0, 0.25, 0.5],
    'even P, a tie across the middle pair': [0.5, 0.5, 0.25, 1.0, 0.5, 0.75],
    'every width equal': [0.375] * 9,
    'NaN last, below the median': [np.nan, 0.2, 0.4, 0.3, np.nan, 0.1, 0.6],
    'NaN at the median': [np.nan, np.nan, 0.2, np.nan, 0.4],
    'NaN in the middle pair': [np.nan, 0.2, np.nan, 0.4],
    'every width NaN': [np.nan] * 4,
    'infinite widths': [np.inf, 0.5, np.inf, np.inf, 0.25],
    'zeros of one sign': [-0.0, -0.0, 0.5, -0.0, 0.25],
    'both zeros, a free tie': [-0.0, 0.0, 0.5, -0.0, 0.0, 0.25],
}


@pytest.mark.parametrize('case', sorted(MEDIAN_CASES))
def test_plain_median_at_its_free_cases(case):
    """The plain median equals K6's key selection bit for bit; where a -0
    and a +0 width meet at the median rank (torch.sort may order them
    either way) it equals it in value."""
    w = MEDIAN_CASES[case]
    got = _boundary_widths(w)
    want = torch.tensor(_key_median(w))
    if case.endswith('free tie'):
        assert float(got) == float(want)
    else:
        _assert_bits(got, want)
    if np.isnan(np.asarray(w, dtype=np.float32)).sum() > (len(w) - 1) // 2:
        assert math.isnan(float(got))


# --------------------------------------------------------------------------
# K7's fused form: its plain twin against the old step's separate torch
# operators, bit for bit


def _old_rwalk_step(Lev, tin, up, Lmin, u, L, nacc, nc, m, scale):
    """The old scan body after the likelihood, then the next step's
    proposal as the old loop built it (``u + scale * (eps @ axes_t)``,
    *scale* a Python float)."""
    inside = ((up > 0) & (up < 1)).all(dim=1)
    Lp = torch.where(inside, Lev, -math.inf)
    acc = inside & (Lp > Lmin)
    u = torch.where(acc[:, None], up, u)
    L = torch.where(acc, Lp, L)
    nacc = nacc + acc.sum()
    nc = nc + (inside if tin is None else inside & tin).sum()
    nxt = None if m is None else u + scale * m
    return u, L, nacc, nc, nxt


def _rwalk_step_inputs(P, d, seed):
    rng = np.random.RandomState(seed)
    f32 = np.float32
    up = rng.uniform(-0.1, 1.1, size=(P, d)).astype(f32)
    up[::3] = rng.uniform(0.2, 0.8, size=up[::3].shape)
    up[1::7] = 0.0
    up[2::11, -1] = 1.0
    up[3::13, 0] = np.nan
    Lev = rng.normal(size=P).astype(f32)
    Lev[::17] = np.nan
    Lev[1::19] = np.inf
    u = rng.uniform(0.05, 0.95, size=(P, d)).astype(f32)
    L = rng.normal(size=P).astype(f32)
    eps = rng.normal(size=(P, d)).astype(f32)
    axes = np.diag(rng.uniform(0.01, 0.2, size=d)).astype(f32)
    axes[0, -1] = f32(0.03)
    tin = rng.uniform(size=P) < 0.8
    return [torch.as_tensor(x) for x in (up, Lev, u, L, eps, axes, tin)]


@pytest.mark.parametrize('step', ['prologue', 'middle', 'last'])
@pytest.mark.parametrize('P,d,filtered,scale', [
    (64, 2, False, 0.5), (128, 8, True, 0.3), (63, 3, True, 4.0),
    (40, 33, False, 0.1)])
def test_rwalk_fused_step_equals_the_old_operators(step, P, d, filtered,
                                                   scale):
    """K7's plain twin: the prologue writes step 0's proposal, a middle
    step accepts and writes the next one, the last step accepts and
    writes none; rows outside the cube, on its faces and NaN, NaN and
    infinite likelihoods; the products are the ones the walk computes
    ahead (:func:`popfused._rwalk_products`)."""
    up, Lev, u, L, eps, axes, tin = _rwalk_step_inputs(P, d, P + d)
    tin = tin if filtered else None
    m = popfused._rwalk_products(eps[None], axes,
                                 torch.empty(1, P, d))[0]
    _assert_bits(m, eps @ axes.T)
    scale_t = torch.tensor(scale, dtype=torch.float32)
    Lmin = torch.tensor(-0.3)
    st = dict(u=u.clone(), L=L.clone(),
              nacc=torch.full((), 3, dtype=torch.int64),
              nc=torch.full((), 5, dtype=torch.int64))
    kernels.reset_counts()
    if step == 'prologue':
        mine = up.clone()
        before = {k: x.clone() for k, x in st.items()}
        kernels.rwalk_accept(None, None, mine, None, st, m, scale_t)
        _assert_bits(mine, u + float(np.float32(scale)) * (eps @ axes.T))
        for k in kernels.RWALK_STATE:
            _assert_bits(st[k], before[k])
        assert kernels.PLAIN_CALLS == collections.Counter(rwalk_accept=1)
        return
    want = _old_rwalk_step(Lev, tin, up, Lmin, u, L, st['nacc'], st['nc'],
                           None if step == 'last' else eps @ axes.T,
                           float(np.float32(scale)))
    mine = up.clone()
    kernels.rwalk_accept(Lev, tin, mine, Lmin, st,
                         None if step == 'last' else m, scale_t)
    for k, w in zip(kernels.RWALK_STATE, want):
        _assert_bits(st[k], w)
    _assert_bits(mine, up if step == 'last' else want[-1])
    assert kernels.PLAIN_CALLS == collections.Counter(rwalk_accept=1)
    # some walkers accepted, some proposals fell outside
    assert 3 < int(st['nacc']) < 3 + P


def test_rwalk_walk_proposes_once_a_dispatch(monkeypatch):
    """A walk runs K7's prologue (K7 with no likelihoods) once, first,
    and K7 once a step; a walk of no steps runs neither."""
    banks, live_u, live_L, axes, L = _rwalk_inputs(64, 3, 9, nsteps=5)
    Lmin = float(np.sort(L)[len(L) // 3])
    prologue = []
    accept = kernels.rwalk_accept

    def booked(Lev, *args):
        prologue.append(Lev is None)
        return accept(Lev, *args)
    monkeypatch.setattr(kernels, 'rwalk_accept', booked)
    kernels.reset_counts()
    popfused.rwalk_walk(banks, live_u, live_L, axes, Lmin, 0.4,
                        _evaluator(False))
    assert kernels.PLAIN_CALLS == collections.Counter(rwalk_accept=6)
    assert prologue == [True] + [False] * 5
    banks['eps'] = banks['eps'][:0]
    kernels.reset_counts()
    uf, Lf = popfused.rwalk_walk(banks, live_u, live_L, axes, Lmin, 0.4,
                                 _evaluator(False))[:2]
    assert sum(kernels.PLAIN_CALLS.values()) == 0
    _assert_bits(uf, live_u[banks['idx0']])
