"""The spec walk's round as two kernels (K4 propose, K5 update), on the CPU.

* ``spec_propose_plain`` then ``spec_update_plain`` give the round body
  the walk had as one function of torch operators, bit for bit, round
  after round;
* the walk built from them against the JAX package's
  ``_build_spec(npad, d, walk_only=True)`` fed the same banks (the
  method of ``tests/test_torch_popfused.py``): D 1, 4 and 8, d 2, 8 and
  50, the p-space filter on and off, and thresholds that send some
  walkers to the round cap; ``done``, ``idx0`` and the billed and useful
  counts equal, ``uf`` and ``Lf`` within 1e-6 (XLA on the CPU contracts
  ``a + b * c`` into fused multiply-adds), ``width`` within rtol 1e-6;
* K5's plain version against a numpy model of one walker's update (an
  axis with ``v == 0``, walkers already done, the last step, no hit in
  the chain, signed-zero brackets), float outputs compared as int32;
* the graph loop of ``spec_walk`` with the CUDA graph replaced by a
  stand-in that runs the round body: its reads, rounds and replays at a
  round cap that ``SPEC_CHECK_EVERY`` does not divide, and its outputs
  bit-equal to the host loop's.

The likelihood is an L1 distance on the first two coordinates: at most
one addition, so no summation order or fused multiply-add changes its
values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ultranest_tpu.popfused as jpop
from ultranest_torch import convert, popfused
from ultranest_torch.ops import kernels
from ultranest_torch.ops.pairwise import pad_rows, round_up
from torch_port_helpers import StandInGraphs

P, NSTEPS = 64, 8
CENTER = (0.5, 0.45)


def _loglike_np(x):
    return -(np.abs(x[:, 0] - CENTER[0]) + np.abs(x[:, 1] - CENTER[1]))


def _loglike_jax(x):
    return -(jnp.abs(x[:, 0] - CENTER[0]) + jnp.abs(x[:, 1] - CENTER[1]))


def _loglike_torch(x):
    return -(torch.abs(x[:, 0] - CENTER[0]) + torch.abs(x[:, 1] - CENTER[1]))


def _bits(t):
    t = t.detach().cpu() if torch.is_tensor(t) else torch.as_tensor(t)
    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 \
        else t


def _assert_bits(a, b):
    assert torch.equal(_bits(a), _bits(b))


# --------------------------------------------------------------------------
# the round body as one function of torch operators, as the walk had it


def _cube_intersection(u, v):
    nz = v != 0
    a = torch.where(nz, (0.0 - u) / v, -np.inf)
    b = torch.where(nz, (1.0 - u) / v, np.inf)
    return torch.minimum(a, b).amax(dim=1), torch.maximum(a, b).amin(dim=1)


def _old_round(xibank, dirbank, nsteps, Lmin, evaluate, it, u, L, v, tl, tr,
               step, done, widths, nw, ncr, nur):
    P_, D = xibank.shape[1:]
    arD = torch.arange(D)
    arP = torch.arange(P_)
    xi = xibank[it]
    tlc, trc = tl, tr
    ts = []
    for j in range(D):
        t = tlc + xi[:, j] * (trc - tlc)
        ts.append(t)
        tlc = torch.where(t < 0, t, tlc)
        trc = torch.where(t >= 0, t, trc)
    ts = torch.stack(ts, dim=1)
    up = u[:, None, :] + ts[..., None] * v[:, None, :]
    Lp, tin = evaluate(up.reshape(P_ * D, -1))
    Lp = Lp.reshape(P_, D)
    active = ~done
    billed = active[:, None].expand(P_, D) if tin is None \
        else tin.reshape(P_, D) & active[:, None]
    ncr = ncr + billed.sum()
    hit = Lp > Lmin
    anyhit0 = hit.any(dim=1)
    anyhit = anyhit0 & active
    jstar = torch.where(hit, arD, D).amin(dim=1).clamp(max=D - 1)
    kneed = torch.where(anyhit0, jstar + 1, D)
    nur = nur + ((arD[None, :] < kneed[:, None]) & billed).sum()
    tstar = ts.gather(1, jstar[:, None])[:, 0]
    Lstar = Lp.gather(1, jstar[:, None])[:, 0]
    u = torch.where(anyhit[:, None], u + tstar[:, None] * v, u)
    L = torch.where(anyhit, Lstar, L)
    step = step + anyhit
    widths = widths + torch.where(anyhit, tr - tl, 0.0).sum()
    nw = nw + anyhit.sum()
    done = done | (anyhit & (step >= nsteps))
    rej = ~anyhit & ~done
    tl = torch.where(rej, tlc, tl)
    tr = torch.where(rej, trc, tr)
    renew = anyhit & ~done
    vn = dirbank[step.clamp(0, nsteps - 1), arP]
    v = torch.where(renew[:, None], vn, v)
    tln, trn = _cube_intersection(u, v)
    tl = torch.where(renew, tln, tl)
    tr = torch.where(renew, trn, tr)
    return u, L, v, tl, tr, step, done, widths, nw, ncr, nur


def _evaluator(treg, d):
    if treg is None:
        return lambda rows: (_loglike_torch(rows), None)

    def ev(rows):
        dd = rows - treg[:d]
        tin = ((dd @ treg[d:d + d * d].reshape(d, d)) * dd).sum(dim=1) \
            <= treg[-1]
        return torch.where(tin, _loglike_torch(rows), -np.inf), tin
    return ev


def _treg(d, on):
    """Packed p-space ellipsoid [ctr, invcov, enlarge], or the dummy."""
    if not on:
        return np.zeros(1, np.float32)
    return np.concatenate([np.full(d, 0.5), np.eye(d).ravel() / (0.04 * d),
                           [1.0]]).astype(np.float32)


def _state(d, seed, nlive=50):
    """Live points around CENTER (the free axes around 0.5), axes, the
    live likelihoods."""
    rng = np.random.RandomState(seed)
    c = np.full(d, 0.5)
    c[:2] = CENTER
    u = np.clip(c + 0.1 * rng.normal(size=(nlive, d)), 0.01, 0.99)
    L = _loglike_np(u).astype(np.float32)
    axes = np.diag(u.std(axis=0)).astype(np.float32)
    return u.astype(np.float32), L, axes


@pytest.mark.parametrize('D,d,treg_on', [(1, 2, False), (4, 8, True),
                                         (8, 50, False), (8, 8, True),
                                         (1, 50, True), (4, 2, False)])
def test_plain_kernels_equal_the_round_body(D, d, treg_on):
    u0, L0, axes = _state(d, D + d)
    nlive = len(u0)
    live_u = torch.as_tensor(pad_rows(u0, round_up(nlive)))
    live_L = torch.as_tensor(pad_rows(L0, round_up(nlive), fill=-np.inf))
    g = torch.Generator().manual_seed(D * 100 + d)
    rounds = 40
    banks = popfused.draw_spec_banks(g, P, D, NSTEPS, rounds, nlive, d)
    treg = torch.as_tensor(_treg(d, True)) if treg_on else None
    ev = _evaluator(treg, d)
    Lmin = float(np.sort(L0)[nlive // 3])
    walk = popfused._SpecWalk(P, D, d, NSTEPS, rounds, P, 'cpu')
    walk.load(banks, live_u, live_L, torch.as_tensor(axes), Lmin, 1.0, ev)
    walk.init()
    st, dirbank = walk.state, walk.dirbank
    old = (st['u'].clone(), st['L'].clone(), st['v'].clone(),
           st['tl'].clone(), st['tr'].clone(), st['step'].clone(),
           st['done'].clone(), torch.zeros(()),
           torch.zeros((), dtype=torch.int64),
           torch.zeros((), dtype=torch.int64),
           torch.zeros((), dtype=torch.int64))
    Lmin_t = torch.tensor(Lmin, dtype=torch.float32)
    for it in range(rounds):
        old = _old_round(banks['xibank'], dirbank, NSTEPS, Lmin, ev, it,
                         *old)
        ts, tlc, trc, up = kernels.spec_propose_plain(
            st['u'], st['v'], st['tl'], st['tr'], banks['xibank'], st['it'])
        Lp, tin = ev(up)
        kernels.spec_update_plain(Lp, tin, ts, tlc, trc, Lmin_t, dirbank, st)
        st['widths'].add_(st['wbuf'].sum())
        assert int(st['it']) == it + 1
        for k, o in zip(('u', 'L', 'v', 'tl', 'tr', 'step', 'done',
                         'widths', 'nw', 'ncr', 'nur'), old):
            _assert_bits(st[k], o)
    assert st['done'].any() and st['step'].sum() > 0


# --------------------------------------------------------------------------
# the walk against the JAX package


@jax.jit
def _split_banks(key, nlive, xshape, ishape):
    """The reference's draws for *key* (``popfused.py:539-558``)."""
    max_rounds, P_, D_, x_dim = xshape.shape
    nsteps = ishape.shape[0]
    kstart, kdir, kt = jax.random.split(key, 3)
    xibank = jax.random.uniform(kt, (max_rounds, P_, D_))
    kde1, kde2, kax, kchoice = jax.random.split(kdir, 4)
    i1 = jax.random.randint(kde1, (nsteps, P_), 0, nlive)
    i2 = jax.random.randint(kde2, (nsteps, P_), 0, nlive - 1)
    jx = jax.random.randint(kax, (nsteps, P_), 0, x_dim)
    pick = jax.random.uniform(kchoice, (nsteps, P_))
    idx0 = jax.random.randint(kstart, (P_,), 0, nlive)
    return xibank, i1, i2, jx, pick, idx0


WALK_CASES = [(D, d, (D + d) % 2 == 0, q) for D in (1, 4, 8)
              for d in (2, 8, 50) for q in (0.25, 0.75)]


@pytest.mark.parametrize('D,d,treg_on,q', WALK_CASES)
def test_walk_matches_reference(D, d, treg_on, q):
    """q: the threshold's quantile among the live likelihoods; at 0.75
    the walkers that start below it never finish and run to the cap."""
    u, L, axes = _state(d, 7 * D + d)
    nlive = len(u)
    npad = round_up(nlive)
    live_u = pad_rows(u, npad)
    live_L = pad_rows(L, npad, fill=-np.inf)
    Lmin = np.float32(np.sort(L)[int(q * nlive)])
    treg = _treg(d, treg_on)
    ref = jpop.FusedPopulationSliceSampler(
        popsize=P, nsteps=NSTEPS, jax_loglike=_loglike_jax, spec_depth=D,
        seed=0)
    port = popfused.FusedPopulationSliceSampler(
        popsize=P, nsteps=NSTEPS, torch_loglike=_loglike_torch,
        spec_depth=D, seed=0, device='cpu')
    if treg_on:
        ref._treg_key = (True, d)
        port._treg_key = (True, d)
    key = np.array([D, 13 * d + 1], np.uint32)
    walk = jax.jit(ref._build_spec(npad, d, walk_only=True))
    want = [np.asarray(a) for a in walk(
        key, live_u, live_L, np.int32(nlive), axes, Lmin, np.float32(1.0),
        treg)]
    max_rounds = popfused.spec_max_rounds(NSTEPS, port.max_it, D)
    xs = np.zeros((max_rounds, P, D, d), np.int8)
    banks = dict(zip(('xibank', 'i1', 'i2', 'jx', 'pick', 'idx0'),
                     (np.asarray(a) for a in _split_banks(
                         key, np.int32(nlive), xs,
                         np.zeros((NSTEPS,), np.int8)))))
    banks = convert.walk_banks('cpu', **banks)
    axes_t, _, treg_t = convert.walk_inputs(axes, axes, treg, 'cpu')
    kernels.reset_counts()
    got = [a.numpy() for a in port._walk(
        banks, torch.as_tensor(live_u), torch.as_tensor(live_L), nlive,
        axes_t, float(Lmin), 1.0, treg_t)]
    st = port.walk_log[-1]
    assert kernels.PLAIN_CALLS['spec_propose'] == st['rounds'] == \
        kernels.PLAIN_CALLS['spec_update']
    assert st['graph'] is False and st['replays'] == 0
    uf, Lf, done, idx0, nc, nu, width, _ = got
    np.testing.assert_array_equal(idx0, want[3])
    np.testing.assert_array_equal(done, want[2])
    assert nc == want[4] and nu == want[5], (nc, want[4], nu, want[5])
    np.testing.assert_allclose(uf, want[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(Lf, want[1], rtol=0, atol=1e-6)
    np.testing.assert_allclose(width, want[6], rtol=1e-6)
    assert done.any()
    if q > 0.5:
        assert not done.all() and st['rounds'] == max_rounds


# --------------------------------------------------------------------------
# K5's plain version against a numpy model of one walker


def _f(x):
    return np.float32(x)


def _model_update(Lp, tin, ts, tlc, trc, Lmin, dirbank, s):
    """One walker at a time, in numpy float32 scalars; returns the new
    state dict (counters included)."""
    nsteps, P_, d = dirbank.shape
    D = ts.shape[1]
    out = {k: np.array(v, copy=True) for k, v in s.items()}
    for p in range(P_):
        active = not s['done'][p]
        billed = [active and (tin is None or bool(tin[p * D + j]))
                  for j in range(D)]
        hits = [j for j in range(D) if Lp[p * D + j] > Lmin]
        jstar = hits[0] if hits else D - 1
        kneed = jstar + 1 if hits else D
        out['ncr'] += sum(billed)
        out['nur'] += sum(b for j, b in enumerate(billed) if j < kneed)
        anyhit = bool(hits) and active
        out['wbuf'][p] = s['tr'][p] - s['tl'][p] if anyhit else _f(0)
        if not anyhit:
            if active:
                out['tl'][p], out['tr'][p] = tlc[p], trc[p]
            continue
        out['nw'] += 1
        u = s['u'][p] + ts[p, jstar] * s['v'][p]
        out['u'][p] = u
        out['L'][p] = Lp[p * D + jstar]
        step = s['step'][p] + 1
        out['step'][p] = step
        if step >= nsteps:
            out['done'][p] = True
            continue
        v = dirbank[min(step, nsteps - 1), p]
        out['v'][p] = v
        lo, hi = _f(-np.inf), _f(np.inf)
        for k in range(d):
            if v[k] != 0:
                a = (_f(0) - u[k]) / v[k]
                b = (_f(1) - u[k]) / v[k]
                lo = max(lo, min(a, b))
                hi = min(hi, max(a, b))
        out['tl'][p], out['tr'][p] = lo, hi
    out['it'] += 1
    return out


def _edge_inputs():
    """Six walkers, D 3, d 3, nsteps 4: walker 0 accepts its second
    candidate and renews along a direction with a zero axis; 1 is done
    already; 2 takes its last step; 3 finds no hit and keeps its shrunk
    bracket; 4 accepts onto u = 0 on an axis (the chord ends in a
    signed zero: 0 / v with v < 0 gives -0.0); 5 accepts its first
    candidate with the filter refusing its second."""
    nsteps, D, d = 4, 3, 3
    f = np.float32
    s = dict(
        u=np.array([[.5, .5, .5], [.2, .3, .4], [.6, .6, .6], [.4, .5, .6],
                    [.5, .25, .5], [.3, .7, .2]], f),
        L=np.array([-1, -2, -3, -4, -5, -6], f),
        v=np.array([[.1, 0, .2], [.1, .1, .1], [.3, -.2, .1],
                    [.1, .2, .3], [.1, -.25, .2], [-.1, .2, .3]], f),
        tl=np.array([-2, -1, -.5, -1.5, -2, -1], f),
        tr=np.array([2, 1, .5, 1.5, 2, 1], f),
        step=np.array([1, 4, 3, 0, 2, 0], np.int64),
        done=np.array([0, 1, 0, 0, 0, 0], bool),
        wbuf=np.full(6, 9, f), ncr=np.int64(5), nur=np.int64(3),
        nw=np.int64(2), it=np.int64(7))
    ts = np.array([[-.5, .25, .1], [.3, -.2, .1], [.2, .1, -.1],
                   [.4, -.3, .2], [-.5, 1.0, .1], [.3, .2, .1]], f)
    tlc = np.array([-.5, -.2, -.1, -.3, -.5, -1], f)
    trc = np.array([.25, .3, .2, .2, 1.0, .3], f)
    Lp = np.array([-9, -.5, -.1, -.2, -.3, -.4, -.6, -9, -9, -9, -9, -9,
                   -9, -.2, -.1, -.3, -.1, -9], f)
    tin = np.ones(6 * D, bool)
    tin[16] = False
    dirbank = np.full((nsteps, 6, d), .15, f)
    dirbank[2, 0] = [0.0, -0.0, 0.3]       # walker 0's next: two zero axes
    dirbank[3, 4] = [0.1, -0.5, 0.2]       # walker 4's next: u1 = 0, v1 < 0
    return Lp, tin, ts, tlc, trc, f(-1.0), dirbank, s


@pytest.mark.parametrize('with_tin', [True, False])
def test_update_plain_matches_a_numpy_model_at_the_edges(with_tin):
    Lp, tin, ts, tlc, trc, Lmin, dirbank, s = _edge_inputs()
    tin = tin if with_tin else None
    want = _model_update(Lp, tin, ts, tlc, trc, Lmin, dirbank, s)
    st = {k: torch.as_tensor(np.array(v, copy=True)) for k, v in s.items()}
    kernels.reset_counts()
    kernels.spec_update(torch.as_tensor(Lp),
                        None if tin is None else torch.as_tensor(tin),
                        torch.as_tensor(ts), torch.as_tensor(tlc),
                        torch.as_tensor(trc), torch.tensor(Lmin),
                        torch.as_tensor(dirbank), st)
    assert kernels.PLAIN_CALLS['spec_update'] == 1
    for k in kernels.SPEC_STATE:
        _assert_bits(st[k], torch.as_tensor(want[k]))
    # the cases the inputs were built for
    assert st['done'].tolist() == [False, True, True, False, False, False]
    assert st['step'].tolist() == [2, 4, 4, 0, 3, 1]
    assert st['tr'][4].item() == 0.0 and np.signbit(st['tr'][4].item())
    assert st['tl'][3] == tlc[3] and st['tr'][3] == trc[3]
    assert np.isfinite(st['tl'][0].item()) and st['v'][0, 1] == 0
    assert st['wbuf'][1] == 0 and st['wbuf'][3] == 0
    assert int(st['it']) == 8
    assert int(st['ncr']) - 5 == (14 if with_tin else 15)


def test_update_plain_with_no_hit_anywhere():
    Lp, tin, ts, tlc, trc, _, dirbank, s = _edge_inputs()
    want = _model_update(Lp, tin, ts, tlc, trc, np.float32(0.0), dirbank, s)
    st = {k: torch.as_tensor(np.array(v, copy=True)) for k, v in s.items()}
    kernels.spec_update_plain(
        torch.as_tensor(Lp), torch.as_tensor(tin), torch.as_tensor(ts),
        torch.as_tensor(tlc), torch.as_tensor(trc), torch.tensor(0.0),
        torch.as_tensor(dirbank), st)
    for k in kernels.SPEC_STATE:
        _assert_bits(st[k], torch.as_tensor(want[k]))
    active = ~torch.as_tensor(s['done'])
    assert torch.equal(st['tl'][active], torch.as_tensor(tlc)[active])
    assert int(st['nw']) == 2 and (st['wbuf'] == 0).all()
    # every billed row was useful: no hit, so all D were needed
    assert int(st['nur']) - 3 == int(st['ncr']) - 5 == 14


def test_propose_plain_reads_the_counters_round():
    g = torch.Generator().manual_seed(3)
    u = torch.rand((5, 3), generator=g)
    v = torch.rand((5, 3), generator=g) - 0.5
    tl, tr = kernels.cube_intersection(u, v)
    xibank = torch.rand((4, 5, 2), generator=g)
    for r in range(4):
        ts, tlc, trc, up = kernels.spec_propose_plain(
            u, v, tl, tr, xibank, torch.tensor(r))
        t0 = tl + xibank[r, :, 0] * (tr - tl)
        _assert_bits(ts[:, 0], t0)
        _assert_bits(up.reshape(5, 2, 3)[:, 1],
                     u + ts[:, 1, None] * v)
        assert ((tlc <= 0) & (trc >= 0)).all()


# --------------------------------------------------------------------------
# the graph loop, with a stand-in for the CUDA graph


def _walk_inputs(d=2, D=4, max_rounds=8 * 5 + 3, seed=2):
    u, L, axes = _state(d, seed)
    nlive = len(u)
    g = torch.Generator().manual_seed(seed)
    banks = popfused.draw_spec_banks(g, P, D, NSTEPS, max_rounds, nlive, d)
    return (banks, torch.as_tensor(u), torch.as_tensor(L), nlive,
            torch.as_tensor(axes), L)


@pytest.mark.parametrize('finishing', [False, True])
def test_graph_loop_reads_and_rounds(finishing):
    banks, live_u, live_L, nlive, axes, L = _walk_inputs()
    R = banks['xibank'].shape[0]
    every = popfused.SPEC_CHECK_EVERY
    assert R % every
    Lmin = float(L.min()) if finishing else 1e30

    def ev(rows):
        return _loglike_torch(rows), None
    host, graph = {}, {}
    want = popfused.spec_walk(banks, live_u, live_L, nlive, axes, Lmin, 1.0,
                              ev, NSTEPS, stats=host)
    graphs = StandInGraphs('stand-in')
    kernels.reset_counts()
    got = popfused.spec_walk(banks, live_u, live_L, nlive, axes, Lmin, 1.0,
                             ev, NSTEPS, stats=graph, graphs=graphs)
    for a, b in zip(got, want):
        _assert_bits(a, b)
    assert graph['graph'] and graph['captures'] == len(graphs.captured)
    assert graphs.captured == [every, 1]
    # the replays add what each graph launches; the warm-up round ran
    # through the plain versions (CPU tensors)
    assert kernels.LAUNCHES['spec_propose'] == graph['rounds']
    assert kernels.PLAIN_CALLS['spec_propose'] == graph['rounds'] + 1
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
    # read one chunk behind, as on a card: one more chunk of rounds runs
    # past the flag, as exact no-ops, and one read fewer waits
    D, d = banks['xibank'].shape[2], live_u.shape[1]
    walk = popfused._SpecWalk(P, D, d, NSTEPS, R, P, 'cpu')
    walk.load(banks, live_u, live_L, axes, Lmin, 1.0, ev)
    walk.init()
    reads, rounds = popfused._drive_rounds(walk.run_rounds, R, every, 1)
    for k, w in zip(('u', 'L', 'done', 'ncr', 'nur'),
                    (0, 1, 2, 4, 5)):
        _assert_bits(walk.state[k], want[w])
    if finishing:
        assert rounds == host['rounds'] + every
        assert reads == rounds // every - 1
    else:
        assert rounds == R
        # the last read waits behind the rounds below the cap
        assert reads == -(-R // every) - 1
    # a second dispatch replays without capturing
    again = {}
    popfused.spec_walk(banks, live_u, live_L, nlive, axes, Lmin, 1.0, ev,
                       NSTEPS, stats=again, graphs=graphs)
    assert again['captures'] == 0 and again['graph']
    assert again['rounds'] == graph['rounds']


def test_graph_loop_exact_walk_reads_every_round():
    banks, live_u, live_L, nlive, axes, L = _walk_inputs(max_rounds=64)
    host, graph = {}, {}

    def ev(rows):
        return _loglike_torch(rows), None
    args = (banks, live_u, live_L, nlive, axes, float(L.min()), 1.0, ev,
            NSTEPS)
    want = popfused.spec_walk(*args, target_done=P // 2, stats=host)
    graphs = StandInGraphs('stand-in')
    got = popfused.spec_walk(*args, target_done=P // 2, stats=graph,
                             graphs=graphs)
    for a, b in zip(got, want):
        _assert_bits(a, b)
    assert graphs.captured == [1]
    assert graph['reads'] == graph['rounds'] == host['rounds'] == \
        graph['replays'] == host['reads']
    assert P // 2 <= int(got[2].sum()) < P


def test_graph_entries_are_kept_per_key():
    graphs = popfused.SpecGraphs('f')
    made = []
    for key in [1, 2, 1, 3, 4, 5, 1]:
        graphs.entry(key, lambda: made.append(1) or object())
    # 1 stayed the most recent use: made again only after 5 keys
    assert len(made) == 5 and list(graphs._entries) == [3, 4, 5, 1]
    t = torch.arange(3.0)
    buf = graphs.static('x', t)
    assert graphs.static('x', t + 1) is buf and torch.equal(buf, t + 1)


def test_sampler_walks_on_the_cpu_run_no_graph():
    port = popfused.FusedPopulationSliceSampler(
        popsize=P, nsteps=NSTEPS, torch_loglike=_loglike_torch,
        seed=1, device='cpu')
    u, L, axes = _state(2, 4)
    banks = port._draw_banks(len(u), 2)
    port._walk(banks, torch.as_tensor(u), torch.as_tensor(L), len(u),
               torch.as_tensor(axes), float(L.min()), 1.0, torch.zeros(1))
    st = port.walk_log[-1]
    assert st['graph'] is False and st['captures'] == 0
    assert getattr(port, '_graphs', None) is None
    with pytest.raises(ValueError, match='CUDA'):
        popfused.SpecGraphs('f').capture(
            popfused._SpecWalk(P, 1, 2, NSTEPS, 8, P, 'cpu'), [8],
            None, None)
