"""The segment replay (``ReactiveNestedSampler._replay_rows`` and
``_insertion_test_batch``), on the CPU: a dispatch's accepted rows go into
the tree, the live mirror and the region as whole-batch array operations.
Each is held bit for bit to the per-row replay it replaced, restated here
as the oracle, and seeded segment-path fits to their pinned results."""

import copy
import hashlib
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import ultranest_torch
import ultranest_torch.mlfriends as tml
import ultranest_torch.popfused as tpop
from ultranest_torch.integrator import ReactiveNestedSampler
from ultranest_torch.models import problems
from ultranest_torch.netiter import PointPile, TreeNode
from ultranest_torch.ordertest import UniformOrderAccumulator
from ultranest_torch.tracing import Spans


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the oracles: the per-row replay and U-test scan it replaced -----------

def _zeroed(o, old_id):
    """One point moving from cluster *old_id* to unassigned."""
    counts = o.counts
    old_id = int(old_id)
    if old_id != 0:
        if counts[old_id] == 2:
            o.n_multi -= 1
        counts[old_id] -= 1
        if counts[0] == 1:
            o.n_multi += 1
        counts[0] += 1


def per_row_replay(o, st, w_a, L64_a, u_a, p_a):
    """The replay as one loop over the rows. *o* holds the pile, region,
    layer, ``region_nodes``, the node-id -> slots dict and the counts."""
    ex = st.explorer
    stop_at = len(w_a)
    vals = ex.active_node_values
    Lnew_a = L64_a.copy()
    distinct_w = np.unique(w_a).size == stop_at
    if distinct_w:
        Li_a = vals[w_a].copy()
        bad = ~(Lnew_a > Li_a)
        if bad.any():
            Lnew_a[bad] = np.nextafter(Li_a[bad], np.inf)
        vals[w_a] = Lnew_a
    else:
        Li_a = np.empty(stop_at)
        for j in range(stop_at):
            w = int(w_a[j])
            Li_a[j] = vals[w]
            if not Lnew_a[j] > Li_a[j]:
                Lnew_a[j] = np.nextafter(Li_a[j], np.inf)
            vals[w] = Lnew_a[j]
    nodes = ex.active_nodes
    base = o.pointpile.add_many(u_a, p_a)
    children = [TreeNode(value=float(Lnew_a[j]), id=base + j)
                for j in range(stop_at)]
    child_ids = np.arange(base, base + stop_at, dtype=np.int64)
    if distinct_w:
        st.saved_nodeids.extend(ex.active_node_ids[w_a].tolist())
    slot_rows, slot_urows = [], []
    region_slots = o.slots
    clusterids = o.transformLayer.clusterids
    for j, w in enumerate(w_a.tolist()):
        node = nodes[w]
        child = children[j]
        node.children.append(child)
        if not distinct_w:
            st.saved_nodeids.append(node.id)
        nodes[w] = child
        slot = region_slots.pop(node.id, None)
        if slot:
            region_slots.setdefault(child.id, []).extend(slot)
            o.region_nodes[slot] = child.id
            for s in slot:
                _zeroed(o, clusterids[s])
            clusterids[slot] = 0
            slot_rows.extend(slot)
            slot_urows.extend([j] * len(slot))
    ex.active_node_ids[w_a] = child_ids
    if slot_rows:
        o.region.u[slot_rows] = u_a[slot_urows]
        o.region.unormed = o.transformLayer.transform(o.region.u)
        o.region.ellipsoid_center = o.region.u.mean(axis=0)
    return Li_a, Lnew_a


def chunked_insertion_test(st, ranks, nlive, zst, win):
    """The U-test scan as cumulative sums between events."""
    acc = st.insertion_test
    norm = (np.asarray(ranks, float) + 0.5) / nlive
    i, k = 0, len(norm)
    while i < k:
        m = min(k - i, max(int(win) - acc.N + 1, 1))
        S = acc.U + np.cumsum(norm[i:i + m])
        n = acc.N + 1 + np.arange(m)
        z = (S - 0.5 * n) / np.sqrt(n / 12.0)
        trig = np.flatnonzero((np.abs(z) > zst) | (n > win))
        if trig.size == 0:
            acc.load(S[-1], n[-1])
            i += m
            continue
        j = int(trig[0])
        acc.load(S[j], n[j])
        if abs(acc.zscore) > zst:
            st.insertion_test_runs.append(acc.N)
            st.insertion_test_quality = acc.N
            st.insertion_test_direction = np.sign(acc.zscore)
            acc.reset()
        else:
            st.insertion_test_quality = np.inf
            st.insertion_test_direction = 0
            acc.reset()
        i += j + 1


# --- one batch replayed against the per-row replay --------------------------

NLIVE, D = 40, 3


class _Layer:
    def __init__(self, clusterids):
        self.clusterids = clusterids

    def transform(self, u):
        return (u - 0.25) * 3.0


def _state(rng, region_of_live):
    """(sampler, run state, oracle state, oracle's run state), equal at
    the start: *region_of_live* gives each region slot's live index, a
    negative one for a slot of a node no longer live."""
    vals = np.sort(rng.normal(size=NLIVE))
    ids = np.arange(100, 100 + NLIVE, dtype=np.int64)
    nodes = [TreeNode(value=float(v), id=int(i)) for v, i in zip(vals, ids)]
    ex = SimpleNamespace(
        active_nodes=nodes, active_node_ids=ids, active_node_values=vals,
        active_root_ids=np.zeros(NLIVE, dtype=np.int64))
    pile = PointPile(D, D)
    pile.add_many(rng.uniform(size=(100 + NLIVE, D)),
                  rng.uniform(size=(100 + NLIVE, D)))
    region_nodes = np.array([ids[w] if w >= 0 else 50 - w
                             for w in region_of_live], dtype=np.int64)
    nreg = len(region_nodes)
    layer = _Layer(rng.integers(0, 5, size=nreg))
    ru = rng.uniform(size=(nreg, D))
    region = SimpleNamespace(u=ru, unormed=layer.transform(ru),
                             ellipsoid_center=ru.mean(axis=0))
    s = object.__new__(ReactiveNestedSampler)
    s._segment_phase_s = Spans()
    s.pointpile, s.region, s.transformLayer = pile, region, layer
    s.region_nodes = region_nodes
    s._refresh_region_caches()
    st = SimpleNamespace(
        explorer=ex, saved_nodeids=[],
        insertion_test=UniformOrderAccumulator(), insertion_test_runs=[],
        insertion_test_quality=np.inf, insertion_test_direction=0)
    slots = {}
    for slot, nid in enumerate(region_nodes):
        slots.setdefault(int(nid), []).append(slot)
    o = SimpleNamespace(pointpile=pile, region=region, transformLayer=layer,
                        region_nodes=region_nodes, slots=slots,
                        counts=s._cluster_counts.copy(),
                        n_multi=s._n_multi_clusters)
    # the oracle's own copies of everything the replay changes
    o, st_o = copy.deepcopy((o, st))
    return s, st, o, st_o


def _rows(rng, case, vals, k):
    """(w_a, L64_a) of one batch of *k* rows, every new value above the
    one it consumes unless the case plants a clamp row."""
    if case.startswith('distinct'):
        w_a = rng.permutation(NLIVE)[:k]
    else:
        w_a = rng.integers(0, NLIVE, size=k)
    L64 = float(vals.max()) + np.cumsum(rng.uniform(0.01, 1.0, size=k))
    if case == 'distinct_clamp':
        L64[k // 2] = vals[w_a[k // 2]]           # equal: clamped
        L64[k // 3] = vals[w_a[k // 3]] - 0.5     # below: clamped
    if case == 'chained_clamp':
        # a row at or below its predecessor at the same index, and one
        # whose successor consumes the clamped value
        j = next(j for j in range(1, k) if w_a[j] in w_a[:j])
        p = max(i for i in range(j) if w_a[i] == w_a[j])
        L64[j] = L64[p]
        later = [i for i in range(j + 1, k) if w_a[i] == w_a[j]]
        if later:
            L64[later[0]] = L64[p]
    return w_a.astype(np.int64), L64


def _tree(node):
    return (node.value, node.id, [_tree(c) for c in node.children])


REGIONS = {
    'identity': lambda rng: np.arange(NLIVE),
    'permuted': lambda rng: rng.permutation(NLIVE),
    # a third of the live points hold no slot; four slots hold dead nodes
    'unslotted': lambda rng: np.concatenate(
        [rng.permutation(NLIVE)[:NLIVE * 2 // 3], [-1, -2, -3, -4]]),
}
CASES = [
    # (rows, the stop_at of each batch or None, region)
    ('distinct', None, 'identity'),
    ('chained', None, 'identity'),
    ('chained_clamp', None, 'identity'),
    ('distinct_clamp', None, 'identity'),
    ('chained_truncated', 'half', 'identity'),
    ('chained_permuted', None, 'permuted'),
    ('distinct_unslotted', None, 'unslotted'),
    ('chained_unslotted', None, 'unslotted'),
]


@pytest.mark.parametrize('case,cut,region', CASES,
                         ids=[c[0] for c in CASES])
def test_batch_replay_equals_per_row_replay(case, cut, region):
    rng = np.random.default_rng(CASES.index((case, cut, region)))
    s, st, o, st_o = _state(rng, REGIONS[region](rng))
    roots = list(st.explorer.active_nodes)
    roots_o = list(st_o.explorer.active_nodes)
    k = NLIVE // 2 if case.startswith('distinct') else 5 * NLIVE // 2
    zst, win = 2.0, 10
    for _ in range(3):
        w_a, L64 = _rows(rng, case, st.explorer.active_node_values, k)
        if cut:
            stop_at = k // 2
            w_a, L64 = w_a[:stop_at], L64[:stop_at]
        u = rng.uniform(size=(len(w_a), D))
        p = u * 2.0
        ranks = rng.integers(0, NLIVE + 1, size=len(w_a))
        Li, Lnew = s._replay_rows(st, w_a, L64, u, p)
        Li_o, Lnew_o = per_row_replay(o, st_o, w_a, L64, u, p)
        s._insertion_test_batch(st, ranks, NLIVE, zst, win)
        chunked_insertion_test(st_o, ranks, NLIVE, zst, win)
        assert Li.tobytes() == Li_o.tobytes()
        assert Lnew.tobytes() == Lnew_o.tobytes()
    ex, ex_o = st.explorer, st_o.explorer
    assert [_tree(n) for n in roots] == [_tree(n) for n in roots_o]
    assert [(n.value, n.id) for n in ex.active_nodes] \
        == [(n.value, n.id) for n in ex_o.active_nodes]
    assert ex.active_node_values.tobytes() \
        == ex_o.active_node_values.tobytes()
    assert (ex.active_node_ids == ex_o.active_node_ids).all()
    assert st.saved_nodeids == st_o.saved_nodeids
    assert (s.region_nodes == o.region_nodes).all()
    for name in ('u', 'unormed', 'ellipsoid_center'):
        assert getattr(s.region, name).tobytes() \
            == getattr(o.region, name).tobytes(), name
    assert (s.transformLayer.clusterids == o.transformLayer.clusterids).all()
    assert (s._cluster_counts == o.counts).all()
    assert s._n_multi_clusters == o.n_multi
    assert s.pointpile.us[:s.pointpile.nrows].tobytes() \
        == o.pointpile.us[:o.pointpile.nrows].tobytes()
    for name in ('insertion_test_runs', 'insertion_test_quality',
                 'insertion_test_direction'):
        assert getattr(st, name) == getattr(st_o, name), name
    assert (st.insertion_test.U, st.insertion_test.N) \
        == (st_o.insertion_test.U, st_o.insertion_test.N)
    # the branch each batch took
    rec = s._segment_phase_s
    chained = not case.startswith('distinct')
    assert rec.get('chained#', 0) == (3 if chained else 0)
    assert rec.get('serial#', 0) == (3 if case == 'chained_clamp' else 0)
    if case.endswith('clamp'):
        assert not (Lnew == L64).all()


# --- the U-test scan --------------------------------------------------------

def _ranks(rng, kind, n, nlive):
    if kind == 'uniform':
        return rng.integers(0, nlive + 1, size=n)
    if kind == 'biased':
        # low ranks: the z-score crosses the threshold
        return rng.integers(0, nlive // 3, size=n)
    # ranks that keep z near zero: only the window expires
    return np.where(np.arange(n) % 2, nlive // 4, 3 * nlive // 4)


@pytest.mark.parametrize('win', [10, 10000])
@pytest.mark.parametrize('zst', [2.0, 4.0])
@pytest.mark.parametrize('kind', ['uniform', 'biased', 'balanced'])
def test_insertion_scan_equals_chunked_scan_and_per_row_test(kind, zst, win):
    nlive = 100
    rng = np.random.default_rng(7 + int(zst) + win)
    n = 25000 if win > 100 else 3000
    ranks = _ranks(rng, kind, n, nlive)
    cuts = np.sort(rng.choice(np.arange(1, n), size=n // 300,
                              replace=False))
    s = object.__new__(ReactiveNestedSampler)

    def fresh():
        return SimpleNamespace(
            insertion_test=UniformOrderAccumulator(), insertion_test_runs=[],
            insertion_test_quality=np.inf, insertion_test_direction=0)

    st, st_o, st_r = fresh(), fresh(), fresh()
    for batch in np.split(ranks, cuts):
        s._insertion_test_batch(st, batch, nlive, zst, win)
        chunked_insertion_test(st_o, batch, nlive, zst, win)
        for name in ('insertion_test_runs', 'insertion_test_quality',
                     'insertion_test_direction'):
            assert getattr(st, name) == getattr(st_o, name), name
        assert (st.insertion_test.U, st.insertion_test.N) \
            == (st_o.insertion_test.U, st_o.insertion_test.N)
    # the per-row test: rank r is the count of live values below r - 0.5
    values = np.arange(nlive, dtype=float)
    for r in ranks.tolist():
        s._track_insertion_order(st_r, r - 0.5, nlive, values, zst, win)
    assert st.insertion_test_runs == st_r.insertion_test_runs
    assert st.insertion_test.N == st_r.insertion_test.N
    assert math.isclose(st.insertion_test.U, st_r.insertion_test.U,
                        rel_tol=1e-12, abs_tol=1e-9)
    events = len(st.insertion_test_runs)
    if kind == 'biased':
        assert events > 0
    if kind == 'balanced':
        assert events == 0 and np.isinf(st.insertion_test_quality)


# --- seeded segment-path fits, pinned to the per-row replay's results -------

RUN = dict(viz_callback=False, show_status=False,
           max_num_improvement_loops=0)


def _eggbox():
    prob = problems.eggbox()
    s = ultranest_torch.ReactiveNestedSampler(
        seed=3, device='cpu', **prob.sampler_kwargs(use_torch=True))
    s.fused_sampler.segment_enabled = True
    return s, dict(RUN, min_num_live_points=200, frac_remain=0.5,
                   max_ncalls=400000)


def _spec():
    # popsize 256 against 100 live points: every batch chains
    prob = problems.asymgauss(ndim=8, sigma_min=0.01)
    s = ultranest_torch.ReactiveNestedSampler(
        prob.param_names, prob.loglike, vectorized=True, seed=4,
        device='cpu')
    s.transform_layer_class = tml.ScalingLayer
    s.stepsampler = tpop.FusedPopulationSliceSampler(
        popsize=256, nsteps=10, spec_depth=8, engine='spec', seed=4,
        torch_loglike=prob.torch_loglike, device='cpu')
    return s, dict(RUN, min_num_live_points=100, frac_remain=0.1,
                   region_class=tml.SimpleRegion, cluster_num_live_points=0)


# ncall, niter, logZ (hex) and the first 16 hex digits of the SHA-256 of
# weighted_samples['logl'], as the per-row replay gave them
PINNED = {
    'eggbox': (27888, 1712, '0x1.d79a650d1b4d8p+7', 'f8a4a8dee535d7d4'),
    'spec': (355476, 2172, '0x1.6f898a8551f8dp-2', '4fa1a9d774dd551f'),
}


@pytest.mark.parametrize('fit', sorted(PINNED))
def test_seeded_segment_fit_is_bit_identical(fit):
    sampler, kw = dict(eggbox=_eggbox, spec=_spec)[fit]()
    res = sampler.run(**kw)
    logl = res['weighted_samples']['logl']
    got = (int(res['ncall']), int(res['niter']), float(res['logz']).hex(),
           hashlib.sha256(logl.tobytes()).hexdigest()[:16])
    assert got == PINNED[fit]
    rec = sampler._segment_phase_s
    assert rec.get('replay/serial#', 0) == 0
    if fit == 'spec':
        assert rec['replay/chained#'] == rec['fetch#'] > 0
