"""The native runs of an improvement pass's counting-only node visits
(``netiter.NodeSweep``, ``native/nodesweep.c``) against a replay of the
per-node loop (``integrator._explore_pass``) in Python, on seeded random
trees with leaves, nodes of two and three children and tied values, under
a width schedule of several steps, a least number of children of 2 or 3
on some nodes, budgets that run out, and, on some trees, a cap of a few
visits a call. Both sides walk the same tree in lockstep: each run of the
routine must stop at the visit where the replay, asking the integrator's
own ``_should_node_be_expanded``, stops, and leave the explorer, the
counters (the insertion-order test on and off) and the pass's records as
the replay leaves them, bit for bit. The visit at a stop is then taken by
both as the per-node loop takes it, and at some expansions a new node
joins the tree. The benchmark's reader of the share of visits the runs
consumed (``portbench/metrics/improve_sweep_pct.py``) reads it over a
window's fits, and nothing where no fit booked the runs.
"""

import math
import types

import numpy as np
import pytest

from ultranest_torch import netiter
from ultranest_torch.integrator import ReactiveNestedSampler, _width_plan
from torch_port_helpers import load_script

improve_sweep_pct = load_script('portbench/metrics/improve_sweep_pct.py',
                                'improve_sweep_pct_reader')

SEEDS = range(12)
STOPS = set(netiter.NodeSweep.STOPS)


def random_tree(rng):
    """Roots and a point pile of a tree of 50 to 400 nodes grown as a run
    grows it, with values on a grid of 0.1 (ties): the lowest live node
    dies with no child (one in ten), two or three children (one in five)
    or one; the live nodes left when the budget is spent are leaves."""
    budget = int(rng.integers(50, 401))
    pile = netiter.PointPile(2, 2)

    def node(value):
        u = rng.uniform(size=2)
        return pile.make_node(round(value, 1), u, u)
    roots = [node(float(v)) for v in rng.normal(size=int(rng.integers(3, 16)))]
    live, n = list(roots), len(roots)
    while live and n < budget:
        live.sort(key=lambda x: x.value)
        dead = live.pop(0)
        r = rng.uniform()
        nchildren = 0 if r < 0.1 else 2 if r < 0.25 else 3 if r < 0.3 else 1
        for _ in range(min(nchildren, budget - n)):
            child = node(dead.value + float(rng.exponential(0.3)))
            dead.children.append(child)
            live.append(child)
            n += 1
    return roots, pile


class _Logger:
    """Keeps the messages that the decision logs."""

    def __init__(self):
        self.messages = []

    def debug(self, msg, *args):
        self.messages.append(msg)


def _draw(rng, explorer, ntree):
    """The decision's inputs until the next stop: the strategy's interval
    a little above the frontier's lowest value (now and then inverted, now
    and then above the whole tree),
    the live points' health, the budgets, the clusters' width, whether
    plateaus are logged."""
    Lmin = float(explorer.active_node_values.min())
    Lhi = Lmin + (100.0 if rng.uniform() < 0.15
                  else float(rng.exponential(1.5)))
    Llo = Lhi + 0.5 if rng.uniform() < 0.1 else Lhi - float(rng.exponential(2))
    region = None if rng.uniform() < 0.5 else object()
    return dict(
        Llo=Llo, Lhi=Lhi, healthy=bool(rng.uniform() < 0.9),
        max_ncalls=[None, 5, 100][int(rng.integers(3))],
        max_iters=None if rng.uniform() < 0.7
        else int(rng.integers(1, ntree + 1)),
        log=bool(rng.uniform() < 0.5),
        sampler=types.SimpleNamespace(
            log=False, logger=_Logger(), ncall=10, region=region,
            cluster_num_live_points=int(rng.choice([0, 2, 5])),
            _n_multi_clusters=int(rng.integers(1, 4))))


def _replay(side, it, d, targets, maxv):
    """The per-node loop's run of counting-only visits from the
    explorer's next node, in Python: (visits, why it stopped)."""
    ex, mi = side['ex'], side['mi']
    me = d['sampler']
    me.log = d['log']
    m = 0
    while True:
        if not ex.active_nodes:
            return m, 'empty'
        if m >= maxv:
            return m, 'full'
        if m > 0 and it % 64 == 0 \
                and not any(n.children for n in ex.active_nodes):
            return m, 'segment'
        rootid, node, (_, rootids, values, _) = ex.next_node()
        Lmin = node.value
        if not (Lmin <= d['Lhi']) or not np.isfinite(d['Lhi']) \
                or (values == Lmin).all():
            return m, 'advice'
        logged = len(me.logger.messages)
        if ReactiveNestedSampler._should_node_be_expanded(
                me, it, d['Llo'], d['Lhi'], side['widths'], targets, node,
                values, d['max_ncalls'], d['max_iters'], d['healthy']):
            return m, 'expand'
        if any(msg.startswith('Plateau') for msg in
               me.logger.messages[logged:]):
            return m, 'plateau'
        _visit(side, rootid, node, rootids, values)
        it += 1
        m += 1


def _visit(side, rootid, node, rootids, values):
    """One visit of the per-node loop that only counts."""
    side['saved_logl'].append(node.value)
    side['saved_nodeids'].append(node.id)
    side['mi'].passing_node(rootid, node, rootids, values)
    side['ex'].expand_children_of(rootid, node)


def _assert_same(a, b):
    """The explorer, counters and records of both sides, bit for bit."""
    for key in ('active_node_values', 'active_root_ids', 'active_node_ids'):
        np.testing.assert_array_equal(getattr(a['ex'], key),
                                      getattr(b['ex'], key), err_msg=key)
    assert len(a['ex'].active_nodes) == len(b['ex'].active_nodes)
    assert all(x is y for x, y in zip(a['ex'].active_nodes,
                                      b['ex'].active_nodes))
    for key in ('all_logZ', 'all_H', 'all_logVolremaining', '_nlive',
                'logweights', 'istail', 'insertion_order_runs', 'logZ',
                'logZerr', 'logVolremaining', 'all_logZremain', 'logZremain',
                'logZremainMax', 'remainder_ratio', 'remainder_fraction'):
        np.testing.assert_array_equal(getattr(a['mi'], key),
                                      getattr(b['mi'], key), err_msg=key)
    acc_a = a['mi'].insertion_order_accumulator
    acc_b = b['mi'].insertion_order_accumulator
    assert (acc_a.U, acc_a.N) == (acc_b.U, acc_b.N)
    for key in ('widths', 'saved_logl', 'saved_nodeids'):
        assert a[key] == b[key], key


def _lockstep(seed):
    """Walk a random tree with the routine and with the replay side by
    side; returns the stops and the visits the routine consumed."""
    rng = np.random.default_rng(seed)
    roots, pile = random_tree(rng)
    ntree = netiter.count_tree(roots)[0]
    check_order = seed % 2 == 0
    maxv = 3 if seed % 4 == 1 else netiter.NodeSweep.MAXV
    # the width schedule of a pass: a floor and three requirements
    lo = float(min(n.value for n in roots))
    required = [(lo + float(rng.uniform(0, 3)), lo + float(rng.uniform(3, 8)),
                 int(rng.integers(2, 15))) for _ in range(3)]
    plan = _width_plan(required, int(rng.integers(2, 10)))
    ids = [n.id for n in netiter._flatten_nodes(roots)[0]]
    targets = {i: int(rng.choice([2, 3])) for i in ids
               if rng.uniform() < 0.2}
    sides = []
    for _ in range(2):
        sides.append(dict(
            ex=netiter.BreadthFirstIterator(roots),
            mi=netiter.MultiCounter(
                len(roots), nbootstraps=4, random=False,
                check_insertion_order=check_order,
                rng=np.random.RandomState(seed)),
            widths=list(plan), saved_logl=[], saved_nodeids=[]))
    py, nat = sides
    # the routine's table binds the counter's C buffers before a visit
    py['mi']._bind_native(py['ex'].active_root_ids)
    sweep = netiter.NodeSweep.make(nat['ex'], nat['mi'], targets,
                                   nat['widths'])
    sweep.MAXV = maxv
    it, stops, consumed = 0, [], 0
    while py['ex'].active_nodes:
        d = _draw(rng, py['ex'], ntree)
        me = d['sampler']
        m = sweep.run(
            it, d['Llo'], d['Lhi'],
            0 if me.region is None
            else me.cluster_num_live_points * me._n_multi_clusters,
            d['healthy'],
            d['max_ncalls'] is not None and me.ncall >= d['max_ncalls'],
            d['max_iters'], d['log'], nat['saved_logl'],
            nat['saved_nodeids'])
        want, why = _replay(py, it, d, targets, maxv)
        assert (m, sweep.stop) == (want, why)
        _assert_same(py, nat)
        stops.append(why)
        it += m
        consumed += m
        if not py['ex'].active_nodes:
            break
        # the per-node loop takes the visit at the stop; where it expands
        # a node, a new point joins the tree now and then
        visits = [s['ex'].next_node() for s in sides]
        rootid, node, _ = visits[0]
        assert visits[1][1] is node
        if why == 'expand' and rng.uniform() < 0.5:
            u = rng.uniform(size=2)
            node.children.append(pile.make_node(
                round(node.value + float(rng.exponential(0.3)), 1), u, u))
        for side, (_, _, (_, rootids, values, _)) in zip(sides, visits):
            _visit(side, rootid, node, rootids, values)
        it += 1
        _assert_same(py, nat)
    return stops, consumed


@pytest.mark.parametrize('seed', SEEDS)
def test_the_runs_stop_and_leave_the_pass_as_the_per_node_loop(seed):
    stops, consumed = _lockstep(seed)
    assert consumed > 0 and set(stops) <= STOPS


def test_the_trees_reach_every_stop():
    stops = set()
    for seed in SEEDS:
        stops.update(_lockstep(seed)[0])
    # a frontier of one node asks for advice (each live value equals the
    # minimum), so no run empties it
    assert stops == STOPS - {'empty'}


def test_no_native_library_no_sweep(monkeypatch):
    ex = netiter.BreadthFirstIterator(random_tree(
        np.random.default_rng(0))[0])
    mi = netiter.MultiCounter(len(ex.roots), nbootstraps=4, random=False)
    assert netiter.NodeSweep.make(ex, mi, {}, [(math.inf, 1.0)]) is not None
    # random counters draw their shrinkage, which the routine does not
    mi.random = True
    assert netiter.NodeSweep.make(ex, mi, {}, [(math.inf, 1.0)]) is None
    mi.random = False
    monkeypatch.setenv('ULTRANEST_TORCH_NO_NATIVE', '1')
    assert netiter.NodeSweep.make(ex, mi, {}, [(math.inf, 1.0)]) is None


def _fit(**phases):
    return dict(phases=phases)


@pytest.mark.parametrize('fits,share', [
    # two fits of passes and a one-pass fit: pooled over the window
    ([_fit(**{'improve/sweep#': 700, 'improve/count#': 200}),
      _fit(**{'improve/sweep#': 0, 'improve/count#': 100}),
      _fit(classic=0.5)], 70.0),
    # the runs took every visit, or none
    ([_fit(**{'improve/sweep#': 40})], 100.0),
    ([_fit(**{'improve/sweep': 1e-5, 'improve/sweep#': 0,
              'improve/count#': 9})], 0.0),
    # a program without the runs (the parent), a one-pass window, no fit
    ([_fit(**{'improve/count#': 100, 'improve/tree#': 100})], None),
    ([_fit(classic=0.5, launch=1.0)], None),
    ([], None),
])
def test_the_reader_reads_the_share_of_swept_visits(fits, share):
    run = types.SimpleNamespace(fits=fits, trace=None, config={},
                                workload={})
    assert improve_sweep_pct.read(run) == share
