"""The improvement passes of the port's reactive run, on the CPU.

The nested-sampling integral over a tree whose width varies, as the
port's counters compute it (``netiter``: the per-node counter in C and
in numpy, the whole-tree replay, ``combine_results``), against the plain
float64 reference ``portbench/reference/nested_integral.py``, written
from the published formulas and importing nothing of the port: on
seeded random trees, and over the tree of a small run that widens. A
counter planted with one live point too many fails the comparison. The
run that widens books the improvement passes' spans; a run of one pass
books none of them. The runs of counting-only visits consumed in C
(``netiter.NodeSweep``) leave the run that widens, and a spec-walk run
with ``SimpleRegion`` that makes improvement passes, bit for bit as the
per-node loop leaves them; without the native library no visit is
swept.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import ultranest_torch
import ultranest_torch.mlfriends as tml
import ultranest_torch.popfused as tpop
from ultranest_torch import netiter
from ultranest_torch.models import problems
from torch_port_helpers import load_script

nested_integral = load_script('portbench/reference/nested_integral.py',
                              'nested_integral_reference')

# both sides compute in float64 and differ only in the order of their
# sums: relative to max(1, |value|)
RTOL = 1e-9
# the keys that only a pass after the first books
NEW_KEYS = ('improve', 'improve/rebuild', 'improve/draw', 'plan/strategy',
            'plan/widen')
TOP = ('prepare', 'classic', 'launch', 'fetch', 'replay', 'rebuild',
       'results', 'plan', 'segment', 'gc')


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_tree(seed):
    """A tree of 20 to 200 nodes grown as a run grows it: the lowest live
    node dies and mostly gets one child above it, in stretches two (the
    tree widens) or none (it narrows); the live nodes left when the node
    budget is spent die without children. Returns (root, pile)."""
    rng = np.random.default_rng(seed)
    budget = int(rng.integers(20, 201))
    pile = netiter.PointPile(2, 2)
    root = netiter.TreeNode(-np.inf)

    def node(value):
        u = rng.uniform(size=2)
        return pile.make_node(value, u, u * 10)
    nroots = int(rng.integers(3, 12))
    live = [node(float(v)) for v in rng.normal(size=nroots)]
    root.children.extend(live)
    n = nroots
    p_wide = p_narrow = 0.0
    while live and n < budget:
        if rng.uniform() < 0.1:     # a new stretch of the run
            p_wide, p_narrow = rng.choice([0.0, 0.3, 0.6]), \
                rng.choice([0.0, 0.2])
        live.sort(key=lambda x: x.value)
        dead = live.pop(0)
        r = rng.uniform()
        nchildren = 2 if r < p_wide else 0 if r < p_wide + p_narrow \
            and live else 1
        for _ in range(min(nchildren, budget - n)):
            child = node(dead.value + float(rng.exponential(0.5)))
            dead.children.append(child)
            live.append(child)
            n += 1
    return root, pile


def tree_points(root):
    """(birth, logl) of every node below *root*: a node's birth is its
    parent's log-likelihood, minus infinity under the root."""
    birth, logl = [], []
    stack = [(-np.inf, n) for n in root.children]
    while stack:
        b, node = stack.pop()
        birth.append(b)
        logl.append(node.value)
        stack.extend((node.value, c) for c in node.children)
    return np.array(birth), np.array(logl)


def gap(got, want):
    """Widest |got - want| / max(1, |want|)."""
    got, want = np.asarray(got, float), np.asarray(want, float)
    return float(np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want)),
                        initial=0.0))


def compare(root, result, nlive=None):
    """Gaps of logZ, the normalised log weights and (where given) the
    live counts of a result of the port against the reference over the
    tree under *root*."""
    ref = nested_integral.integrate(*tree_points(root))
    ws = result['weighted_samples']
    logl = np.asarray(ws['logl'], float)
    np.testing.assert_array_equal(logl, ref['logl'])
    logw = np.asarray(ws['logw'], float) + logl - result['logz']
    out = dict(logz=gap(result['logz'], ref['logz']),
               logw=gap(logw, ref['logw']))
    if nlive is not None:
        np.testing.assert_array_equal(nlive, ref['nlive'])
    return out


def replay(root, pile, path):
    """(sequence, results) of the port over the finished tree: per node
    through the C counter or its numpy twin, or as one whole-tree
    replay."""
    if path == 'vectorized':
        return netiter.logz_sequence(root, pile, random=False)
    return netiter.logz_sequence(root, pile, random=False,
                                 onNode=lambda node, it: None)


@pytest.fixture(params=['per_node_native', 'per_node_numpy', 'vectorized'])
def path(request, monkeypatch):
    if request.param == 'per_node_numpy':
        monkeypatch.setattr(netiter._native, 'available', lambda: False)
    return request.param


@pytest.mark.parametrize('seed', range(6))
def test_counters_agree_with_the_reference_on_random_trees(seed, path):
    root, pile = random_tree(seed)
    sequence, result = replay(root, pile, path)
    gaps = compare(root, result, nlive=sequence['nlive'])
    assert gaps['logz'] <= RTOL and gaps['logw'] <= RTOL, gaps


def test_random_trees_widen_and_narrow():
    widths = []
    for seed in range(6):
        ref = nested_integral.integrate(*tree_points(random_tree(seed)[0]))
        assert 20 <= len(ref['logl']) <= 200
        widths.append((ref['children'].max(), np.diff(ref['nlive']).min()))
    # some tree forks (two children) and some narrows mid-run
    assert max(w[0] for w in widths) == 2
    assert min(w[1] for w in widths) < 0


def _count_one_more(monkeypatch):
    """Plant the fault: the counter counts one live point more than there
    is at every death."""
    monkeypatch.setattr(netiter._native, 'available', lambda: False)
    real = netiter.MultiCounter._passing_node_py

    def passing_node(self, rootid, node, rootids, parallel_values):
        if self._nlive is None:
            self._nlive = self.rootids[:, rootids].sum(axis=1)
        self._nlive = self._nlive + 1
        real(self, rootid, node, rootids, parallel_values)
        self._nlive = self._nlive - 1
    monkeypatch.setattr(netiter.MultiCounter, '_passing_node_py',
                        passing_node)


@pytest.mark.parametrize('seed', range(3))
def test_a_counter_with_one_live_point_too_many_fails(seed, monkeypatch):
    root, pile = random_tree(seed)
    _count_one_more(monkeypatch)
    _, result = replay(root, pile, 'per_node_numpy')
    gaps = compare(root, result)
    assert gaps['logz'] > 1e3 * RTOL, gaps


# two well-separated gaussian modes in the unit square
CENTRES = np.array([[0.25, 0.25], [0.75, 0.75]])
SIGMA = 0.04


def _loglike(u):
    d = ((u[:, None, :] - CENTRES[None]) / SIGMA) ** 2
    return np.logaddexp(-0.5 * d[:, 0].sum(1), -0.5 * d[:, 1].sum(1))


def _torch_loglike(u):
    c = torch.as_tensor(CENTRES, dtype=u.dtype, device=u.device)
    d = ((u[:, None, :] - c[None]) / SIGMA) ** 2
    return torch.logaddexp(-0.5 * d[:, 0].sum(1), -0.5 * d[:, 1].sum(1))


def _two_modes(seed=3, **run):
    sampler = ultranest_torch.ReactiveNestedSampler(
        ['a', 'b'], _loglike, vectorized=True, seed=seed, device='cpu',
        torch_loglike=_torch_loglike, ndraw_min=256, ndraw_max=4096)
    result = sampler.run(min_num_live_points=80, cluster_num_live_points=40,
                         viz_callback=False, show_status=False, **run)
    return sampler, result


@pytest.fixture(scope='module')
def widened():
    """A run at upstream's defaults (improvement passes on), under the
    profiler: (sampler, result, names of the profiler's ranges)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sampler, result = _two_modes()
    from torch._C._autograd import DeviceType
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation() and e.device_type() == DeviceType.CPU]
    return sampler, result, names


def test_a_run_that_widens_agrees_with_the_reference(widened):
    sampler, result, _ = widened
    ref = nested_integral.integrate(*tree_points(sampler.root))
    # the second pass widened the tree beyond the first pass's 80
    assert ref['nlive'].max() > 80 and ref['children'].max() >= 2
    gaps = compare(sampler.root, result)
    assert gaps['logz'] <= RTOL and gaps['logw'] <= RTOL, gaps
    assert abs(result['logz'] - np.log(4 * np.pi * SIGMA ** 2)) \
        < 4 * result['logzerr']


def test_a_run_that_widens_books_the_improvement_spans(widened):
    sampler, _, names = widened
    rec = sampler._segment_phase_s
    for key in NEW_KEYS:
        assert rec.get(key + '#', 0) >= 1, key
    for key, v in rec.items():
        if '/' in key and not key.endswith('#'):
            assert v <= rec[key.rsplit('/', 1)[0]] + 1e-9, key
    # the draws' waits are their own, not the first pass's
    assert rec.get('improve/draw/wait#', 0) == rec['improve/draw#']
    # 'improve' and its rebuilds are profiler ranges, the counters not
    for key in ('improve', 'improve/rebuild'):
        assert names.count(key) == rec[key + '#'], key
    for key in ('improve/draw', 'plan/strategy', 'plan/widen'):
        assert key not in names


def test_one_pass_books_none_of_the_improvement_spans():
    sampler, _ = _two_modes(max_num_improvement_loops=0)
    rec = sampler._segment_phase_s
    keys = {k.rstrip('#') for k in rec}
    assert not {k for k in keys for new in NEW_KEYS
                if k == new or k.startswith(new + '/')}
    assert {k for k in keys if '/' not in k} <= set(TOP)
    assert 'classic' in keys and 'plan' in keys


def _spec_walk(seed, **run):
    """The spec walk at d 8 with 128 walkers, ``SimpleRegion`` and 64 live
    points, at upstream's defaults: a segment pass, then improvement
    passes whose per-node visits ask the walk for their points."""
    prob = problems.asymgauss(ndim=8, sigma_min=0.01)
    sampler = ultranest_torch.ReactiveNestedSampler(
        prob.param_names, prob.loglike, vectorized=True, seed=seed,
        device='cpu')
    sampler.transform_layer_class = tml.ScalingLayer
    sampler.stepsampler = tpop.FusedPopulationSliceSampler(
        popsize=128, nsteps=16, spec_depth=8, engine='spec', seed=seed,
        torch_loglike=prob.torch_loglike, device='cpu')
    result = sampler.run(min_num_live_points=64,
                         region_class=tml.SimpleRegion, viz_callback=False,
                         show_status=False, **run)
    return sampler, result


FITS = dict(two_modes=_two_modes, spec_walk=_spec_walk)


def _passes(fit, seed, monkeypatch):
    """(sampler, result, each pass's records) of fit *fit*, numpy's
    global stream (the results' tree replay draws from it) seeded."""
    records = []
    real = ultranest_torch.ReactiveNestedSampler._update_results

    def update(self, mi, saved_logl, saved_nodeids):
        records.append(dict(
            saved_logl=list(saved_logl), saved_nodeids=list(saved_nodeids),
            logweights=mi.logweights.copy(), istail=list(mi.istail),
            insertion_order_runs=list(mi.insertion_order_runs),
            logZ=mi.logZ, logZerr=mi.logZerr))
        return real(self, mi, saved_logl, saved_nodeids)
    with monkeypatch.context() as mp:
        mp.setattr(ultranest_torch.ReactiveNestedSampler, '_update_results',
                   update)
        np.random.seed(seed)
        sampler, result = FITS[fit](seed)
    return sampler, result, records


@pytest.mark.parametrize('fit,seed', [('two_modes', 3), ('two_modes', 4),
                                      ('spec_walk', 1), ('spec_walk', 2)])
def test_the_native_runs_leave_each_fit_as_the_per_node_loop(fit, seed,
                                                             monkeypatch):
    swept, result, records = _passes(fit, seed, monkeypatch)
    # the routine consumes nothing: the per-node loop does every visit
    monkeypatch.setattr(netiter.NodeSweep, 'run', lambda self, *a: 0)
    per_node, want, want_records = _passes(fit, seed, monkeypatch)
    rec, ref = swept._segment_phase_s, per_node._segment_phase_s
    assert rec['improve/sweep#'] > 0
    assert ref.get('improve/sweep#', 0) == 0
    assert rec['improve/sweep#'] + rec['improve/count#'] \
        == ref['improve/count#']
    assert (swept.ncall, result['niter'], result['logz'],
            result['logzerr'], result['insertion_order_MWW_test']) == (
        per_node.ncall, want['niter'], want['logz'], want['logzerr'],
        want['insertion_order_MWW_test'])
    assert len(records) == len(want_records) >= 2
    for got, exp in zip(records, want_records):
        for key in exp:
            np.testing.assert_array_equal(got[key], exp[key], err_msg=key)


def test_without_the_native_library_no_visit_is_swept(monkeypatch):
    monkeypatch.setenv('ULTRANEST_TORCH_NO_NATIVE', '1')
    sampler, _ = _spec_walk(2)
    rec = sampler._segment_phase_s
    assert rec['improve/count#'] > 0
    assert not [k for k in rec if k.rstrip('#').endswith('/sweep')]
