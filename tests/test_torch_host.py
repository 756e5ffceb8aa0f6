"""The port's host tier against the JAX package and the recorded oracle.

``netiter``, ``ordertest`` and the native C kernels are carried over into
``ultranest_torch`` unchanged. These tests feed identical trees and RNG
streams through the port and check bit-identical integration results
against the recorded reference-oracle outputs of
``tests/data/reference_parity.npz`` (the pattern of
tests/test_reference_parity.py) and against ``ultranest_tpu`` itself.
"""
import numpy as np
import pytest

import ultranest_torch.netiter as port_netiter
import ultranest_tpu.netiter as jax_netiter
from parity_fixtures import expected
from test_reference_parity import build_tree, load_reference_netiter
from ultranest_torch import native as port_native


def _walk_multicounter(netiter_mod, root, nbootstraps, seed, mode):
    """Drive a MultiCounter over *root*; returns its trajectory."""
    roots = root.children
    explorer = netiter_mod.BreadthFirstIterator(roots)
    np.random.seed(seed)
    if mode == 'reference':
        counter = netiter_mod.MultiCounter(
            nroots=len(roots), nbootstraps=nbootstraps, random=False)
    else:
        counter = netiter_mod.MultiCounter(
            nroots=len(roots), nbootstraps=nbootstraps, random=False,
            check_insertion_order=True, rng=np.random)
    step = dict(reference='passing_node', py='_passing_node_py',
                native='_passing_node_native')[mode]
    logz_seq, vol_seq = [], []
    while True:
        nn = explorer.next_node()
        if nn is None:
            break
        rootid, node, (_, active_rootids, active_values, _) = nn
        getattr(counter, step)(rootid, node, active_rootids, active_values)
        logz_seq.append(counter.logZ)
        vol_seq.append(counter.logVolremaining)
        explorer.expand_children_of(rootid, node)
    return (np.array(logz_seq), np.array(vol_seq), counter.all_logZ.copy(),
            np.array(counter.logweights), counter.all_H.copy())


def test_multicounter_matches_reference_oracle():
    root, _ = build_tree(port_netiter, np.random.RandomState(11))
    mine = _walk_multicounter(port_netiter, root, 7, 99, 'py')

    def compute_ref():
        ref_netiter = load_reference_netiter()
        ref_root, _ = build_tree(ref_netiter, np.random.RandomState(11))
        return _walk_multicounter(ref_netiter, ref_root, 7, 99, 'reference')

    ref = expected('multicounter', compute_ref, n_outputs=5)
    for a, b, what in zip(ref, mine, ['logz', 'logvol', 'all_logZ',
                                      'logweights', 'all_H']):
        np.testing.assert_array_equal(a, b, err_msg=what)


def test_singlecounter_matches_reference_oracle():
    def walk(netiter_mod, root):
        explorer = netiter_mod.BreadthFirstIterator(root.children)
        counter = netiter_mod.SingleCounter()
        seq = []
        while True:
            nn = explorer.next_node()
            if nn is None:
                break
            rootid, node, (active_nodes, _, _, _) = nn
            counter.passing_node(node, active_nodes)
            seq.append((counter.logZ, counter.logVolremaining))
            explorer.expand_children_of(rootid, node)
        return np.array(seq)

    root, _ = build_tree(port_netiter, np.random.RandomState(13))
    mine = walk(port_netiter, root)

    def compute_ref():
        ref_netiter = load_reference_netiter()
        ref_root, _ = build_tree(ref_netiter, np.random.RandomState(13))
        return walk(ref_netiter, ref_root)

    np.testing.assert_array_equal(expected('singlecounter', compute_ref),
                                  mine)


def test_ordertest_matches_reference_oracle():
    from ultranest_torch.ordertest import UniformOrderAccumulator
    orders = np.random.RandomState(3).randint(101, size=5000)
    acc = UniformOrderAccumulator()
    mine = []
    for o in orders:
        acc.add(int(o), 100)
        mine.append(acc.zscore)

    def compute_ref():
        import importlib.util
        import os
        from parity_fixtures import REF
        spec = importlib.util.spec_from_file_location(
            'ref_ordertest', os.path.join(REF, 'ordertest.py'))
        ref_ot = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(ref_ot)
        acc_ref = ref_ot.UniformOrderAccumulator()
        seq = []
        for o in orders:
            acc_ref.add(int(o), 100)
            seq.append(acc_ref.zscore)
        return np.array(seq)

    ref = expected('ordertest_zscores', compute_ref)
    np.testing.assert_allclose(ref, np.array(mine), rtol=1e-12, atol=1e-12)


def test_native_builds_from_reference_sources():
    assert port_native.available()
    lib = port_native._load()
    assert 'ultranest_torch' in lib._name and lib._name.endswith('.so')
    assert port_native._SRC_DIR.endswith('ultranest_tpu/native')


@pytest.mark.parametrize('mode', ['py', 'native'])
def test_counter_bit_identical_to_jax_package(mode):
    """Same code, same tree, same stream: the JAX package's counter."""
    out = []
    for mod in (port_netiter, jax_netiter):
        root, _ = build_tree(mod, np.random.RandomState(21))
        out.append(_walk_multicounter(mod, root, 9, 5, mode))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('random', [False, True])
def test_logz_sequence_and_combine_identical_to_jax_package(random):
    results = []
    for mod in (port_netiter, jax_netiter):
        root, pp = build_tree(mod, np.random.RandomState(31))
        np.random.seed(7)
        seq, res = mod.logz_sequence(root, pp, nbootstraps=10,
                                     random=random)
        results.append((seq, res))
    (seq_p, res_p), (seq_j, res_j) = results
    assert sorted(res_p) == sorted(res_j)
    for k in ('logz', 'logzerr', 'logz_bs', 'logzerr_bs', 'H', 'Herr',
              'ess', 'logzerr_tail', 'niter'):
        assert res_p[k] == res_j[k] or (np.isnan(res_p[k])
                                        and np.isnan(res_j[k])), k
    for k in ('logz', 'logvol', 'logwt', 'insert_order', 'nlive'):
        np.testing.assert_array_equal(np.asarray(seq_p[k], float),
                                      np.asarray(seq_j[k], float), k)
    np.testing.assert_array_equal(res_p['weighted_samples']['weights'],
                                  res_j['weighted_samples']['weights'])


@pytest.mark.parametrize('name', ['gauss', 'corrgauss', 'eggbox'])
def test_problems_match_jax_forms(name):
    """Each problem's numpy and torch forms against the JAX package's."""
    import torch
    import ultranest_torch.models.problems as tprob
    import ultranest_tpu.models.problems as jprob
    port, ref = getattr(tprob, name)(), getattr(jprob, name)()
    assert port.param_names == ref.param_names and port.logz == ref.logz
    u = np.random.RandomState(2).uniform(size=(500, port.ndim))
    p = u if port.transform is None else port.transform(u)
    np.testing.assert_array_equal(p, u if ref.transform is None
                                  else ref.transform(u))
    np.testing.assert_array_equal(port.loglike(p), ref.loglike(p))
    u32 = u.astype(np.float32)
    p_t = torch.as_tensor(u32) if port.torch_transform is None \
        else port.torch_transform(torch.as_tensor(u32))
    p_j = u32 if ref.jax_transform is None else ref.jax_transform(u32)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=1e-6)
    # f32 on both sides, summed in different orders: a few ulp apart
    np.testing.assert_allclose(port.torch_loglike(p_t).numpy(),
                               np.asarray(ref.jax_loglike(p_j)),
                               rtol=2e-6, atol=1e-5)
