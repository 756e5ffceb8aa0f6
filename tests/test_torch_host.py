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
    # from the port's own copies of the reference's C sources
    # (tests/test_torch_kernels.py holds each copy equal to its original)
    assert port_native._SRC_DIR.endswith('ultranest_torch/native')


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


@pytest.mark.parametrize('cls,row', [('SingleCounter', 1.5),
                                     ('MultiCounter', [1.5, 2.5, 3.5])])
def test_counter_appends_after_empty_logweights(cls, row):
    """An empty logweights assignment, then appends, grow the buffer.

    The JAX package's counters keep their fault here (growing 2 * 0
    rows raises IndexError, ``netiter.py:519``); the port's grow to 16.
    """
    def make(mod):
        if cls == 'SingleCounter':
            return mod.SingleCounter()
        return mod.MultiCounter(nroots=3, nbootstraps=2, random=False)

    ref = make(jax_netiter)
    ref.logweights = []
    with pytest.raises(IndexError):
        ref._logw_append(np.asarray(row))
    c = make(port_netiter)
    c.logweights = []
    for i in range(40):
        c._logw_append(np.asarray(row) + i)
    w = np.asarray(c.logweights)
    assert len(w) == 40
    np.testing.assert_array_equal(w[-1], np.asarray(row) + 39)
    np.testing.assert_array_equal(w[0], row)


PROBLEMS = [('gauss', {}), ('corrgauss', {}), ('eggbox', {}),
            ('asymgauss', dict(ndim=8)), ('multigauss', dict(ndim=3)),
            ('rosenbrock', dict(ndim=8)), ('multishell', dict(ndim=8)),
            ('shell', dict(ndim=3)), ('loggamma', dict(ndim=30)),
            ('funnel', dict(ndim=4)), ('pyramid', dict(ndim=3)),
            ('sine', {}), ('slantedeggbox', dict(ndim=3)),
            ('corrpeak', {}), ('hyperrect', dict(ndim=3)),
            ('dirichlet', {})]


@pytest.mark.parametrize('name,kw', PROBLEMS,
                         ids=[name for name, _ in PROBLEMS])
def test_problems_match_jax_forms(name, kw):
    """Each problem's numpy and torch forms against the JAX package's.

    On the same seeded points: the numpy forms within 1e-10 in f64, the
    torch form within rtol 1e-5 of the jax form in f32. Only where the
    f32 sum cancels (sine's phases of ~2e4 radians, slantedeggbox's
    eggbox term against its slant near their sum's zero) does each
    point also get 4 times the jax form's own error against the f64
    form at that point.
    """
    import jax.numpy as jnp
    import torch
    import ultranest_torch.models.problems as tprob
    import ultranest_tpu.models.problems as jprob
    port, ref = getattr(tprob, name)(**kw), getattr(jprob, name)(**kw)
    assert port.param_names == ref.param_names and port.logz == ref.logz
    assert getattr(port, 'wrapped_params', None) == \
        getattr(ref, 'wrapped_params', None)
    u = np.random.RandomState(2).uniform(size=(500, port.ndim))
    p = u if port.transform is None else port.transform(u)
    np.testing.assert_allclose(p, u if ref.transform is None
                               else ref.transform(u), rtol=1e-10)
    np.testing.assert_allclose(port.loglike(p), ref.loglike(p), rtol=1e-10)
    u32 = u.astype(np.float32)
    p_t = torch.as_tensor(u32) if port.torch_transform is None \
        else port.torch_transform(torch.as_tensor(u32))
    p_j = jnp.asarray(u32) if ref.jax_transform is None \
        else ref.jax_transform(jnp.asarray(u32))
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=1e-6)
    got = port.torch_loglike(p_t).numpy()
    want = np.asarray(ref.jax_loglike(p_j))
    assert got.dtype == want.dtype == np.float32
    assert np.isfinite(got).all()
    if name in ('gauss', 'corrgauss', 'eggbox'):
        # f32 on both sides, summed in different orders: a few ulp apart
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-5)
    atol = 0.0
    if name in ('sine', 'slantedeggbox'):
        p64 = u32.astype(float) if ref.transform is None \
            else ref.transform(u32.astype(float))
        atol = 4 * np.abs(want - ref.loglike(p64))
    excess = np.abs(got - want) - 1e-5 * np.abs(want) - atol
    assert (excess <= 0).all(), (name, excess.max(), int(excess.argmax()))


# ------------------------------ where the libraries are built, and the switch

def _copy_of_native(tmp_path):
    """A copy of the port's ``native`` package (loader and C sources) in a
    directory that cannot hold a build: its mode is read-only, and a file
    stands where ``_build`` would go (mode bits do not stop a superuser)."""
    import importlib.util
    import os
    import shutil
    src = os.path.dirname(port_native.__file__)
    dst = tmp_path / 'site-packages' / 'native_copy'
    dst.mkdir(parents=True)
    for name in ('__init__.py',) + port_native.SOURCES:
        shutil.copy(os.path.join(src, name), dst / name)
    (dst / '_build').write_text('not a directory')
    os.chmod(dst, 0o555)
    spec = importlib.util.spec_from_file_location(
        'native_copy', str(dst / '__init__.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, dst


def test_read_only_install_builds_in_the_cache_dir(tmp_path, monkeypatch):
    import os
    monkeypatch.delenv('ULTRANEST_TORCH_NO_NATIVE', raising=False)
    monkeypatch.setenv('XDG_CACHE_HOME', str(tmp_path / 'cache'))
    mod, dst = _copy_of_native(tmp_path)
    try:
        assert mod.available()
        lib = mod._load()
        cache = str(tmp_path / 'cache' / 'ultranest_torch')
        assert lib._name.startswith(cache) and lib._name.endswith('.so')
        assert sorted(os.listdir(dst)) == sorted(
            ('__init__.py', '_build') + mod.SOURCES)
        # and the library works: the same sweep as the package's own
        values = np.array([0.1, 0.3, 0.5, 0.7])
        args = (values, np.arange(4), np.array([1, 0, 0, 0]),
                np.array([3, 0, 0, 0]), 3, 0.0)
        got, want = mod.tree_sweep(*args), port_native.tree_sweep(*args)
        assert got is not None
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        # without XDG_CACHE_HOME it is ~/.cache
        monkeypatch.delenv('XDG_CACHE_HOME')
        monkeypatch.setenv('HOME', str(tmp_path / 'home'))
        assert mod.build_dir(str(dst / '_build')) == str(
            tmp_path / 'home' / '.cache' / 'ultranest_torch')
    finally:
        os.chmod(dst, 0o755)


def test_build_dir_prefers_the_package_and_raises_without_any(tmp_path,
                                                              monkeypatch):
    from ultranest_torch.ops import kernels
    assert kernels.build_dir is port_native.build_dir
    ok = tmp_path / 'pkg' / '_build'
    assert port_native.build_dir(str(ok)) == str(ok) and ok.is_dir()
    blocker = tmp_path / 'file'
    blocker.write_text('x')
    monkeypatch.setenv('XDG_CACHE_HOME', str(blocker / 'cache'))
    with pytest.raises(OSError):
        port_native.build_dir(str(blocker / '_build'))
    # the CUDA library's build stays loud: no directory, no build
    monkeypatch.setattr(kernels, 'BUILD_DIR', str(blocker / '_build'))
    with pytest.raises(OSError):
        kernels.build()


def _small_run(seed=3):
    from ultranest_torch import ReactiveNestedSampler

    def loglike(theta):
        return -0.5 * (((theta - 0.5) / 0.1) ** 2).sum(axis=1)

    sampler = ReactiveNestedSampler(['a', 'b'], loglike, vectorized=True,
                                    seed=seed, device='cpu')
    return sampler.run(min_num_live_points=60, viz_callback=False,
                       show_status=False, max_num_improvement_loops=0,
                       min_ess=0, dlogz=2.0, frac_remain=0.1)


def test_no_native_switch_selects_the_numpy_path(monkeypatch):
    """``ULTRANEST_TORCH_NO_NATIVE=1``: no C library, the numpy twins of
    the host loops serve, and a seeded run gives the same answer (the
    same draws, so ncall and niter are equal; logZ to 1e-9, libm's and
    numpy's log and exp may round differently)."""
    monkeypatch.delenv('ULTRANEST_TORCH_NO_NATIVE', raising=False)
    assert port_native.available()
    with_c = _small_run()
    monkeypatch.setenv('ULTRANEST_TORCH_NO_NATIVE', '1')
    assert not port_native.available() and port_native._load() is None
    values = np.array([0.1, 0.3, 0.5])
    assert port_native.tree_sweep(values, np.arange(3), np.zeros(3, int),
                                  np.zeros(3, int), 3, 0.0) is None
    assert port_native.make_stepper(*[np.zeros(2)] * 6) is None
    without = _small_run()
    assert (with_c['ncall'], with_c['niter']) == (without['ncall'],
                                                  without['niter'])
    np.testing.assert_allclose(without['logz'], with_c['logz'], rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(without['logzerr'], with_c['logzerr'],
                               rtol=1e-9)
    np.testing.assert_array_equal(without['samples'].shape,
                                  with_c['samples'].shape)
    monkeypatch.delenv('ULTRANEST_TORCH_NO_NATIVE')
    assert port_native.available()
