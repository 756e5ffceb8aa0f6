"""The port's population spec walk against the JAX package, on the CPU.

* ``whitened_jump2``, ``whitened_cloud_var`` and ``pack_segment``
  against ``ultranest_tpu.segmentops``, within rtol 1e-6, except that
  the port's ``whitened_cloud_var`` measures wrapped axes from the
  circular mean on purpose (held to a float64 numpy version there);
* the spec walk (``popfused.spec_walk``) fed the random banks that the
  reference's own key splits give (``ultranest_tpu/popfused.py:539-558``),
  against the reference's walk with that key: ``done``, ``idx0`` and the
  billed and useful counts equal, ``uf``, ``Lf`` and ``width`` within
  1e-6;
* the segment kernel (walk + whitening + consume scan + pack) fed the
  inputs of the reference's ``run_segment`` (``popfused.py:1216-1232``).

The test likelihood (an L1 distance) has at most two additions and no
product feeding an addition, so no summation order or fused
multiply-add can change its values, and its unit slope keeps an ulp of
``u`` an ulp of ``L``. XLA on the CPU does contract the walk's own
``a + b * c`` into fused multiply-adds, so the float outputs may differ
in the last bits; the 1e-6 tolerance covers that and nothing more.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ultranest_tpu.popfused as jpop
import ultranest_tpu.segmentops as jseg
from ultranest_torch import convert, popfused, segmentops
from ultranest_torch.ops import kernels
from ultranest_torch.ops.pairwise import pad_rows, round_up
from ultranest_torch.parallel.launch import start_fetch

P, D, NSTEPS = 64, 8, 8
CENTER = (0.5, 0.45, 0.55)


def _loglike_np(x):
    d = x.shape[1]
    s = np.abs(x[:, 0] - CENTER[0]) + np.abs(x[:, 1] - CENTER[1])
    if d == 3:
        s = s + np.abs(x[:, 2] - CENTER[2])
    return -s


def _loglike_jax(x):
    d = x.shape[1]
    s = jnp.abs(x[:, 0] - CENTER[0]) + jnp.abs(x[:, 1] - CENTER[1])
    if d == 3:
        s = s + jnp.abs(x[:, 2] - CENTER[2])
    return -s


def _loglike_torch(x):
    d = x.shape[1]
    s = torch.abs(x[:, 0] - CENTER[0]) + torch.abs(x[:, 1] - CENTER[1])
    if d == 3:
        s = s + torch.abs(x[:, 2] - CENTER[2])
    return -s


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


def _banks_for(key, nlive, d, max_rounds):
    """The reference's draws for *key* under the port's bank names."""
    # shapes ride in as dummy arrays so jit sees them as static
    xs = np.zeros((max_rounds, P, D, d), np.int8)
    return dict(zip(('xibank', 'i1', 'i2', 'jx', 'pick', 'idx0'),
                    (np.asarray(a) for a in _split_banks(
                        key, np.int32(nlive), xs,
                        np.zeros((NSTEPS,), np.int8)))))


def _state(d, seed, nlive=50):
    """Live points, axes, whitening pack and the threshold of a small case."""
    rng = np.random.RandomState(seed)
    u = np.clip(np.asarray(CENTER[:d]) + 0.12 * rng.normal(size=(nlive, d)),
                0.01, 0.99)
    L = _loglike_np(u).astype(np.float32)
    std = u.std(axis=0)
    axes = np.diag(std).astype(np.float32)
    tpack = np.vstack([np.diag(1.0 / std), np.zeros((1, d))]).astype(
        np.float32)
    return u.astype(np.float32), L, axes, tpack


def _treg(d, on):
    """Packed p-space ellipsoid [ctr, invcov, enlarge], or the dummy."""
    if not on:
        return np.zeros(1, np.float32)
    return np.concatenate([np.full(d, 0.5), np.eye(d).ravel() / 0.25 ** 2,
                           [1.0]]).astype(np.float32)


def _samplers(d, treg_on):
    ref = jpop.FusedPopulationSliceSampler(
        popsize=P, nsteps=NSTEPS, jax_loglike=_loglike_jax, spec_depth=D,
        seed=0)
    port = popfused.FusedPopulationSliceSampler(
        popsize=P, nsteps=NSTEPS, torch_loglike=_loglike_torch,
        spec_depth=D, seed=0, device='cpu')
    if treg_on:
        ref._treg_key = (True, d)
        port._treg_key = (True, d)
    return ref, port


CASES = [(2, 0, False), (2, 1, True), (3, 2, False), (3, 3, True)]


@pytest.mark.parametrize('d,seed,treg_on', CASES)
def test_spec_walk_matches_reference_banks(d, seed, treg_on):
    u, L, axes, _ = _state(d, seed)
    nlive = len(u)
    npad = round_up(nlive)
    live_u = pad_rows(u, npad)
    live_L = pad_rows(L, npad, fill=-np.inf)
    Lmin = np.float32(np.sort(L)[nlive // 4])
    treg = _treg(d, treg_on)
    ref, port = _samplers(d, treg_on)
    key = np.array([7 + seed, 11 * seed + 3], np.uint32)
    walk = jax.jit(ref._build_spec(npad, d, walk_only=True))
    want = [np.asarray(a) for a in walk(
        key, live_u, live_L, np.int32(nlive), axes, Lmin, np.float32(1.0),
        treg)]

    max_rounds = popfused.spec_max_rounds(NSTEPS, port.max_it, D)
    banks = convert.walk_banks('cpu', **_banks_for(key, nlive, d,
                                                   max_rounds))
    axes_t, _, treg_t = convert.walk_inputs(axes, axes, treg, 'cpu')
    got = [a.numpy() for a in port._walk(
        banks, torch.as_tensor(live_u), torch.as_tensor(live_L), nlive,
        axes_t, float(Lmin), 1.0, treg_t)]
    uf, Lf, done, idx0, nc, nu, width, eff = got
    assert nc.dtype == nu.dtype == np.int64
    assert eff == done.mean()
    np.testing.assert_array_equal(idx0, want[3])
    np.testing.assert_array_equal(done, want[2])
    assert nc == want[4] and nu == want[5], (nc, want[4], nu, want[5])
    np.testing.assert_allclose(uf, want[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(Lf, want[1], rtol=0, atol=1e-6)
    # the mean chord length (~1-10 in line units): relative
    np.testing.assert_allclose(width, want[6], rtol=1e-6)
    assert done.any() and nu <= nc
    if treg_on:
        assert nc < P * D * port.walk_log[-1]['rounds']


@pytest.mark.parametrize('d,seed,treg_on', CASES)
def test_segment_kernel_matches_reference(d, seed, treg_on):
    u, L, axes, tpack = _state(d, seed + 10)
    nlive = len(u)
    npad = round_up(nlive)
    live_u = pad_rows(u, npad)
    live_L = pad_rows(L, npad, fill=np.inf)
    treg = _treg(d, treg_on)
    ref, port = _samplers(d, treg_on)
    key = np.array([3 + seed, 5 * seed + 1], np.uint32)
    run_segment = ref._build_spec(npad, d, segment=True)
    want = [np.asarray(a) for a in run_segment(
        key, live_u, live_L, np.int32(nlive), axes, np.float32(1.0), treg,
        tpack)]

    max_rounds = popfused.spec_max_rounds(NSTEPS, port.max_it, D)
    banks = convert.walk_banks('cpu', **_banks_for(key, nlive, d,
                                                   max_rounds))
    axes_t, tpack_t, treg_t = convert.walk_inputs(axes, tpack, treg, 'cpu')
    kernels.reset_counts()
    got = [a.numpy() for a in port._run_segment(
        banks, torch.as_tensor(live_u), torch.as_tensor(live_L), nlive,
        axes_t, 1.0, treg_t, tpack_t)]
    assert kernels.PLAIN_CALLS['consume_scan'] == 1
    lu2, lL2, packed, counts = got
    assert counts.dtype == np.int64
    assert list(counts) == list(want[2][-1, [0, 3]])
    np.testing.assert_allclose(lu2, want[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(lL2, want[1], rtol=0, atol=1e-6)
    rows, scal = packed[:-1], packed[-1]
    wrows, wscal = want[2][:-1], want[2][-1]
    assert packed.shape == want[2].shape == (P + 1, d + 7)
    np.testing.assert_allclose(rows[:, :d], wrows[:, :d], rtol=0, atol=1e-6)
    # [L, accept, worst, Lmin, rank, flags, jump2]
    np.testing.assert_allclose(rows[:, d], wrows[:, d], rtol=0, atol=1e-6)
    for c in (1, 2, 4, 5):
        np.testing.assert_array_equal(rows[:, d + c], wrows[:, d + c])
    np.testing.assert_allclose(rows[:, d + 3], wrows[:, d + 3], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(rows[:, d + 6], wrows[:, d + 6], rtol=1e-5,
                               atol=1e-9)
    # [nc, done_frac, width, nuseful, ref2, 0...]
    assert scal[0] == wscal[0] and scal[3] == wscal[3]
    assert scal[1] == wscal[1]
    np.testing.assert_allclose(scal[2], wscal[2], rtol=1e-6)
    np.testing.assert_allclose(scal[4], wscal[4], rtol=1e-6)
    np.testing.assert_array_equal(scal[5:], 0.0)
    assert rows[:, d + 1].sum() > 0


def _cloud_var_wrapped(live_u, nlive, tpack):
    """The port's whitened cloud variance in float64 numpy: wrapped axes
    as minimal-image offsets from the valid rows' circular mean."""
    u = live_u[:nlive].astype(np.float64)
    wrap = tpack[-1] > 0.5
    ang = 2 * np.pi * u
    c = np.arctan2(np.sin(ang).mean(axis=0), np.cos(ang).mean(axis=0)) \
        / (2 * np.pi)
    delta = u - c
    delta -= np.round(delta)
    w = np.where(wrap, delta, u) @ tpack[:-1].astype(np.float64)
    return float(((w - w.mean(axis=0)) ** 2).sum() / nlive)


@pytest.mark.parametrize('seed,wrapped', [(0, False), (1, True), (2, True)])
def test_whitening_and_pack_match_reference(seed, wrapped):
    rng = np.random.RandomState(seed)
    npad, nlive, d = 64, 45, 4
    live_u = rng.uniform(size=(npad, d)).astype(np.float32)
    live_u[nlive:] = 7.7                      # padding must not count
    uf = rng.uniform(size=(npad, d)).astype(np.float32)
    T = (rng.normal(size=(d, d)) + 3 * np.eye(d)).astype(np.float32)
    wmask = np.zeros((1, d), np.float32)
    if wrapped:
        wmask[0, [0, 2]] = 1.0
    tpack = np.vstack([T, wmask]).astype(np.float32)
    tt = [torch.as_tensor(a) for a in (live_u, uf, tpack)]
    np.testing.assert_allclose(
        segmentops.whitened_jump2(tt[0], tt[1], tt[2]).numpy(),
        np.asarray(jseg.whitened_jump2(live_u, uf, tpack)), rtol=1e-6)
    got = float(segmentops.whitened_cloud_var(tt[0], nlive, tt[2]))
    if wrapped:
        # the port measures wrapped axes from the circular mean on purpose
        np.testing.assert_allclose(
            got, _cloud_var_wrapped(live_u, nlive, tpack), rtol=1e-6)
    else:
        np.testing.assert_allclose(
            got, float(jseg.whitened_cloud_var(live_u, nlive, tpack)),
            rtol=1e-6)

    recs = rng.uniform(size=(npad, 6)).astype(np.float32)
    rows_L = rng.normal(size=npad).astype(np.float32)
    scal = [np.float32(x) for x in (1234.0, 0.75, 0.0625, 999.0, 2.5)]
    for kw in (dict(nuseful=scal[3], ref2=scal[4]), dict()):
        want = np.asarray(jseg.pack_segment(uf, rows_L, recs, *scal[:3],
                                            **kw))
        got = segmentops.pack_segment(
            tt[1], torch.as_tensor(rows_L), torch.as_tensor(recs),
            *map(torch.tensor, scal[:3]),
            **{k: torch.tensor(v) for k, v in kw.items()}).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_cloud_var_is_shift_invariant_on_wrapped_axes():
    """A cloud straddling the seam of a wrapped axis has the variance of
    the same cloud rotated by half a period; the reference's differs."""
    rng = np.random.RandomState(4)
    npad, nlive, d = 64, 50, 3
    live_u = rng.uniform(0.3, 0.7, size=(npad, d)).astype(np.float32)
    live_u[:nlive, 1] = np.mod(0.5 + 0.08 * rng.normal(size=nlive), 1.0)
    live_u[nlive:] = 7.7                      # padding must not count
    seam = live_u.copy()                      # axis 1 now straddles u = 0
    seam[:nlive, 1] = np.mod(live_u[:nlive, 1] + 0.5, 1.0).astype(np.float32)
    assert (seam[:nlive, 1] < 0.1).any() and (seam[:nlive, 1] > 0.9).any()
    T = (rng.normal(size=(d, d)) + 3 * np.eye(d)).astype(np.float32)
    tpack = np.vstack([T, [[0.0, 1.0, 0.0]]]).astype(np.float32)
    got = [float(segmentops.whitened_cloud_var(
        torch.as_tensor(x), nlive, torch.as_tensor(tpack)))
        for x in (live_u, seam)]
    np.testing.assert_allclose(got[1], got[0], rtol=1e-5)
    ref = [float(jseg.whitened_cloud_var(x, nlive, tpack))
           for x in (live_u, seam)]
    np.testing.assert_allclose(ref[0], got[0], rtol=1e-5)
    assert ref[1] > 5 * ref[0]


def test_walk_stops_at_the_round_cap_and_reads_every_k_rounds():
    """A walker that can never move stops the walk at max_rounds only."""
    d, nlive = 2, 50
    u, L, axes, _ = _state(d, 5)
    port = popfused.FusedPopulationSliceSampler(
        popsize=P, nsteps=NSTEPS, torch_loglike=_loglike_torch,
        spec_depth=D, seed=1, device='cpu')
    banks = port._draw_banks(nlive, d)
    max_rounds = banks['xibank'].shape[0]
    live_u, live_L = torch.as_tensor(u), torch.as_tensor(L)
    # a threshold above every reachable value: no walker finishes
    out = port._walk(banks, live_u, live_L, nlive, torch.as_tensor(axes),
                     1e30, 1.0, torch.zeros(1))
    assert not out[2].any()
    assert port.walk_log[-1]['rounds'] == max_rounds
    assert port.walk_log[-1]['reads'] == \
        -(-max_rounds // popfused.SPEC_CHECK_EVERY)
    assert float(out[4]) == P * D * max_rounds == float(out[5])
    # a finishing walk reads the flag once per SPEC_CHECK_EVERY rounds
    out = port._walk(banks, live_u, live_L, nlive, torch.as_tensor(axes),
                     float(L.min()), 1.0, torch.zeros(1))
    st = port.walk_log[-1]
    assert out[2].all()
    assert st['reads'] == st['rounds'] // popfused.SPEC_CHECK_EVERY
    assert st['rounds'] < max_rounds


def test_unported_options_raise():
    """A mesh that is not a DeviceMesh, an axis name without a mesh and an
    unknown engine are refused; every engine and option builds."""
    with pytest.raises(TypeError, match='DeviceMesh'):
        popfused.FusedPopulationSliceSampler(
            popsize=8, nsteps=2, torch_loglike=_loglike_torch,
            device='cpu', mesh=object())
    with pytest.raises(TypeError, match='DeviceMesh'):
        popfused.FusedPopulationRandomWalkSampler(
            popsize=8, nsteps=2, torch_loglike=_loglike_torch, device='cpu',
            mesh=object())
    with pytest.raises(ValueError, match='needs a mesh'):
        popfused.FusedPopulationSliceSampler(
            popsize=8, nsteps=2, torch_loglike=_loglike_torch,
            device='cpu', axis_name='ranks')
    with pytest.raises(ValueError):
        popfused.FusedPopulationSliceSampler(
            popsize=8, nsteps=2, torch_loglike=_loglike_torch,
            device='cpu', engine='rwalk')
    for kw in (dict(engine='async'), dict(engine='sync'),
               dict(spec_depth_auto=True)):
        popfused.FusedPopulationSliceSampler(
            popsize=8, nsteps=2, torch_loglike=_loglike_torch,
            device='cpu', **kw)
    popfused.FusedPopulationRandomWalkSampler(
        popsize=8, nsteps=2, torch_loglike=_loglike_torch, device='cpu')


def _forged_counts(nc, nu):
    """An int64 (billed, useful) pair as a finished dispatch hands it."""
    return start_fetch(torch.tensor([nc, nu], dtype=torch.int64))


def test_counts_past_f32_exact_range_come_home_exact():
    """A dispatch billing more than 2**24 evaluations keeps its count.

    Float32 rounds 2**24 + 1 to 2**24; the counts travel as int64 beside
    the float32 pack, through ``segment_fetch`` and the classic
    ``_harvest`` alike.
    """
    from ultranest_torch.mlfriends import ScalingLayer, SimpleRegion
    big, useful = 2 ** 24 + 1, 2 ** 24 + 3
    assert float(np.float32(big)) != big
    d, nlive = 2, 50
    u, L, axes, tpack = _state(d, 7)
    port = popfused.FusedPopulationSliceSampler(
        popsize=P, nsteps=NSTEPS, torch_loglike=_loglike_torch,
        spec_depth=D, seed=1, device='cpu')
    port.segment_start(u, L)
    layer = ScalingLayer()
    layer.optimize(u.astype(float), u.astype(float))
    region = SimpleRegion(u.astype(float), layer, device='cpu')
    port.segment_launch(region)
    handle, _, at_nsteps, reg = port._seg_queue.pop()
    port._seg_queue.append((handle, _forged_counts(big, useful), at_nsteps,
                            reg))
    rec = port.segment_fetch()
    assert (rec['nc'], rec['nc_useful']) == (big, useful)
    assert (port.ncalls, port.ncalls_useful) == (big, useful)

    port._pending = port._launch(region, float(np.sort(L)[5]),
                                 u.astype(float), L.astype(float))
    handle, _, us, at_nsteps = port._pending
    port._pending = (handle, _forged_counts(big, useful), us, at_nsteps)
    assert port._harvest(region, lambda x: x, _loglike_np,
                         float(np.sort(L)[5])) == big
    assert (port.ncalls, port.ncalls_useful) == (2 * big, 2 * useful)


def test_banks_have_the_reference_layout():
    g = torch.Generator(device='cpu')
    g.manual_seed(3)
    b = popfused.draw_spec_banks(g, 32, 4, 5, 40, nlive=7, x_dim=3)
    assert b['xibank'].shape == (40, 32, 4) and b['xibank'].dtype == \
        torch.float32
    assert b['pick'].shape == (5, 32) and b['idx0'].shape == (32,)
    assert int(b['i1'].max()) < 7 and int(b['i2'].max()) < 6
    assert int(b['jx'].max()) < 3 and int(b['idx0'].max()) < 7
    assert popfused.spec_max_rounds(100, 64, 8) == 800
    assert popfused.spec_max_rounds(8, 64, 8) == \
        8 * max(4, (64 + 7) // 8)
