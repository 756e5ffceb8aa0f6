"""The port's mesh sharding (``ultranest_torch.parallel``) on gloo ranks.

Two jobs of ``tests/torch_mesh_jobs.py`` run once, side by side, in a
module fixture: four ranks (``shards``) and two ranks (``runs``), each
rank a fresh interpreter joined to the others by a gloo process group
on 127.0.0.1. They write their results to ``.npz`` files, which these
tests read. The JAX side runs here, on the conftest's 8-device CPU mesh.

* the sharded bootstrap radius equals the single-device radius exactly
  and the JAX package's ``_bootstrap_radius(mesh=make_mesh(4))`` within
  rtol 1e-6; region enlargements with and without a mesh agree within
  ``tests/test_parallel.py``'s tolerances;
* the sharded segment dispatch, each shard fed the banks of
  ``jax.random.fold_in(key, shard)``, matches the JAX package's
  ``_build_segment_sharded`` on ``make_mesh(4)`` within the 1e-6 of
  ``tests/test_torch_popfused.py``;
* the gathered rejection dispatch is bit-equal to the four shards'
  dispatches done one by one, and a (2, 2) ``('dcn', 'ranks')`` mesh
  (also one whose rank order differs from its shard order) gives the
  1-axis mesh's results bit for bit;
* whole runs on two ranks agree exactly, stay inside
  ``tests/test_distributed.py``'s gates and bill ncall exactly.
"""
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ultranest_tpu.popfused as jpop
from ultranest_torch import parallel, popfused
from ultranest_torch.ops.bootstrap import make_bootstrap_masks
from ultranest_torch.ops.pairwise import pad_rows, round_up
from ultranest_torch.parallel import launch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
P, D, NSTEPS, NSHARDS = 64, 8, 8, 4
CENTER = (0.5, 0.45, 0.55)
MESHES = ('grid', 'perm')
# (d, treg_on, seed) of the two segment cases
SEG_CASES = {'a': (2, False, 0), 'b': (3, True, 1)}
LOGZ = np.log(2 * np.pi * 0.1 ** 2)


def _loglike_jax(x):
    s = jnp.abs(x[:, 0] - CENTER[0]) + jnp.abs(x[:, 1] - CENTER[1])
    if x.shape[1] == 3:
        s = s + jnp.abs(x[:, 2] - CENTER[2])
    return -s


@jax.jit
def _split_banks(key, nlive, xshape, ishape):
    """The reference's draws for *key* (``popfused.py:539-558``), as
    ``tests/test_torch_popfused.py`` draws them."""
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


def _seg_state(d, seed, nlive=50):
    """Live points (padded with +inf), axes, whitening pack and treg."""
    rng = np.random.RandomState(seed + 10)
    u = np.clip(np.asarray(CENTER[:d]) + 0.12 * rng.normal(size=(nlive, d)),
                0.01, 0.99)
    L = -np.abs(u - np.asarray(CENTER[:d])).sum(axis=1)
    std = u.std(axis=0)
    npad = round_up(nlive)
    return dict(
        live_u=pad_rows(u.astype(np.float32), npad),
        live_L=pad_rows(L.astype(np.float32), npad, fill=np.inf),
        axes=np.diag(std).astype(np.float32),
        tpack=np.vstack([np.diag(1.0 / std), np.zeros((1, d))]).astype(
            np.float32), nlive=nlive)


def _seg_treg(d, on):
    if not on:
        return np.zeros(1, np.float32)
    return np.concatenate([np.full(d, 0.5), np.eye(d).ravel() / 0.25 ** 2,
                           [1.0]]).astype(np.float32)


def _seg_key(case):
    seed = SEG_CASES[case][2]
    return np.array([3 + seed, 5 * seed + 1], np.uint32)


def _inputs():
    """Every input of the jobs, made here from numpy seeds."""
    rng = np.random.RandomState(7)
    inp = dict(radius_tpoints=rng.normal(size=(300, 6)))
    inp['radius_masks'] = make_bootstrap_masks(300, 30, rng=rng)
    inp['enl_u'] = rng.uniform(0.3, 0.7, size=(200, 4))
    inp['rej_u'] = np.clip(rng.normal(0.5, 0.1, size=(100, 3)), 0.01, 0.99)
    inp['rej_Lmin'] = np.median(
        -0.5 * (((inp['rej_u'] - 0.5) / 0.1) ** 2).sum(axis=1))
    rng2 = np.random.RandomState(11)
    inp['kl_ref'] = np.log(rng2.dirichlet(np.ones(500))).reshape((-1, 1))
    other = np.log(rng2.dirichlet(np.ones(500), size=30)).T
    other[rng2.uniform(size=other.shape) < 0.05] = -np.inf
    inp['kl_other'] = other
    inp.update(seg_popsize=P, seg_nsteps=NSTEPS, seg_depth=D)
    max_rounds = popfused.spec_max_rounds(NSTEPS, 64, D)
    for case, (d, treg_on, seed) in SEG_CASES.items():
        st = _seg_state(d, seed)
        inp.update({'seg_%s_%s' % (case, k): v for k, v in st.items()})
        inp.update({'seg_%s_d' % case: d, 'seg_%s_treg_on' % case: treg_on,
                    'seg_%s_treg' % case: _seg_treg(d, treg_on)})
        xs = np.zeros((max_rounds, P // NSHARDS, D, d), np.int8)
        for s in range(NSHARDS):
            key = jax.random.fold_in(_seg_key(case), s)
            banks = _split_banks(key, np.int32(st['nlive']), xs,
                                 np.zeros((NSTEPS,), np.int8))
            for name, a in zip(('xibank', 'i1', 'i2', 'jx', 'pick', 'idx0'),
                               banks):
                inp['seg_%s_b%d_%s' % (case, s, name)] = np.asarray(a)
    return inp


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _start(job, world, work, extra_env=None):
    env = dict(os.environ, GLOO_SOCKET_IFNAME='lo', OMP_NUM_THREADS='1',
               PYTHONPATH=REPO + os.pathsep + os.environ.get('PYTHONPATH', ''))
    env.update(extra_env or {})
    port = str(_free_port())
    return [subprocess.Popen(
        [sys.executable, os.path.join(HERE, 'torch_mesh_jobs.py'), job,
         str(rank), str(world), port, str(work)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=REPO) for rank in range(world)]


@pytest.fixture(scope='module')
def jobs(tmp_path_factory):
    """Runs both jobs once; returns {job: [per-rank result dicts]}."""
    work = tmp_path_factory.mktemp('mesh_jobs')
    np.savez(work / 'inputs.npz', **_inputs())
    procs = {'shards': _start('shards', NSHARDS, work,
                              dict(LOCAL_WORLD_SIZE='2')),
             'runs': _start('runs', 2, work)}
    failed = []
    try:
        for job, ps in procs.items():
            for rank, p in enumerate(ps):
                out, _ = p.communicate(timeout=300)
                if p.returncode != 0:
                    failed.append((job, rank, p.returncode, out[-3000:]))
    finally:
        for ps in procs.values():
            for p in ps:
                p.kill()
    assert not failed, failed
    return {job: [dict(np.load(work / ('%s_rank%d.npz' % (job, r)),
                               allow_pickle=True))
                  for r in range(len(ps))] for job, ps in procs.items()}


# ---------------------------------------------------------------- radius --

def test_sharded_radius_equals_single_device_radius(jobs):
    for res in jobs['shards']:
        assert res['flat_radius'] == res['radius_single'] > 0
        # each shard ran K2 (its plain version) once on its block
        assert res['flat_radius_calls'] == 1
        assert res['flat_radius_few'] == res['radius_few_single'] > 0


def test_sharded_radius_matches_jax_mesh(jobs):
    from ultranest_tpu.ops.bootstrap import _bootstrap_radius
    from ultranest_tpu.parallel import make_mesh
    inp = _inputs()
    want = _bootstrap_radius(inp['radius_tpoints'], inp['radius_masks'],
                             mesh=make_mesh(NSHARDS))
    np.testing.assert_allclose(jobs['shards'][0]['flat_radius'], want,
                               rtol=1e-6)


def test_enlargement_with_mesh_equals_without(jobs):
    for res in jobs['shards']:
        (r1, f1), (r2, f2) = res['enl_single'], res['flat_enl_mesh']
        np.testing.assert_allclose(r2, r1, rtol=1e-6)
        np.testing.assert_allclose(f2, f1, rtol=1e-12)


def test_kl_table_with_mesh_equals_host_table(jobs):
    for res in jobs['shards']:
        np.testing.assert_array_equal(res['kl_mesh'], res['kl_host'])
        np.testing.assert_array_equal(res['kl_mesh_tot'], res['kl_host_tot'])
        assert res['kl_mesh'].shape == (500, 30)


# --------------------------------------------------------------- segment --

@pytest.mark.parametrize('case', sorted(SEG_CASES))
def test_segment_dispatch_matches_jax_sharded_kernel(jobs, case):
    from ultranest_tpu.parallel import make_mesh
    d, treg_on, _ = SEG_CASES[case]
    inp = _inputs()
    st = {k: inp['seg_%s_%s' % (case, k)] for k in
          ('live_u', 'live_L', 'axes', 'tpack', 'nlive')}
    ref = jpop.FusedPopulationSliceSampler(
        popsize=P, nsteps=NSTEPS, jax_loglike=_loglike_jax, spec_depth=D,
        seed=0, mesh=make_mesh(NSHARDS))
    if treg_on:
        ref._treg_key = (True, d)
    run = ref._build_segment_sharded(len(st['live_u']), d)
    want = [np.asarray(a) for a in run(
        _seg_key(case), st['live_u'], st['live_L'], np.int32(st['nlive']),
        st['axes'], np.float32(1.0), _seg_treg(d, treg_on), st['tpack'])]
    res = jobs['shards'][0]
    lu2, lL2, packed, counts = (res['flat_seg_%s_%s' % (case, k)] for k in
                                ('lu2', 'lL2', 'packed', 'counts'))
    assert res['flat_seg_%s_scans' % case] == 1
    assert counts.dtype == np.int64
    assert list(counts) == list(want[2][-1, [0, 3]])
    np.testing.assert_allclose(lu2, want[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(lL2, want[1], rtol=0, atol=1e-6)
    rows, scal = packed[:-1], packed[-1]
    wrows, wscal = want[2][:-1], want[2][-1]
    assert packed.shape == want[2].shape == (P + 1, d + 7)
    np.testing.assert_allclose(rows[:, :d + 1], wrows[:, :d + 1], rtol=0,
                               atol=1e-6)
    # [accept, worst, Lmin, rank, flags, jump2]
    for c in (1, 2, 4, 5):
        np.testing.assert_array_equal(rows[:, d + c], wrows[:, d + c])
    np.testing.assert_allclose(rows[:, d + 3], wrows[:, d + 3], rtol=0,
                               atol=1e-6)
    # jump2 = |T (uf - u0)|^2 carries the 1e-6 of uf: at most
    # 2 |T (uf - u0)| |T| sqrt(d) 1e-6 apart
    tmax = np.abs(st['tpack'][:-1]).max()
    np.testing.assert_array_less(
        np.abs(rows[:, d + 6] - wrows[:, d + 6]),
        2 * np.sqrt(wrows[:, d + 6]) * tmax * np.sqrt(d) * 1e-6 + 1e-9)
    # [nc, done_frac, width, nuseful, ref2]
    assert scal[0] == wscal[0] and scal[3] == wscal[3]
    assert scal[1] == wscal[1]
    np.testing.assert_allclose(scal[2], wscal[2], rtol=1e-6)
    np.testing.assert_allclose(scal[4], wscal[4], rtol=1e-6)
    assert rows[:, d + 1].sum() > 0


@pytest.mark.parametrize('case', sorted(SEG_CASES))
def test_segment_live_state_is_the_same_on_every_rank(jobs, case):
    first = jobs['shards'][0]
    for res in jobs['shards'][1:]:
        for k in ('lu2', 'lL2', 'packed', 'counts'):
            key = 'flat_seg_%s_%s' % (case, k)
            np.testing.assert_array_equal(res[key], first[key])


# ------------------------------------------------------------- rejection --

def test_rejection_dispatch_equals_shard_dispatches_one_by_one(jobs):
    for res in jobs['shards']:
        np.testing.assert_array_equal(res['flat_rej_gathered'],
                                      res['flat_rej_singles'])
        assert res['flat_rej_nc'] == res['flat_rej_singles_nc'] > 0
        # four blocks of min(128 drawn, 256 kept) rows, each with its
        # [nc, n_acc] row
        blocks = res['flat_rej_gathered'].reshape(NSHARDS, 129, -1)
        assert blocks[:, -1, 0].sum() == res['flat_rej_nc']
        assert (blocks[:, -1, 1] > 0).all()


def test_rejection_call_keeps_each_shards_accepted_rows(jobs):
    Lmin = _inputs()['rej_Lmin']
    first = jobs['shards'][0]
    for res in jobs['shards']:
        u, logl = res['flat_rej_call_u'], res['flat_rej_call_logl']
        assert len(u) > 0 and res['flat_rej_call_nc'] > len(u)
        assert (logl > Lmin).all()
        assert ((u > 0) & (u < 1)).all()
        np.testing.assert_array_equal(u, first['flat_rej_call_u'])


def test_parallel_propose_evaluate(jobs):
    first = jobs['shards'][0]
    u, acc = first['flat_ppe_u'], first['flat_ppe_acc']
    assert u.shape == (NSHARDS * 64, 2) and acc.dtype == bool
    assert acc.any() and int(first['flat_ppe_ncall']) >= acc.sum()
    # the shards drew different candidates
    assert not np.allclose(u[:64], u[64:128])
    np.testing.assert_array_less(-10.0, first['flat_ppe_logl'][acc])
    for res in jobs['shards'][1:]:
        np.testing.assert_array_equal(res['flat_ppe_u'], u)


# -------------------------------------------------------- 2-axis meshes --

@pytest.mark.parametrize('mesh', MESHES)
def test_two_axis_mesh_equals_flat_mesh(jobs, mesh):
    keys = ['radius', 'radius_few', 'rej_gathered', 'rej_nc', 'rej_call_u',
            'rej_call_nc', 'ppe_u', 'ppe_ncall'] + [
        'seg_%s_%s' % (c, k) for c in SEG_CASES
        for k in ('lu2', 'lL2', 'packed', 'counts')]
    for rank, res in enumerate(jobs['shards']):
        for k in keys:
            np.testing.assert_array_equal(res['%s_%s' % (mesh, k)],
                                          res['flat_' + k], err_msg=k)
        (r1, f1), (r2, f2) = res['flat_enl_mesh'], res[mesh + '_enl_mesh']
        assert (r1, f1) == (r2, f2)


def test_shard_index_is_the_row_major_coordinate(jobs):
    got = {m: [int(res[m + '_index']) for res in jobs['shards']]
           for m in ('flat',) + MESHES}
    assert got == {'flat': [0, 1, 2, 3], 'grid': [0, 1, 2, 3],
                   'perm': [1, 0, 3, 2]}


def test_launcher_helpers(jobs):
    for rank, res in enumerate(jobs['shards']):
        assert list(res['slice_shape']) == [2, 2]
        assert res['multiprocess']
        idx = [1, 0, 3, 2][rank]
        assert list(res['shard_rows']) == [2 * idx, 2 * idx + 1]
        assert int(res['count_ranks']) == 2
        assert list(res['shard_rows_ranks']) == \
            list(range(4 * (rank % 2), 4 * (rank % 2) + 4))
        assert list(res['fetched']) == [0, 1, 2]


def test_mesh_errors(jobs):
    for res in jobs['shards']:
        assert res['err_make_mesh'] and res['err_make_mesh_shape']
        assert res['err_popsize'] and res['err_axis']
    with pytest.raises(RuntimeError, match='process group'):
        parallel.make_mesh(2)
    with pytest.raises(TypeError, match='DeviceMesh'):
        parallel.check_mesh(object())
    assert parallel.shard_count(None) == 1 and parallel.shard_index(None) == 0


# ------------------------------------------------------------- full runs --

@pytest.mark.parametrize('path', ['rej', 'pop'])
def test_full_runs_agree_across_ranks(jobs, path):
    a, b = jobs['runs']
    for k in ('logz', 'logzerr', 'ncall', 'niter', 'billed', 'digest'):
        assert a['%s_%s' % (path, k)] == b['%s_%s' % (path, k)], k


@pytest.mark.parametrize('path,gate,nlive', [('rej', 1.0, 100),
                                             ('pop', 1.5, 50)])
def test_full_runs_gates_and_billing(jobs, path, gate, nlive):
    res = jobs['runs'][0]
    assert abs(res[path + '_logz'] - LOGZ) < gate, res[path + '_logz']
    # ncall: the root points plus every dispatch's summed billed count
    assert res[path + '_ncall'] == res[path + '_billed'] + nlive
    if path == 'rej':
        assert res['rej_nshards'] == 2
    else:
        assert res['pop_segments'] > 0


# ---------------------------------------------------------- host helpers --

def test_shard_seed_is_a_fixed_mix():
    key = np.array([123, 456], np.uint32)
    seeds = [parallel.shard_seed(key, i) for i in range(8)]
    assert len(set(seeds)) == 8
    assert seeds == [parallel.shard_seed(key, i) for i in range(8)]
    assert all(0 <= s < 2**63 for s in seeds)
    assert parallel.shard_seed(np.array([123, 457], np.uint32), 0) \
        != seeds[0]


@pytest.mark.parametrize('env,want', [
    (dict(ULTRANEST_TORCH_COORDINATOR='h:1', ULTRANEST_TORCH_NPROC='3',
          ULTRANEST_TORCH_PROCID='2', OMPI_COMM_WORLD_SIZE='9',
          OMPI_COMM_WORLD_RANK='8', MASTER_ADDR='m', MASTER_PORT='7',
          WORLD_SIZE='5', RANK='4'), ('tcp://h:1', 3, 2)),
    (dict(ULTRANEST_TORCH_COORDINATOR='h:1', OMPI_COMM_WORLD_SIZE='9',
          OMPI_COMM_WORLD_RANK='8', WORLD_SIZE='5', RANK='4'),
     ('tcp://h:1', 9, 8)),
    (dict(ULTRANEST_TORCH_COORDINATOR='h:1', PMI_SIZE='6', PMI_RANK='0',
          RANK='4'), ('tcp://h:1', 6, 0)),
    (dict(MASTER_ADDR='m', MASTER_PORT='7', WORLD_SIZE='5', RANK='4'),
     ('tcp://m:7', 5, 4)),
])
def test_init_distributed_resolves_its_arguments(monkeypatch, env, want):
    for k in ('ULTRANEST_TORCH_COORDINATOR', 'ULTRANEST_TORCH_NPROC',
              'ULTRANEST_TORCH_PROCID', 'OMPI_COMM_WORLD_SIZE',
              'OMPI_COMM_WORLD_RANK', 'PMI_SIZE', 'PMI_RANK', 'MASTER_ADDR',
              'MASTER_PORT', 'WORLD_SIZE', 'RANK'):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    seen = []
    monkeypatch.setattr(launch.dist, 'init_process_group',
                        lambda backend, **kw: seen.append((backend, kw)))
    launch.init_distributed(backend='gloo')
    (backend, kw), = seen
    assert backend == 'gloo'
    assert (kw['init_method'], kw['world_size'], kw['rank']) == want
    # explicit arguments come first
    seen.clear()
    launch.init_distributed('x:2', 2, 1, backend='gloo')
    assert (seen[0][1]['init_method'], seen[0][1]['world_size'],
            seen[0][1]['rank']) == ('tcp://x:2', 2, 1)


def test_init_distributed_needs_its_arguments(monkeypatch):
    for k in ('ULTRANEST_TORCH_COORDINATOR', 'MASTER_ADDR',
              'ULTRANEST_TORCH_NPROC', 'WORLD_SIZE', 'OMPI_COMM_WORLD_SIZE',
              'PMI_SIZE'):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match='coordinator'):
        launch.init_distributed(backend='gloo')


def test_collectives_keep_their_inputs_on_one_rank(tmp_path):
    """A world-1 gloo group in a fresh process: every collective returns
    its input (the card's NCCL check does the same on CUDA tensors)."""
    src = '''
import sys, torch
from ultranest_torch.parallel import (all_gather_rows, make_mesh, pmax,
                                      pmean, psum)
from ultranest_torch.parallel.launch import init_distributed
init_distributed('127.0.0.1:%s' % sys.argv[1], 1, 0, backend='gloo')
mesh = make_mesh()
x = torch.arange(6, dtype=torch.float32).reshape(3, 2)
c = torch.tensor([2**40 + 3, 5], dtype=torch.int64)
assert torch.equal(all_gather_rows(x, mesh), x)
assert torch.equal(psum(c, mesh), c) and torch.equal(pmax(x, mesh), x)
assert torch.equal(pmean(x, mesh), x)
print('WORLD1_OK')
'''
    script = tmp_path / 'world1.py'
    script.write_text(src)
    env = dict(os.environ, GLOO_SOCKET_IFNAME='lo',
               PYTHONPATH=REPO + os.pathsep + os.environ.get('PYTHONPATH',
                                                             ''))
    out = subprocess.run([sys.executable, str(script), str(_free_port())],
                         capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=120)
    assert out.returncode == 0 and 'WORLD1_OK' in out.stdout, out.stderr
