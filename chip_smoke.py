#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ultranest_torch``) on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. checks for a CUDA device (exit 1 without one) and prints the card's
   name and power limit as ``nvidia-smi`` reports them;
2. builds the four CUDA kernels with nvcc (one compiler per source, all
   started together) and prints the build time;
3. holds each kernel against its plain torch version on the card, at
   the shapes its paths give it, and times both with CUDA events;
4. drives the paths, each with every kernel count set to 0 just before
   it and read just after it:

   * the membership shootout (``ultranest_torch.evaluate.bench_membership``,
     the path of K1t), at its three shapes;
   * the region-rejection path: the eggbox with the JAX package's bench
     configuration (400 live points, ``bench.py:104-115``) through
     ``ReactiveNestedSampler(..., device='cuda')``, gated on the
     quadrature logZ;
   * the population spec-walk path at the bench's own settings
     (``bench.py:126-219``, 400 live points, dlogz 2, spec depth 8):
     asymgauss50 (d 50, popsize 4096, nsteps 100), then the extras
     rosenbrock8 (popsize 128, nsteps 16; no gate), multishell8 (128,
     16), loggamma30 (256, 60) and the governed gauss100 (2048, nsteps
     100 growing under ``adaptive_nsteps``), each gated as
     ``bench.py:353-372`` gates it;
   * the sync, async and random-walk engines in segment mode at the JAX
     package's engine tests' configurations (``tests/test_popfused.py:
     40-107``), gated as those tests gate, and one classic-mode async
     run (segment path off) on the default MLFriends region;

   and checks that each path's kernels were launched in its run (K3 on
   every segment path; the classic run consumes on the host and
   launches K2 in its region rebuilds);
5. prints one JSON line describing the kernels, then the result line
   ``{"ok": true, "device": {...}}`` last.

Any failed check raises, which exits non-zero before the last line.
"""

import json
import subprocess
import sys
import time

import numpy as np

KERNEL_NOTES = {
    'radius_member': ('ultranest_torch/csrc/radius_member.cu',
                      'ultranest_tpu/ops/pallas_kernels.py:84'),
    'radius_member_t': ('ultranest_torch/csrc/radius_member_t.cu',
                        'evaluate/bench_pallas_membership.py:62'),
    'bootstrap_radius': ('ultranest_torch/csrc/bootstrap_radius.cu',
                         'ultranest_tpu/ops/pallas_kernels.py:203'),
    'consume_scan': ('ultranest_torch/csrc/consume_scan.cu',
                     'ultranest_tpu/segmentops.py:78'),
}
EGGBOX_LOGZ = 235.856


def check_radius_member(kernels, rng, npad, m, d):
    import torch
    from ultranest_torch.evaluate.bench_membership import (boundary_radii,
                                                           cuda_ms)
    nvalid = npad * 25 // 32
    tp = rng.normal(size=(npad, d)).astype(np.float32)
    tmask = (np.arange(npad) < nvalid).astype(np.int32)
    cands = rng.normal(size=(m, d)).astype(np.float32)
    tp_t, tm_t, c_t = (torch.as_tensor(a, device='cuda')
                       for a in (tp, tmask, cands))
    # squared radii taken from candidates' own nearest-valid-point
    # distances (65 quantiles from 0.1 to 0.9): each puts candidates
    # exactly on the boundary, where a sum rounded differently (an FMA,
    # another order) may flip their membership
    r2s, mind = boundary_radii(tp_t[:nvalid], c_t)
    nboundary = 0
    for r2 in r2s:
        on = mind == r2
        got = kernels.radius_member(tp_t, tm_t, c_t, r2)
        want = kernels.radius_member_plain(tp_t, tm_t, c_t, r2)
        nmis = int((got != want).sum())
        assert nmis == 0, ('radius_member disagrees', npad, m, d, r2, nmis)
        assert bool(on.any()) and bool(want[on].all()), \
            ('no member on the boundary', r2)
        nboundary += int(on.sum())
    r2 = r2s[len(r2s) // 2]
    frac = float(kernels.radius_member_plain(tp_t, tm_t, c_t, r2)
                 .float().mean())
    assert 0.05 < frac < 0.95, ('degenerate membership test case', frac)
    ms = cuda_ms(lambda: kernels.radius_member(tp_t, tm_t, c_t, r2), 50)
    plain = cuda_ms(lambda: kernels.radius_member_plain(tp_t, tm_t, c_t, r2),
                    5)
    print('K1 radius_member npad=%d M=%d d=%d: equal at %d radii with %d '
          'candidates exactly on the boundary, kernel %.4f ms, plain '
          '%.4f ms' % (npad, m, d, len(r2s), nboundary, ms, plain))
    return 0.0, ms, plain


def check_bootstrap_radius(kernels, rng, n, nrounds, d):
    from ultranest_torch.evaluate.bench_membership import cuda_ms
    from ultranest_torch.ops.bootstrap import (_numpy_radius,
                                               make_bootstrap_masks,
                                               radius_inputs)
    tp = rng.normal(size=(n, d)).astype(np.float32)
    masks = make_bootstrap_masks(n, nrounds, rng=np.random.RandomState(n))
    args = radius_inputs(tp, masks, 'cuda')
    got = float(kernels.bootstrap_radius(*args))
    want = float(kernels.bootstrap_radius_plain(*args))
    err = abs(got - want)
    assert err <= 1e-6 * abs(want), ('bootstrap_radius disagrees', got,
                                     want)
    ms = cuda_ms(lambda: kernels.bootstrap_radius(*args), 50)
    plain = cuda_ms(lambda: kernels.bootstrap_radius_plain(*args), 5)
    t0 = time.perf_counter()
    for _ in range(10):
        host = _numpy_radius(tp, masks)
    host_ms = (time.perf_counter() - t0) * 100
    print('K2 bootstrap_radius N=%d B=%d d=%d: %.9g vs plain %.9g '
          '(|err| %.3g), kernel %.4f ms, plain %.4f ms, host KNN path '
          '%.4f ms (value %.9g)' % (n, len(masks), d, got, want, err, ms,
                                    plain, host_ms, host))
    return err, ms, plain


def check_consume_scan(kernels, rng, npad, P, all_valid=False):
    """K3 against its plain version; *all_valid*: every row a finished
    walker, as on the spec path."""
    import torch
    from ultranest_torch.evaluate.bench_membership import cuda_ms
    nlive = npad * 25 // 32
    live_L = np.full(npad, np.inf, np.float32)
    live_L[:nlive] = rng.uniform(-5, 0, nlive).astype(np.float32)
    live_L[[3, 17, 40]] = live_L[:nlive].min() - 1   # plateau at the min
    rows_L = rng.uniform(-5, 2, P).astype(np.float32)
    rows_L[::7] = live_L[rng.randint(nlive, size=len(rows_L[::7]))]  # dups
    rows_L[5] = live_L[3]                                # plateau value
    rows_valid = np.zeros(P, np.float32)
    if all_valid:
        rows_valid[:] = 1.0
    else:
        rows_valid[:P // 3] = rng.uniform(size=P // 3) < 0.8
    a = [torch.as_tensor(x, device='cuda') for x in (live_L, rows_L,
                                                      rows_valid)]
    gL, grec = kernels.consume_scan(*a)
    wL, wrec = kernels.consume_scan_plain(*a)
    assert torch.equal(gL, wL) and torch.equal(grec, wrec), \
        'consume_scan records differ'
    ms = cuda_ms(lambda: kernels.consume_scan(*a), 50)
    plain = cuda_ms(lambda: kernels.consume_scan_plain(*a), 3)
    print('K3 consume_scan npad=%d P=%d: records bit-equal (%d accepted, '
          '%d plateau, %d dup), kernel %.4f ms, plain %.4f ms'
          % (npad, P, int(wrec[:, 0].sum()), int((wrec[:, 4] >= 2).sum()),
             int((wrec[:, 4] % 2).sum()), ms, plain))
    return 0.0, ms, plain


def run_eggbox(seed=42):
    """One eggbox run at the bench configuration on the card.

    Every kernel count is set to 0 just before the run and read just
    after it. Raises if logZ is outside the bench gate, the posterior
    samples are malformed, the segment path never engaged or a kernel of
    the path was never launched; returns the run's summary.
    """
    import torch
    from ultranest_torch import ReactiveNestedSampler
    from ultranest_torch.models.problems import eggbox
    from ultranest_torch.ops import kernels
    prob = eggbox()
    sampler = ReactiveNestedSampler(
        prob.param_names, prob.loglike, transform=prob.transform,
        vectorized=True, seed=seed, torch_loglike=prob.torch_loglike,
        torch_transform=prob.torch_transform, device='cuda',
        ndraw_min=4096, ndraw_max=32768)
    kernels.reset_counts()
    t0 = time.perf_counter()
    res = sampler.run(
        min_num_live_points=400, viz_callback=False, show_status=False,
        max_num_improvement_loops=0, min_ess=0, dlogz=0.5, frac_remain=0.1,
        Lepsilon=0.001, max_ncalls=400000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = dict(seed=seed, wall_s=wall, ncall=int(res['ncall']),
               niter=int(res['niter']), logz=float(res['logz']),
               logzerr=float(res['logzerr']),
               evals_per_s=res['ncall'] / wall,
               phases_s=dict(getattr(sampler, '_segment_phase_s', {})),
               segment_exits=dict(getattr(sampler, '_segment_exits', {})),
               launches=dict(kernels.LAUNCHES))
    assert abs(res['logz'] - EGGBOX_LOGZ) < max(4 * res['logzerr'], 1.0), \
        ('eggbox logZ outside the gate', res['logz'], res['logzerr'])
    assert np.isfinite(res['samples']).all() and \
        res['samples'].shape[1] == 2, 'bad posterior samples'
    assert out['segment_exits'], 'the segment path never engaged'
    for name in kernels.REGION_KERNELS:
        assert out['launches'].get(name, 0) > 0, ('kernel not launched',
                                                  name)
    return out


def check_membership_shootout(kernels):
    """K1t phase: equality at the shootout's shapes, then its main path.

    Holds K1 and K1t against the plain version at 65 boundary radii per
    shape (those launches are comparisons), then sets the counts to 0
    and runs the shootout's timing, the path that launches K1t.
    Returns (per-shape timing rows, K1t launches of that run).
    """
    from ultranest_torch.evaluate import bench_membership
    for npts, m, d in bench_membership.SHAPES:
        nb = bench_membership.check_shape(npts, m, d, 'cuda')
        print('K1t radius_member_t N=%d M=%d d=%d: K1t and K1 equal to the '
              'plain version at 65 radii, %d candidates exactly on the '
              'boundary' % (npts, m, d, nb))
    kernels.reset_counts()
    rows = bench_membership.run()
    launches = kernels.LAUNCHES['radius_member_t']
    assert launches > 0, 'the shootout never launched K1t'
    return rows, launches


# The population spec-walk problems at the JAX package's bench settings
# (bench.py:126-219): factory and arguments, popsize, nsteps, extra
# sampler settings, the seed and the logZ gate as (truth, floor):
# |logZ - truth| < max(4 logzerr, floor) (bench.py:353-372), truth None
# for the problem's analytic logz; rosenbrock8 has no gate there.
POPULATION_PROBLEMS = {
    'asymgauss50': (('asymgauss', dict(ndim=50, sigma_min=0.01)), 4096, 100,
                    {}, 1, (0.0, 1.5)),
    'rosenbrock8': (('rosenbrock', dict(ndim=8)), 128, 16, {}, 3, None),
    'multishell8': (('multishell', dict(ndim=8)), 128, 16, {}, 3,
                    (None, 1.0)),
    'loggamma30': (('loggamma', dict(ndim=30)), 256, 60, {}, 3, (0.0, 1.5)),
    'gauss100': (('gauss', dict(ndim=100, sigma=0.1)), 2048, 100,
                 dict(adaptive_nsteps=True), 3, (0.0, 2.0)),
    'gauss100_hard': (('gauss', dict(ndim=100, sigma=0.01)), 2048, 100,
                      dict(adaptive_nsteps=True), 3, (0.0, 2.0)),
}


def run_population_problem(name, seed=None):
    """One problem of :data:`POPULATION_PROBLEMS` on the spec-walk path.

    As ``bench.py:_run_popfused``: ``ScalingLayer``, ``SimpleRegion``,
    ``FusedPopulationSliceSampler(engine='spec', spec_depth=8)``, 400
    live points, ``dlogz=2.0``, ``frac_remain=0.1``, on the card. Every
    kernel count is set to 0 just before the run and read just after it.
    Raises if logZ is outside the bench gate, the samples are malformed,
    the segment path never engaged or K3 was never launched; returns the
    run's summary.
    """
    import torch
    from ultranest_torch import ReactiveNestedSampler
    from ultranest_torch.mlfriends import ScalingLayer, SimpleRegion
    from ultranest_torch.models import problems
    from ultranest_torch.ops import kernels
    from ultranest_torch.popfused import FusedPopulationSliceSampler
    (factory, kw), popsize, nsteps, extra, seed0, gate = \
        POPULATION_PROBLEMS[name]
    seed = seed0 if seed is None else seed
    prob = getattr(problems, factory)(**kw)
    sampler = ReactiveNestedSampler(
        seed=seed, device='cuda', **prob.sampler_kwargs(use_torch=False))
    sampler.transform_layer_class = ScalingLayer
    ss = sampler.stepsampler = FusedPopulationSliceSampler(
        popsize=popsize, nsteps=nsteps, torch_loglike=prob.torch_loglike,
        torch_transform=prob.torch_transform, seed=seed, engine='spec',
        spec_depth=8, device='cuda', **extra)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    t0 = time.perf_counter()
    res = sampler.run(
        min_num_live_points=400, viz_callback=False, show_status=False,
        max_num_improvement_loops=0, min_ess=0, dlogz=2.0, frac_remain=0.1,
        region_class=SimpleRegion, cluster_num_live_points=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ncall_useful = int(res['ncall']) - (ss.ncalls - ss.ncalls_useful)
    walks = ss.walk_log
    phases = dict(getattr(sampler, '_segment_phase_s', {}))
    rounds = sum(w['rounds'] for w in walks)
    changes = [(i, walks[i - 1]['nsteps'], w['nsteps'])
               for i, w in enumerate(walks)
               if i and w['nsteps'] != walks[i - 1]['nsteps']]
    out = dict(name=name, seed=seed, wall_s=wall, ncall=int(res['ncall']),
               ncall_useful=ncall_useful, niter=int(res['niter']),
               logz=float(res['logz']), logzerr=float(res['logzerr']),
               logz_expected=prob.logz,
               evals_per_s=res['ncall'] / wall,
               useful_evals_per_s=ncall_useful / wall,
               dispatches=len(walks), rounds=rounds,
               launch_ms_per_round=1e3 * phases.get('launch', 0.0)
               / max(rounds, 1),
               rounds_per_dispatch=[w['rounds'] for w in walks],
               reads_per_dispatch=[w['reads'] for w in walks],
               nsteps_changes=changes, spec_depth=ss.spec_depth,
               peak_device_mib=torch.cuda.max_memory_allocated() / 2**20,
               nsteps_final=int(ss.nsteps), phases_s=phases,
               segment_exits=dict(getattr(sampler, '_segment_exits', {})),
               launches=dict(kernels.LAUNCHES))
    if gate is not None:
        truth = prob.logz if gate[0] is None else gate[0]
        assert abs(res['logz'] - truth) < max(4 * res['logzerr'], gate[1]), \
            ('%s logZ outside the gate' % name, res['logz'], res['logzerr'],
             truth)
    assert np.isfinite(res['samples']).all() and \
        res['samples'].shape[1] == prob.ndim, 'bad posterior samples'
    assert out['segment_exits'], 'the popfused segment path never engaged'
    assert out['launches'].get('consume_scan', 0) > 0, \
        'K3 was not launched on the spec path of %s' % name
    return out


def run_asymgauss50(seed=1):
    """asymgauss50 at the bench's full width (``bench.py:126-175``)."""
    return run_population_problem('asymgauss50', seed=seed)


def print_population_run(run):
    """The summary lines of one :func:`run_population_problem` run."""
    name = run['name']
    gate = POPULATION_PROBLEMS[name][-1]
    truth = 'no gate' if gate is None else 'truth %.4f, gate max(4 logzerr, ' \
        '%.1f)' % (run['logz_expected'] if gate[0] is None else gate[0],
                   gate[1])
    print('%s: logZ %.4f +- %.4f (%s), wall %.3f s, ncall %d, ncall_useful '
          '%d, %.0f evals/s, %.0f useful evals/s, niter %d, %d dispatches, '
          '%d rounds, launch %.3f ms per round, spec depth %d, nsteps_final '
          '%d, peak device memory %.1f MiB' % (
              name, run['logz'], run['logzerr'], truth, run['wall_s'],
              run['ncall'], run['ncall_useful'], run['evals_per_s'],
              run['useful_evals_per_s'], run['niter'], run['dispatches'],
              run['rounds'], run['launch_ms_per_round'], run['spec_depth'],
              run['nsteps_final'], run['peak_device_mib']))
    print('%s phases (s):' % name, json.dumps(run['phases_s']))
    print('%s segment exits:' % name, json.dumps(run['segment_exits']))
    print('%s nsteps changes (dispatch, from, to):' % name,
          json.dumps(run['nsteps_changes']))
    print('%s rounds per dispatch:' % name,
          json.dumps(run['rounds_per_dispatch']))
    print('%s host reads per dispatch:' % name,
          json.dumps(run['reads_per_dispatch']))
    print('%s kernel launches:' % name, json.dumps(run['launches']))


# The engines at the JAX package's engine tests' configurations
# (tests/test_popfused.py:40-107): factory and arguments, sampler
# settings, live points, seed, and whether the run uses a ScalingLayer
# and SimpleRegion (else the default MLFriends region).
ENGINE_RUNS = {
    'sync': (('gauss', dict(ndim=2, sigma=0.1)),
             dict(engine='sync', popsize=64, nsteps=8), 100, 1, False),
    'async': (('asymgauss', dict(ndim=8, sigma_min=0.02)),
              dict(engine='async', popsize=128, nsteps=16), 200, 4, True),
    'sync8': (('asymgauss', dict(ndim=8, sigma_min=0.02)),
              dict(engine='sync', popsize=128, nsteps=16), 200, 4, True),
    'rwalk': (('asymgauss', dict(ndim=8, sigma_min=0.02)),
              dict(popsize=128, nsteps=40, scale=0.1), 200, 9, True),
    'async_classic': (('asymgauss', dict(ndim=8, sigma_min=0.02)),
                      dict(engine='async', popsize=128, nsteps=16,
                           harvest_frac=1.0), 200, 4, False),
}


def run_engine(name):
    """One engine run of :data:`ENGINE_RUNS` on the card.

    Every kernel count is set to 0 just before the run and read just
    after it. ``async_classic`` turns the segment path off, so its walk
    runs in classic mode and its harvest is consumed on the host; every
    other run must engage the segment path and launch K3. Gated as the
    reference's tests gate: sync |logZ| < 1, the others |logZ| <
    3 max(logzerr, 0.5). Returns the run's summary.
    """
    import torch
    from ultranest_torch import ReactiveNestedSampler
    from ultranest_torch.mlfriends import ScalingLayer, SimpleRegion
    from ultranest_torch.models import problems
    from ultranest_torch.ops import kernels
    from ultranest_torch.popfused import (FusedPopulationRandomWalkSampler,
                                          FusedPopulationSliceSampler)
    (factory, kw), cfg, live, seed, scaling = ENGINE_RUNS[name]
    prob = getattr(problems, factory)(**kw)
    sampler = ReactiveNestedSampler(
        seed=seed, device='cuda', **prob.sampler_kwargs(use_torch=False))
    cls = FusedPopulationRandomWalkSampler if name == 'rwalk' \
        else FusedPopulationSliceSampler
    ss = sampler.stepsampler = cls(
        torch_loglike=prob.torch_loglike, seed=seed, device='cuda', **cfg)
    run = dict(min_num_live_points=live, viz_callback=False,
               show_status=False, max_num_improvement_loops=0, min_ess=0,
               dlogz=2.0, frac_remain=0.1)
    if scaling:
        sampler.transform_layer_class = ScalingLayer
        run.update(region_class=SimpleRegion, cluster_num_live_points=0)
    classic = name == 'async_classic'
    if classic:
        ss.segment_capable = False
    kernels.reset_counts()
    t0 = time.perf_counter()
    res = sampler.run(**run)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = dict(name=name, wall_s=wall, ncall=int(res['ncall']),
               niter=int(res['niter']), logz=float(res['logz']),
               logzerr=float(res['logzerr']),
               ncall_per_iter=res['ncall'] / res['niter'],
               dispatches=len(ss.walk_log),
               rounds=sum(w['rounds'] for w in ss.walk_log),
               reads=sum(w['reads'] for w in ss.walk_log),
               scale=ss.scale,
               segment_exits=dict(getattr(sampler, '_segment_exits', {})),
               launches=dict(kernels.LAUNCHES))
    if name.startswith('sync') and not scaling:
        assert abs(res['logz'] - prob.logz) < 1.0, (name, res['logz'])
    else:
        assert abs(res['logz'] - prob.logz) < \
            3 * max(res['logzerr'], 0.5), (name, res['logz'],
                                           res['logzerr'])
    assert np.isfinite(res['samples']).all(), 'bad posterior samples'
    assert ss.walk_log, 'the walk never ran'
    if classic:
        assert not out['segment_exits'] and \
            out['launches'].get('consume_scan', 0) == 0
        assert out['launches'].get('bootstrap_radius', 0) > 0, \
            'K2 was not launched in the classic run'
    else:
        assert out['segment_exits'], 'the segment path never engaged'
        assert out['launches'].get('consume_scan', 0) > 0, \
            'K3 was not launched on the %s segment path' % name
    if name == 'rwalk':
        assert ss.scale != 0.1, 'the random walk never adapted its scale'
    return out


def main():
    import torch
    t_start = time.time()
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print('torch %s, CUDA %s, python %s' % (
        torch.__version__, torch.version.cuda, sys.version.split()[0]))
    assert torch.backends.cuda.matmul.allow_tf32 is False, \
        'TF32 must stay off for the whitening matmuls'

    from ultranest_torch.ops import kernels
    from ultranest_torch.popfused import ROUND_OVERHEAD_S
    t0 = time.time()
    so = kernels.build()
    print('built %s in %.2f s' % (so.rsplit('/', 1)[-1], time.time() - t0))
    for line in kernels.BUILD_LOG.splitlines():
        if 'Used' in line or 'spill' in line:
            print('  ptxas:', line.strip())

    rng = np.random.RandomState(0)
    errs, times = {}, {}
    launches = {}
    for npad, m, d in ((512, 4096, 2), (512, 131072, 2), (512, 4096, 16),
                       (2048, 16384, 8)):
        err, ms, plain = check_radius_member(kernels, rng, npad, m, d)
        errs['radius_member'] = max(errs.get('radius_member', 0.0), err)
        times.setdefault('radius_member', (ms, plain))
    # the region rebuilds' shapes (30 bootstrap rounds): the eggbox's 400
    # live points, the sync d-2 engine run's 100 (one block, padded to
    # 128) and the classic async run's 200 in d 8 (padded to 256); 2048
    # in d 8 as a large case
    for n, nrounds, d in ((400, 30, 2), (100, 30, 2), (200, 30, 8),
                          (2048, 30, 8)):
        err, ms, plain = check_bootstrap_radius(kernels, rng, n, nrounds, d)
        errs['bootstrap_radius'] = max(errs.get('bootstrap_radius', 0.0),
                                       err)
        times.setdefault('bootstrap_radius', (ms, plain))
    err, ms, plain = check_consume_scan(kernels, rng, 512, 1024)
    errs['consume_scan'] = err
    times['consume_scan'] = (ms, plain)
    # the population paths' shapes (every row a finished walker): P 4096
    # (asymgauss50), 128 (rosenbrock8, multishell8), 256 (loggamma30) and
    # 2048 (gauss100) into 400 live points padded to 512; the engine
    # runs' P 64 into 128 (sync, 100 live) and P 128 into 256 (200 live)
    for npad, P in ((512, 4096), (512, 128), (512, 256), (512, 2048),
                    (128, 64), (256, 128)):
        check_consume_scan(kernels, rng, npad, P, all_valid=True)
    torch.cuda.synchronize()

    rows, launches['radius_member_t'] = check_membership_shootout(kernels)
    errs['radius_member_t'] = 0.0
    times['radius_member_t'] = (rows[0]['k1t_ms'], rows[0]['plain_ms'])
    print('membership shootout kernel launches: %d of K1t'
          % launches['radius_member_t'])

    run = run_eggbox()
    print('eggbox: logZ %.4f +- %.4f (quadrature %.3f), wall %.3f s, '
          'ncall %d, %.0f evals/s, niter %d' % (
              run['logz'], run['logzerr'], EGGBOX_LOGZ, run['wall_s'],
              run['ncall'], run['evals_per_s'], run['niter']))
    print('eggbox phases (s):', json.dumps(run['phases_s']))
    print('eggbox segment exits:', json.dumps(run['segment_exits']))
    print('eggbox kernel launches:', json.dumps(run['launches']))
    for name in kernels.REGION_KERNELS:
        launches[name] = run['launches'][name]

    spec = run_asymgauss50()
    print_population_run(spec)
    # K3 runs on every path from here on: its count is the sum of the runs
    launches['consume_scan'] += spec['launches']['consume_scan']

    launch_s, rounds = spec['phases_s']['launch'], spec['rounds']
    for name in ('rosenbrock8', 'multishell8', 'loggamma30', 'gauss100'):
        run = run_population_problem(name)
        print_population_run(run)
        launch_s += run['phases_s']['launch']
        rounds += run['rounds']
        if name == 'rosenbrock8':
            print('rosenbrock8: the JAX package on a TPU gave logZ -42.915 '
                  '+- 0.483 (BENCH_r05.json), an algorithmic yardstick')
        if name == 'gauss100':
            assert run['nsteps_final'] > 100, 'the governor never grew nsteps'
        launches['consume_scan'] += run['launches']['consume_scan']
    print('spec-walk round cost over the five problems: launch %.3f s over '
          '%d rounds, %.4f ms per round (popfused.ROUND_OVERHEAD_S %.4f ms)'
          % (launch_s, rounds, 1e3 * launch_s / rounds,
             1e3 * ROUND_OVERHEAD_S))

    engines = {}
    for name in ('sync', 'async', 'sync8', 'rwalk', 'async_classic'):
        run = engines[name] = run_engine(name)
        print('engine %s: logZ %.4f +- %.4f, wall %.3f s, ncall %d, niter '
              '%d, ncall/niter %.3f, %d dispatches, %d rounds, %d host '
              'reads, scale %.4g' % (
                  name, run['logz'], run['logzerr'], run['wall_s'],
                  run['ncall'], run['niter'], run['ncall_per_iter'],
                  run['dispatches'], run['rounds'], run['reads'],
                  run['scale']))
        print('engine %s segment exits:' % name,
              json.dumps(run['segment_exits']))
        print('engine %s kernel launches:' % name,
              json.dumps(run['launches']))
        for k in kernels.KERNELS:
            if k != 'radius_member_t':
                launches[k] += run['launches'].get(k, 0)
    ratio = engines['async']['ncall_per_iter'] / \
        engines['sync8']['ncall_per_iter']
    print('async vs sync on asymgauss8: ncall/niter %.3f vs %.3f, ratio %.3f '
          '(the JAX package asserts < 0.7)' % (
              engines['async']['ncall_per_iter'],
              engines['sync8']['ncall_per_iter'], ratio))
    assert ratio < 0.7, ('async not cheaper than sync', ratio)
    print('chip_smoke: every phase passed in %.1f s' % (time.time() - t_start))

    print(json.dumps({'kernels': [
        dict(name=name, route='cuda', source=KERNEL_NOTES[name][0],
             replaces=KERNEL_NOTES[name][1], launches=launches[name],
             max_abs_err=errs[name], ms=times[name][0],
             plain_ms=times[name][1])
        for name in kernels.KERNELS]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
