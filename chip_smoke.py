#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ultranest_torch``) on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. checks for a CUDA device (exit 1 without one) and prints the card's
   name and power limit as ``nvidia-smi`` reports them;
2. builds the four CUDA kernels with nvcc (one compiler per source, all
   started together) and prints the build time;
3. holds each kernel against its plain torch version on the card, at
   the shapes its paths give it, and times both with CUDA events;
4. drives the three paths, each with every kernel count set to 0 just
   before it and read just after it:

   * the membership shootout (``ultranest_torch.evaluate.bench_membership``,
     the path of K1t), at its three shapes;
   * the region-rejection path: the eggbox with the JAX package's bench
     configuration (400 live points, ``bench.py:104-115``) through
     ``ReactiveNestedSampler(..., device='cuda')``, gated on the
     quadrature logZ;
   * the population spec-walk path: asymgauss50 at the bench's full
     width (``bench.py:126-175``: d 50, popsize 4096, nsteps 100, spec
     depth 8, 400 live points), gated on ``|logZ| < max(4 logzerr,
     1.5)`` (``bench.py:356``);

   and checks that each path's kernels were launched in its run;
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


def run_asymgauss50(seed=1):
    """asymgauss50 on the population spec-walk path, at full width.

    Exactly ``bench.py:126-175``: ``asymgauss(ndim=50, sigma_min=0.01)``,
    ``ScalingLayer``, ``FusedPopulationSliceSampler(popsize=4096,
    nsteps=100, spec_depth=8, engine='spec')``, 400 live points,
    ``dlogz=2.0``, ``frac_remain=0.1``, ``SimpleRegion``. Every kernel
    count is set to 0 just before the run and read just after it.
    Raises if logZ is outside the bench gate (``bench.py:356``), the
    samples are malformed, the segment path never engaged or K3 was
    never launched; returns the run's summary.
    """
    import torch
    from ultranest_torch import ReactiveNestedSampler
    from ultranest_torch.mlfriends import ScalingLayer, SimpleRegion
    from ultranest_torch.models.problems import asymgauss
    from ultranest_torch.ops import kernels
    from ultranest_torch.popfused import FusedPopulationSliceSampler
    prob = asymgauss(ndim=50, sigma_min=0.01)
    sampler = ReactiveNestedSampler(
        prob.param_names, prob.loglike, vectorized=True, seed=seed,
        device='cuda')
    sampler.transform_layer_class = ScalingLayer
    ss = sampler.stepsampler = FusedPopulationSliceSampler(
        popsize=4096, nsteps=100, torch_loglike=prob.torch_loglike,
        seed=seed, engine='spec', spec_depth=8, device='cuda')
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
    out = dict(seed=seed, wall_s=wall, ncall=int(res['ncall']),
               ncall_useful=ncall_useful, niter=int(res['niter']),
               logz=float(res['logz']), logzerr=float(res['logzerr']),
               evals_per_s=res['ncall'] / wall,
               useful_evals_per_s=ncall_useful / wall,
               dispatches=len(walks),
               rounds_per_dispatch=[w['rounds'] for w in walks],
               reads_per_dispatch=[w['reads'] for w in walks],
               peak_device_mib=torch.cuda.max_memory_allocated() / 2**20,
               nsteps_final=int(ss.nsteps),
               phases_s=dict(getattr(sampler, '_segment_phase_s', {})),
               segment_exits=dict(getattr(sampler, '_segment_exits', {})),
               launches=dict(kernels.LAUNCHES))
    assert abs(res['logz']) < max(4 * res['logzerr'], 1.5), \
        ('asymgauss50 logZ outside the gate', res['logz'], res['logzerr'])
    assert np.isfinite(res['samples']).all() and \
        res['samples'].shape[1] == 50, 'bad posterior samples'
    assert out['segment_exits'], 'the popfused segment path never engaged'
    assert out['launches'].get('consume_scan', 0) > 0, \
        'K3 was not launched on the spec path'
    return out


def main():
    import torch
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
    for n, nrounds, d in ((400, 30, 2), (2048, 30, 8)):
        err, ms, plain = check_bootstrap_radius(kernels, rng, n, nrounds, d)
        errs['bootstrap_radius'] = max(errs.get('bootstrap_radius', 0.0),
                                       err)
        times.setdefault('bootstrap_radius', (ms, plain))
    err, ms, plain = check_consume_scan(kernels, rng, 512, 1024)
    errs['consume_scan'] = err
    times['consume_scan'] = (ms, plain)
    check_consume_scan(kernels, rng, 512, 4096, all_valid=True)
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
    print('asymgauss50: logZ %.4f +- %.4f (truth 0, gate max(4 logzerr, '
          '1.5)), wall %.3f s, ncall %d, ncall_useful %d, %.0f evals/s, '
          '%.0f useful evals/s, niter %d, %d dispatches, peak device '
          'memory %.1f MiB' % (
              spec['logz'], spec['logzerr'], spec['wall_s'], spec['ncall'],
              spec['ncall_useful'], spec['evals_per_s'],
              spec['useful_evals_per_s'], spec['niter'],
              spec['dispatches'], spec['peak_device_mib']))
    print('asymgauss50 phases (s):', json.dumps(spec['phases_s']))
    print('asymgauss50 segment exits:', json.dumps(spec['segment_exits']))
    print('asymgauss50 rounds per dispatch:',
          json.dumps(spec['rounds_per_dispatch']))
    print('asymgauss50 host reads per dispatch:',
          json.dumps(spec['reads_per_dispatch']))
    print('asymgauss50 kernel launches:', json.dumps(spec['launches']))
    # K3 runs on both main paths: its count is the sum of the two runs
    launches['consume_scan'] += spec['launches']['consume_scan']

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
