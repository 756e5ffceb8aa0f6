"""The window of fits: cells and configurations by name, the fits back to
back, the comparison with the reference and the result line.

A cell (``workloads/<cell>.json``) names its configuration
(``configs/<config>.json``), which names its problem: the sampler's
inputs in ``problems/<problem>.py`` and the plain reference in
``reference/<problem>.py``. Per-layer metrics are read by
``metrics/<metric>.py``. Nothing here is particular to one cell.
"""

import contextlib
import importlib.util
import json
import logging
import os
import sys
import time

import numpy as np

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
WARMUP_SEED = 1
# the traced window's length at most: the profiler's own processing
# grows with the device's events (about 1.8 million in 33 s of
# asymgauss50, 40 s to read on the H100 machine), and a traced run has
# to end within its allowance as any run
TRACE_SECONDS = 12.0
# where check_seeds draws from, apart from any pool's fit_seed(seed, j)
CHECK_STREAM = 2 ** 40


def load_json(*parts):
    """A JSON file under the benchmark's folder."""
    with open(os.path.join(BENCH_DIR, *parts)) as f:
        return json.load(f)


def load_module(kind, name):
    """``<kind>/<name>.py`` of the benchmark's folder, imported by path
    (names hold dots, so they are no module names)."""
    path = os.path.join(BENCH_DIR, kind, name + '.py')
    spec = importlib.util.spec_from_file_location(
        'portbench.%s.%s' % (kind, name.replace('.', '_')), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name):
    """(workload, configuration) of cell *name*."""
    workload = load_json('workloads', name + '.json')
    config = load_json('configs', workload['config'] + '.json')
    return workload, config


def benchmark_spec():
    """``BENCHMARK.json`` at the root of the checkout."""
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


def fit_seed(seed, i):
    """A sampler seed below 2**31 drawn from (*seed*, *i*), for any whole
    number *seed*."""
    ss = np.random.SeedSequence([int(seed) % 2 ** 64, int(i)])
    return int(ss.generate_state(1, dtype=np.uint32)[0] & 0x7FFFFFFF)


def check_seeds(seed, n):
    """The sampler seeds of the *n* fits that a run with *seed* makes
    after its window, untimed, to be judged with the window's: drawn
    from *seed*, so that every run judges fits of its own."""
    return [fit_seed(seed, CHECK_STREAM + i) for i in range(n)]


class FitOrder:
    """The sampler seeds of a run's fits. The cell's pool of fits
    (``fit_pool``: *size* sampler seeds drawn from its *seed*) is the
    same for every run; a run with *seed* makes it in cycles, each in the
    order of a permutation drawn from (*seed*, cycle). So every run does
    the same work, in another order."""

    def __init__(self, pool, seed):
        self.pool = [fit_seed(pool['seed'], j) for j in range(pool['size'])]
        self.seed = seed
        self._perm = {}

    def __call__(self, i):
        cycle, j = divmod(i, len(self.pool))
        if cycle not in self._perm:
            rng = np.random.default_rng(np.random.SeedSequence(
                [int(self.seed) % 2 ** 64, cycle]))
            self._perm[cycle] = rng.permutation(len(self.pool))
        return self.pool[self._perm[cycle][j]]


def quiet_sampler_log():
    """The sampler's logger writes to stdout unless a handler exists:
    send warnings to stderr and nothing else, so that the last line of
    stdout is the result."""
    log = logging.getLogger('ultranest_torch')
    if not log.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setLevel(logging.WARNING)
        log.addHandler(h)
    log.setLevel(logging.WARNING)


class Fitter:
    """Builds and runs one fit of a cell's configuration: a new
    ``ReactiveNestedSampler`` each time, as a user fitting a catalog of
    sources builds one sampler a source."""

    def __init__(self, workload, config, device='cuda', force_segment=False):
        import torch
        self.torch = torch
        self.workload, self.config = workload, config
        self.device = device
        # on the CPU the segment path is off unless forced (tests only)
        self.force_segment = force_segment
        prob = load_module('problems', config['problem'])
        self.inputs = prob.make(device, **config['problem_args'])
        quiet_sampler_log()

    def _span(self, name, spans):
        if spans:
            return self.torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def fit(self, seed, spans=False):
        """One converged fit with sampler seed *seed*; returns its record.
        With *spans*, ``torch.profiler.record_function`` marks building
        the sampler, ``run()`` and reading the results."""
        import ultranest_torch
        from ultranest_torch import mlfriends, popfused
        cfg, inp, dev = self.config, self.inputs, self.device
        t0 = time.perf_counter()
        with self._span('fit.build', spans):
            kw = dict(param_names=inp['param_names'], loglike=inp['loglike'],
                      transform=inp['transform'], vectorized=True, seed=seed,
                      device=dev, **cfg['sampler'])
            if cfg['sampler_likelihood']:
                kw.update(torch_loglike=inp['torch_loglike'],
                          torch_transform=inp['torch_transform'])
            sampler = ultranest_torch.ReactiveNestedSampler(**kw)
            if self.force_segment and sampler.fused_sampler is not None:
                sampler.fused_sampler.segment_enabled = True
            if cfg['transform_layer']:
                sampler.transform_layer_class = getattr(
                    mlfriends, cfg['transform_layer'])
            ss = None
            if cfg['stepsampler']:
                cls = getattr(popfused, cfg['stepsampler']['class'])
                ss = sampler.stepsampler = cls(
                    torch_loglike=inp['torch_loglike'],
                    torch_transform=inp['torch_transform'], seed=seed,
                    device=dev, **cfg['stepsampler']['kwargs'])
            run_kw = dict(self.workload['run'], **cfg['run'])
            if cfg['region']:
                run_kw['region_class'] = getattr(mlfriends, cfg['region'])
        with self._span('fit.run', spans):
            res = sampler.run(viz_callback=False, show_status=False,
                              **run_kw)
            if dev != 'cpu':
                self.torch.cuda.synchronize()
        with self._span('fit.results', spans):
            ws = res['weighted_samples']
            rec = dict(
                seed=seed, ncall=int(res['ncall']), niter=int(res['niter']),
                logz=float(res['logz']), logzerr=float(res['logzerr']),
                upoints=np.array(ws['upoints'], dtype=np.float64),
                points=np.array(ws['points'], dtype=np.float64),
                logl=np.array(ws['logl'], dtype=np.float64),
                logw=np.array(ws['logw'], dtype=np.float64),
                samples=np.array(res['samples'], dtype=np.float64),
                phases=dict(getattr(sampler, '_segment_phase_s', {}) or {}),
                segment_exits=dict(getattr(sampler, '_segment_exits', {})
                                   or {}))
            if ss is not None:
                walks = getattr(ss, 'walk_log', [])
                rec.update(ss_ncalls=int(ss.ncalls),
                           ss_useful=int(ss.ncalls_useful),
                           spec_depth=int(getattr(ss, 'spec_depth', 0)),
                           spec_probe=getattr(ss, 'spec_probe', None),
                           walks=len(walks),
                           captures=sum(w.get('captures', 0) for w in walks),
                           capture_s=sum(w.get('capture_s', 0.0)
                                         for w in walks))
        rec['wall_s'] = time.perf_counter() - t0
        return rec


def run_window(fitter, seed, seconds, spans=False, fail_log=None):
    """Fits back to back in the order of :class:`FitOrder`, started until
    *seconds* have passed and the last cycle of the pool is whole; the
    window ends when the last fit ends. Returns (records, attempted,
    failed, window seconds)."""
    order = FitOrder(fitter.workload['fit_pool'], seed)
    fits, attempted, failed = [], 0, 0
    t0 = time.perf_counter()
    while attempted % len(order.pool) or \
            time.perf_counter() - t0 < seconds:
        s = order(attempted)
        attempted += 1
        try:
            fits.append(fitter.fit(s, spans=spans))
        except Exception as exc:     # a fit that fails counts as failed
            failed += 1
            if fail_log is not None:
                fail_log.append('fit %d (seed %d): %s: %s'
                                % (attempted - 1, s, type(exc).__name__, exc))
    return fits, attempted, failed, time.perf_counter() - t0


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    bad = {'jax', 'jaxlib', 'flax', 'ultranest_tpu'}
    return sorted({m.split('.')[0] for m in list(sys.modules)} & bad)


def run_cell(name, workload, config, spec, seed, seconds, trace, chips=1,
             started=None, power_limit=None, device='cuda',
             force_segment=False):
    """Set-up, the window and the comparison of cell *name*; returns (the
    result line's object, the compared numbers as (name, value, limit),
    lines for standard error). *started* is (``time.perf_counter()``,
    the process's age in seconds) read at the process's start, from
    which ``setup_s`` counts. *device* 'cpu' and *force_segment* serve
    the tests, which drive a run without a card."""
    import importlib

    import torch

    from . import check
    on_card = device != 'cpu'
    if started is None:
        started = (time.perf_counter(), 0.0)

    # set-up: the kernels, then one fit at the cell's own settings
    marks = [('imports', time.perf_counter())]
    if on_card:
        from ultranest_torch.ops import kernels
        kernels.build()
    marks.append(('kernels', time.perf_counter()))
    fitter = Fitter(workload, config, device=device,
                    force_segment=force_segment)
    marks.append(('inputs', time.perf_counter()))
    warm = fitter.fit(WARMUP_SEED)
    marks.append(('warm-up fit', time.perf_counter()))
    profiler = None
    if trace:
        from . import trace as tracing
        profiler = tracing.Profiler(on_card)
    if on_card:
        torch.cuda.synchronize()
    setup_s = started[1] + time.perf_counter() - started[0]
    marks.append(('profiler', time.perf_counter()))

    failures = []
    if profiler is not None:
        with profiler:
            fits, attempted, failed, window_s = run_window(
                fitter, seed, min(seconds, TRACE_SECONDS), spans=True,
                fail_log=failures)
    else:
        fits, attempted, failed, window_s = run_window(
            fitter, seed, seconds, fail_log=failures)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    tr = profiler.result() if profiler is not None else None
    # fits drawn from the seed, outside the window: judged with its own
    checked, check_failed = [], 0
    for s in check_seeds(seed, workload.get('check_fits', 0)):
        try:
            checked.append(fitter.fit(s))
        except Exception as exc:     # as a fit of the window
            check_failed += 1
            failures.append('check fit (seed %d): %s: %s'
                            % (s, type(exc).__name__, exc))

    device_info = dict(
        platform='gpu' if on_card else 'cpu',
        kind=torch.cuda.get_device_name(0) if on_card else 'cpu',
        count=chips, memory_peak_bytes=int(peak),
        power_limit_w=power_limit)
    result = dict(correct=False, attempted=attempted, failed=failed)
    messages = failures[:5]
    steps = ['%s %.3f' % (marks[0][0], started[1] + marks[0][1] - started[0])]
    steps += ['%s %.3f' % (b[0], b[1] - a[1])
              for a, b in zip(marks, marks[1:])]
    messages.append('set-up s: %s; warm-up phases %s, graph captures %s '
                    '(%.3f s), spec probe %s' % (
                        ', '.join(steps),
                        {k: round(v, 3) for k, v in warm['phases'].items()},
                        warm.get('captures'), warm.get('capture_s', 0.0),
                        warm.get('spec_probe')))
    breakdown = None
    metrics = {}
    if tr is None:
        if fits:
            metrics['fit_s'] = dict(value=window_s / len(fits), unit='s')
        metrics['setup_s'] = dict(value=setup_s, unit='s')
    else:
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        run = _Run(fits, tr, config, workload)
        for m in spec['per_layer']:
            if name not in m.get('workloads', [name]):
                continue
            v = load_module('metrics', m['name']).read(run)
            if v is not None:
                metrics[m['name']] = dict(value=float(v), unit=m['unit'])
        breakdown = dict(device_ops=tr.device_ops(),
                         idle_gaps=tr.idle_gaps())
        for kname, k in sorted(tr.kernels.items()):
            messages.append(
                'kernel %s: %d executions (%d launched, %d captured), '
                'device %.6f s, bound %s s' % (
                    kname, k['executions'], k['launched'], k['captured'],
                    k['device_s'], k['bound_s']))

    # the window is closed and the peak read: free the program's state,
    # then judge every fit against the reference
    del fitter, profiler
    if on_card:
        torch.cuda.empty_cache()
    ref = importlib.import_module('portbench.reference.' + config['problem'])
    truth = ref.truth(**config['problem_args'])
    nums = check.numbers(fits + checked, config, ref, truth)
    ok, rows = check.judge(nums, config['limits'])
    result['correct'] = bool(ok and failed == 0 and check_failed == 0
                             and len(fits) > 0)
    result['metrics'] = metrics
    result['device'] = device_info
    if breakdown is not None:
        result['breakdown'] = breakdown
    if tr is not None:
        messages.append('trace: %(count)d events, profiler stop %(stop).1f s, '
                        'events %(events).1f s, reduction %(reduce).1f s'
                        % tr.reduce_s)
    messages.append('fit walls: %s' % ' '.join(
        '%.3f' % f['wall_s'] for f in fits))
    messages.append(
        'fits %d, attempted %d, failed %d, window %.3f s, setup %.3f s, '
        'ncall %s (most %s), spec depth %s; after the window %d fits '
        'judged, %d failed' % (
            len(fits), attempted, failed, window_s, setup_s,
            [f['ncall'] for f in fits][:4],
            max([f['ncall'] for f in fits + checked], default=None),
            sorted({f.get('spec_depth') for f in fits} - {None}),
            len(checked), check_failed))
    result['checks'] = {k: dict(value=_finite(v), limit=lim)
                        for k, v, lim in rows}
    return result, rows, messages


def _finite(v):
    """*v*, or None where it is no finite number (JSON has none)."""
    import math
    return v if math.isfinite(v) else None


class _Run:
    """What a per-layer metric's reader reads."""

    def __init__(self, fits, trace, config, workload):
        self.fits, self.trace = fits, trace
        self.config, self.workload = config, workload
