#!/usr/bin/env python3
"""Seconds a fit of every key of the port's spans, untraced and traced.

For each ``--cell`` of ``BENCHMARK.json`` (``portbench/workloads/``),
in one process: the kernels, one warm-up fit, then a window of fits of
the cell's pool, back to back as the benchmark runs them, for
``--seconds`` without a profiler, then again for at most 12 s under the
benchmark's ``torch.profiler`` (``portbench.trace.Profiler``). Each
fit's ``sampler._segment_phase_s`` is summed over its window and
divided by the window's fits. Printed per cell and mode: each top-level
phase, and each child of ``launch`` and ``improve`` with its share of
the phase and the share the children reach together. ``--out FILE``
writes every key's seconds and counts a fit, and each fit's seed,
ncall, niter and logZ, as JSON.

Run from the repository root on a CUDA machine::

    python3 scripts/phase_split.py --cell asymgauss50.live400 \\
        --cell eggbox2d.upstream --seconds 30 --out split.json
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import harness, trace  # noqa: E402

SPLIT = ('launch', 'improve', 'classic')


def per_fit(fits):
    """Every key of the fits' spans, summed and divided by the fits."""
    keys = sorted({k for f in fits for k in f['phases']})
    return {k: sum(f['phases'].get(k, 0) for f in fits) / len(fits)
            for k in keys}


def report(cell, mode, nfits, phases):
    print('%s %s: %d fits, fit wall %.4f s' % (
        cell, mode, nfits, phases.get('fit_wall_s', 0.0)))
    for k, v in phases.items():
        if '/' not in k and not k.endswith('#') and k != 'fit_wall_s':
            print('  %-10s %.5f' % (k, v))
    for parent in SPLIT:
        if not phases.get(parent):
            continue
        kids = {k: v for k, v in phases.items() if not k.endswith('#')
                and k.startswith(parent + '/') and k.count('/') == 1}
        print('  %s %.5f, children %.1f%%:' % (
            parent, phases[parent],
            100 * sum(kids.values()) / phases[parent]))
        for k, v in sorted(kids.items(), key=lambda kv: -kv[1]):
            print('    %-18s %.5f %5.1f%% (%g calls)' % (
                k, v, 100 * v / phases[parent], phases.get(k + '#', 0)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--cell', action='append', required=True)
    ap.add_argument('--seconds', type=float, default=30.0)
    ap.add_argument('--seed', type=int, default=1)
    ap.add_argument('--out')
    args = ap.parse_args()
    import torch

    from ultranest_torch.ops import kernels
    kernels.build()
    out = {}
    for cell in args.cell:
        workload, config = harness.load_cell(cell)
        fitter = harness.Fitter(workload, config)
        fitter.fit(harness.WARMUP_SEED)
        torch.cuda.synchronize()
        for mode in ('untraced', 'traced'):
            if mode == 'traced':
                with trace.Profiler(on_card=True):
                    fits, _, failed, window = harness.run_window(
                        fitter, args.seed, min(args.seconds,
                                               harness.TRACE_SECONDS),
                        spans=True)
            else:
                fits, _, failed, window = harness.run_window(
                    fitter, args.seed, args.seconds)
            phases = dict(per_fit(fits), fit_wall_s=window / len(fits))
            report(cell, mode, len(fits), phases)
            out['%s %s' % (cell, mode)] = dict(
                fits=len(fits), failed=failed, phases=phases,
                results=[(f['seed'], f['ncall'], f['niter'], f['logz'])
                         for f in fits])
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(dict(device=torch.cuda.get_device_name(0),
                           cells=out), f, indent=1)


if __name__ == '__main__':
    main()
