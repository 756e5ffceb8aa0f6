#!/usr/bin/env python3
"""Where a main-path run's time goes in the PyTorch port, on one CUDA card.

Runs one of the main paths of ``chip_smoke.py`` through
``ultranest_torch.ReactiveNestedSampler(device='cuda')``:

* ``--problem eggbox`` (``run_eggbox``): the region-rejection path at
  the JAX package's bench configuration (``bench.py:104-115``, 400 live
  points);
* ``--problem asymgauss50`` (``run_asymgauss50``): the population
  spec-walk path at the bench's full width (``bench.py:126-175``);

as ``--repeats`` timed runs (the first one cold, in a fresh process),
each reporting wall time, ncall, evals/s, logZ and the segment phase
split, then one more run under ``torch.profiler``, reporting device
kernel time by name and the device's busy share of the run's wall time.

Usage: ``python3 scripts/torch_profile.py [--problem eggbox]
[--repeats 3] [--out profile.json]``. Needs a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# run from anywhere: the package and chip_smoke.py sit in the repository
# root
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import run_asymgauss50, run_eggbox  # noqa: E402

RUNS = dict(eggbox=(run_eggbox, 42), asymgauss50=(run_asymgauss50, 1))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--problem', choices=sorted(RUNS), default='eggbox')
    ap.add_argument('--repeats', type=int, default=3)
    ap.add_argument('--out', default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 1
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card)
    run, seed0 = RUNS[args.problem]
    runs = []
    for i in range(args.repeats):
        runs.append(run(seed=seed0 + i))
        print(json.dumps(runs[-1]))

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        profiled = run(seed=seed0)
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType
    # device-side events only: a CPU op's device time repeats its kernels'
    device = sorted(
        ((e.key, e.device_time_total / 1e3, e.count)
         for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.device_time_total > 0),
        key=lambda x: -x[1])
    kernel_ms = sum(ms for key, ms, _ in device
                    if not key.startswith('Memcpy')
                    and not key.startswith('Memset'))
    busy_ms = sum(ms for _, ms, _ in device)
    summary = dict(card=card, problem=args.problem, runs=runs,
                   profiled=profiled,
                   profiled_wall_s=wall,
                   device_busy_ms=busy_ms, device_kernel_ms=kernel_ms,
                   device_busy_share=busy_ms / 1e3 / wall,
                   top_device_ops=[dict(name=k, ms=ms, count=c)
                                   for k, ms, c in device[:25]])
    print('profiled wall %.3f s, device busy %.1f ms (%.2f%%), kernels '
          '%.1f ms' % (wall, busy_ms, 100 * busy_ms / 1e3 / wall,
                       kernel_ms))
    for k, ms, c in device[:25]:
        print('  %9.3f ms  %6d  %s' % (ms, c, k[:90]))
    walls = np.array([r['wall_s'] for r in runs])
    print('wall over %d runs: %s' % (len(walls), walls.tolist()))
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
