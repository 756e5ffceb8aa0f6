"""Readings that the limits of ``check.py`` are set from: the program's
numbers and the control's on many seeds, in one process.

    python3 portbench/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--fault <name>] [--out FILE]

Set-up as a benchmark run's, then for each seed a window of the cell's
own load (fits back to back for *s* seconds, the pool of fits drawn
from the seed too, so that every seed reads fits of its own). Each
window's fits are judged by the reference in float64 (the program's readings) and by the
reference in each lower precision put in the program's place at the
same points (the control's readings: the configuration's device
likelihood is float32, so its control is bfloat16; float32 is read
too). One JSON line a seed, and the largest program reading and the
smallest control reading of each number at the end. With ``--fault``,
each window runs with that fault of ``faults.py`` planted (a window past
``FAULT_DEADLINE_S`` gives no number) and a line a seed gives the
program's readings and whether the run would read ``correct``. The
benchmark's own runs never run this.
"""

import json
import os
import sys
import time

FAULT_DEADLINE_S = 180.0
_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)


def readings(name, seeds, seconds, device='cuda', workload=None,
             config=None, force_segment=False, emit=print, fault=None):
    """Per seed: the program's numbers and each control's, or with
    *fault* the program's under that fault; returns the list of per-seed
    dicts. Each seed also draws the pool of fits (``fit_pool``), so that
    every seed reads fits of its own."""
    import contextlib
    import importlib

    from portbench import check, faults, harness
    if workload is None:
        workload, config = harness.load_cell(name)
    if device != 'cpu':
        from ultranest_torch.ops import kernels
        kernels.build()
    fitter = harness.Fitter(workload, config, device=device,
                            force_segment=force_segment)
    fitter.fit(harness.WARMUP_SEED)
    ref = importlib.import_module('portbench.reference.' + config['problem'])
    truth = ref.truth(**config['problem_args'])
    out = []
    pool = fitter.workload['fit_pool']
    for seed in seeds:
        t0 = time.perf_counter()
        fitter.workload = dict(fitter.workload, fit_pool=dict(pool, seed=seed))
        fail_log = []
        with faults.planted(fault, FAULT_DEADLINE_S) if fault else \
                contextlib.nullcontext():
            fits, attempted, failed, window_s = harness.run_window(
                fitter, seed, seconds, fail_log=fail_log)
        row = dict(seed=seed, fits=len(fits), attempted=attempted,
                   failed=failed, window_s=window_s,
                   ncall=[f['ncall'] for f in fits],
                   program=check.numbers(fits, config, ref, truth))
        if fault:
            ok, _ = check.judge(row['program'], config['limits'])
            row.update(fault=fault, errors=fail_log[:3],
                       correct=bool(ok and failed == 0 and fits))
        else:
            for prec in ('float32', 'bfloat16'):
                row[prec] = check.numbers(fits, config, ref, truth,
                                          control=prec)
        row['judge_s'] = time.perf_counter() - t0 - window_s
        emit(json.dumps(row))
        out.append(row)
    return out


def summary(rows, control='bfloat16'):
    """Largest program reading and smallest control reading per number."""
    from portbench.check import NUMBERS
    return {k: dict(program_max=max(r['program'][k] for r in rows),
                    control_min=min(r[control][k] for r in rows))
            for k in NUMBERS}


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--fault', default=None)
    ap.add_argument('--out', default=None)
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    lines = []

    def emit(line):
        print(line, flush=True)
        lines.append(line)
    rows = readings(a.workload, a.seeds, a.seconds, emit=emit,
                    fault=a.fault)
    if a.fault:
        s = json.dumps(dict(workload=a.workload, fault=a.fault,
                            correct=[r['correct'] for r in rows]))
    else:
        s = json.dumps(dict(workload=a.workload, seconds=a.seconds,
                            summary=summary(rows)))
    print(s)
    if a.out:
        with open(a.out, 'w') as f:
            f.write('\n'.join(lines + [s]) + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
