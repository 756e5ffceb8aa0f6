"""Run one cell of the port's benchmark on the card and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (counted in ``setup_s``, from the process's start): import torch,
build or load the port's kernels (``ultranest_torch/_build`` inside the
checkout), then one warm-up fit at the cell's settings. The window: fits
back to back, each with a new sampler, started until *s* seconds have
passed and the cell's pool of fits (``fit_pool``, the same for every
run) has been made a whole number of times, each cycle in an order
drawn from *n* (``harness.FitOrder``). ``fit_s`` is the window's wall
over the fits completed. After the window, ``check_fits`` more fits with
sampler seeds drawn from *n* run untimed, and every fit, the window's
and these, is compared with the plain reference (``check.py``). The
last line of standard output is one JSON object; with ``--trace 1`` the
window lasts ``harness.TRACE_SECONDS`` at most (whole cycles of the
pool all the same), runs under ``torch.profiler`` and the metrics are
the per-layer ones.
"""

import os
import sys
import time

_T_TOP = time.perf_counter()


def _process_age_s():
    """Seconds since this process started, from ``/proc`` (the kernel's
    clock ticks), or 0 where that cannot be read."""
    try:
        with open('/proc/self/stat') as f:
            start_ticks = float(f.read().rsplit(')', 1)[1].split()[19])
        with open('/proc/uptime') as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf('SC_CLK_TCK'))
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE_AT_TOP = _process_age_s()
_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
# one process with one host thread a pool: the fits' host work is small
# numpy and torch calls, and idle pool threads spinning on a shared host
# only add noise (set-up read 10.5-11.8 s with one thread, 10.8-18.0 s
# with the default pools on the H100 machine)
for _var in ('OMP_NUM_THREADS', 'MKL_NUM_THREADS', 'OPENBLAS_NUM_THREADS'):
    os.environ[_var] = '1'
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402


def _fail(msg, code=2):
    print(msg, file=sys.stderr)
    sys.exit(code)


def _power_limit():
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=power.limit',
             '--format=csv,noheader,nounits'],
            capture_output=True, text=True, timeout=20).stdout
        return float(out.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    if not os.path.isfile(os.path.join(_ROOT, 'ultranest_torch',
                                       '__init__.py')):
        _fail('no ultranest_torch package beside portbench/: nothing to run')
    from portbench import harness
    try:
        workload, config = harness.load_cell(a.workload)
    except FileNotFoundError as exc:
        _fail('unknown workload %r: %s' % (a.workload, exc))
    spec = harness.benchmark_spec()

    import torch
    if not torch.cuda.is_available():
        _fail('no CUDA device: the benchmark runs on the card only')
    chips = int(workload['chips'])
    if torch.cuda.device_count() < chips:
        _fail('the cell needs %d cards, %d present'
              % (chips, torch.cuda.device_count()))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    result, rows, messages = harness.run_cell(
        a.workload, workload, config, spec, a.seed, a.seconds, a.trace,
        chips, started=(_T_TOP, _AGE_AT_TOP), power_limit=_power_limit())
    bad = harness.forbidden_modules()
    if bad:
        _fail('modules of JAX or the JAX package were loaded: %s'
              % ', '.join(bad), code=3)
    for line in messages:
        print(line, file=sys.stderr)
    for k, v, lim in rows:
        print('check %s %r limit %r' % (k, v, lim), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == '__main__':
    sys.exit(main())
