#!/usr/bin/env python3
"""Population-run walls of several checkouts, in turns, on one CUDA card.

Each ``--source NAME=PATH`` is the root of a checkout (this one, ``.``,
or another commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists). For each problem of ``--problems`` (names of
``chip_smoke.POPULATION_PROBLEMS``; default asymgauss50 and gauss100),
the sources run in the order A B ... B A, each run in a fresh process
that imports that checkout's ``chip_smoke`` and ``ultranest_torch``
(its kernels built from its own sources, before the run's clock starts)
and calls ``chip_smoke.run_population_problem``. Each run prints one
JSON line: source, problem, turn, wall, ncall, niter, logZ, launch
seconds and rounds. ``--out FILE`` also writes them all as a JSON list.

Run from the repository root on a CUDA machine::

    python3 scripts/compare_walls.py --source parent=_parent \\
        --source change=. [--problems asymgauss50 gauss100] [--out F]
"""

import argparse
import json
import os
import subprocess
import sys

CHILD = r'''
import json, sys
sys.path.insert(0, '.')
import chip_smoke
from ultranest_torch.ops import kernels
kernels.build()
run = chip_smoke.run_population_problem(sys.argv[1])
print('RESULT ' + json.dumps({k: run[k] for k in (
    'wall_s', 'ncall', 'niter', 'logz', 'logzerr', 'dispatches', 'rounds',
    'launch_ms_per_round')} | {'launch_s': run['phases_s'].get('launch')}))
'''


def run_one(path, problem):
    """The summary of one run of *problem* in a fresh process in *path*."""
    proc = subprocess.run([sys.executable, '-c', CHILD, problem], cwd=path,
                          capture_output=True, text=True, timeout=1800)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
        raise RuntimeError('run failed: %s %s' % (path, problem))
    line = [x for x in proc.stdout.splitlines() if x.startswith('RESULT ')]
    return json.loads(line[-1][len('RESULT '):])


def main(argv=None):
    """Runs the comparison; returns the list of run summaries."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--source', action='append', required=True,
                    help='NAME=PATH of a checkout root')
    ap.add_argument('--problems', nargs='+',
                    default=['asymgauss50', 'gauss100'])
    ap.add_argument('--out')
    args = ap.parse_args(argv)
    sources = [s.split('=', 1) for s in args.source]
    order = sources + sources[::-1]
    rows = []
    for problem in args.problems:
        for i, (name, path) in enumerate(order):
            row = dict(source=name, problem=problem, turn=i + 1,
                       **run_one(os.path.abspath(path), problem))
            print(json.dumps(row), flush=True)
            rows.append(row)
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == '__main__':
    main()
