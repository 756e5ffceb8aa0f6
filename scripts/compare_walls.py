#!/usr/bin/env python3
"""Population-run walls of several checkouts, in turns, on one CUDA card.

Each ``--source NAME=PATH`` is the root of a checkout (this one, ``.``,
or another commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists). For each problem of ``--problems`` (names of
``chip_smoke.POPULATION_PROBLEMS``, run by
``chip_smoke.run_population_problem``, or of ``chip_smoke.ENGINE_RUNS``,
run by ``chip_smoke.run_engine``; default asymgauss50 and gauss100), the
sources run in the order A B ... B A, each run in a fresh process that
imports that checkout's ``chip_smoke`` and ``ultranest_torch`` (its
kernels built from its own sources, before the run's clock starts).
``--sync-check-every N ...`` runs each source once per N with
``popfused.SYNC_CHECK_EVERY`` set to N (the order N1 ... Nk Nk ... N1).
With ``--warm`` each process runs its problem once before the timed run
(the first run in a process carries the card's and the libraries'
start-up).
Each run prints one JSON line: source, problem, turn, wall, ncall,
niter, logZ and the run's walk counts (a population problem: launch
seconds and rounds; an engine: dispatches, rounds, host reads and, where
the checkout logs them, replays and ms a round). ``--out FILE`` also
writes them all as a JSON list.

Run from the repository root on a CUDA machine::

    python3 scripts/compare_walls.py --source parent=_parent \\
        --source change=. [--problems asymgauss50 gauss100] [--out F]
    python3 scripts/compare_walls.py --source change=. --warm \\
        --problems sync sync8 --sync-check-every 2 4 8 16
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
from ultranest_torch import popfused
from ultranest_torch.ops import kernels
kernels.build()
if sys.argv[2] != '-':
    popfused.SYNC_CHECK_EVERY = int(sys.argv[2])
engine = sys.argv[1] in chip_smoke.ENGINE_RUNS
runner = chip_smoke.run_engine if engine \
    else chip_smoke.run_population_problem
for _ in range(int(sys.argv[3])):
    runner(sys.argv[1])
run = runner(sys.argv[1])
if engine:
    keys = ('wall_s', 'ncall', 'niter', 'logz', 'logzerr', 'dispatches',
            'rounds', 'reads', 'replays', 'ms_per_round')
    out = {k: run[k] for k in keys if k in run}
else:
    out = {k: run[k] for k in (
        'wall_s', 'ncall', 'niter', 'logz', 'logzerr', 'dispatches',
        'rounds', 'launch_ms_per_round')}
    out['launch_s'] = run['phases_s'].get('launch')
print('RESULT ' + json.dumps(out))
'''


def run_one(path, problem, every='-', warm=False):
    """The summary of one run of *problem* in a fresh process in *path*
    (with ``SYNC_CHECK_EVERY`` set to *every* unless it is '-'; after an
    untimed run of it where *warm*)."""
    proc = subprocess.run([sys.executable, '-c', CHILD, problem, str(every),
                           str(int(warm))], cwd=path, capture_output=True,
                          text=True, timeout=1800)
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
    ap.add_argument('--sync-check-every', nargs='+', type=int)
    ap.add_argument('--warm', action='store_true')
    ap.add_argument('--out')
    args = ap.parse_args(argv)
    sources = [s.split('=', 1) for s in args.source]
    sources = [(name, path, every) for name, path in sources
               for every in (args.sync_check_every or ['-'])]
    order = sources + sources[::-1]
    rows = []
    for problem in args.problems:
        for i, (name, path, every) in enumerate(order):
            row = dict(source=name, problem=problem, turn=i + 1,
                       sync_check_every=every, warm=args.warm,
                       **run_one(os.path.abspath(path), problem, every,
                                 args.warm))
            print(json.dumps(row), flush=True)
            rows.append(row)
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == '__main__':
    main()
