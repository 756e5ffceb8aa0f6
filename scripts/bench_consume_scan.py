#!/usr/bin/env python3
"""K3, the consume scan, built from several sources and timed side by side.

Builds each given ``consume_scan.cu`` (C entry point ``un_consume_scan``,
as ``ultranest_torch/csrc/consume_scan.cu`` has it) into a shared
library of its own with nvcc, all compilers started together. Then, on
one CUDA card, at each of ``chip_smoke.SCAN_SHAPES`` and on every path's
real calls saved by ``python3 chip_smoke.py --save-traffic FILE``:

* holds each source's live set and records against the plain version
  bit for bit (on real calls: the first, middle and last call against
  the plain version, and every call against the first source);
* times each source as a mean per call, with CUDA events around 50 calls
  (host-paced, as ``chip_smoke.py`` times) and with the calls queued
  behind a spin kernel (``chip_smoke.queued_ms``: the card alone), in
  the order A B ... B A, and prints both passes.

Run from the repository root on a CUDA machine::

    python3 scripts/bench_consume_scan.py \\
        --source parent=PATH/consume_scan.cu \\
        --source change=ultranest_torch/csrc/consume_scan.cu \\
        [--traffic FILE] [--out FILE.json]
"""

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from ultranest_torch.evaluate.bench_membership import cuda_ms  # noqa: E402
from ultranest_torch.ops import kernels  # noqa: E402

REPS = 50


def build(sources):
    """{name: shared library path}, one nvcc per source, in parallel."""
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    procs, out = {}, {}
    for name, src in sources.items():
        with open(src, 'rb') as f:
            h = hashlib.sha256(f.read()).hexdigest()[:16]
        so = os.path.join(kernels.BUILD_DIR, 'scan-%s.so' % h)
        out[name] = so
        if not os.path.exists(so):
            procs[name] = subprocess.Popen(
                [kernels._nvcc()] + kernels.NVCC_FLAGS +
                ['-shared', src, '-o', so], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        log = p.communicate(timeout=600)[0]
        for line in log.splitlines():
            if 'Used' in line or 'spill' in line:
                print('  ptxas %s:' % name, line.strip())
        if p.returncode != 0:
            raise RuntimeError('nvcc failed on %s:\n%s' % (name, log))
    return out


def scan_fn(so):
    """The source's scan as ``kernels.consume_scan`` calls it (no count)."""
    lib = ctypes.CDLL(so)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.un_consume_scan.argtypes = [vp, ci, vp, vp, ci, vp, vp, vp]
    lib.un_consume_scan.restype = ci

    def fn(live_L, rows_L, rows_valid):
        npad, P = live_L.shape[0], rows_L.shape[0]
        live_L2 = torch.empty_like(live_L)
        recs = torch.empty((P, 5), dtype=torch.float32, device=live_L.device)
        rc = lib.un_consume_scan(
            live_L.data_ptr(), npad, rows_L.data_ptr(), rows_valid.data_ptr(),
            P, live_L2.data_ptr(), recs.data_ptr(),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if rc != 0:
            raise RuntimeError('un_consume_scan failed: cudaError_t %d' % rc)
        return live_L2, recs

    return fn


def same(x, y):
    return all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(x, y))


def time_sources(fns, calls):
    """{name: [(ms, device ms) of each pass]}, passes in the order A B ...
    B A, each a mean per call over *calls* repeated to >= REPS calls."""
    reps = max(1, -(-REPS // len(calls)))
    out = {name: [] for name in fns}
    order = list(fns) + list(fns)[::-1]
    for name in order:
        fn = fns[name]
        run = [lambda c=c: fn(*c) for c in calls] * reps
        ms = cuda_ms(lambda: [f() for f in run], 1) / len(run)
        out[name].append((ms, chip_smoke.queued_ms(run)))
    return out


def report(label, bound_ms, times, extra=''):
    parts = ['%s %s' % (name, ' / '.join('%.4f (device %.4f)' % t
                                          for t in ts))
             for name, ts in times.items()]
    print('%s%s: bound %.6f ms; ms per call, two passes: %s'
          % (label, extra, bound_ms, '; '.join(parts)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--source', action='append', required=True,
                    help='NAME=PATH of a consume_scan.cu')
    ap.add_argument('--traffic', help='file of chip_smoke.py --save-traffic')
    ap.add_argument('--out', help='write the results here as JSON')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('bench_consume_scan: no CUDA device', file=sys.stderr)
        return 1
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    sources = dict(s.split('=', 1) for s in args.source)
    fns = {name: scan_fn(so) for name, so in build(sources).items()}
    results = dict(card=smi.stdout.strip(), shapes=[], traffic={})

    for npad, P, kind in chip_smoke.SCAN_SHAPES:
        a = [torch.as_tensor(x, device='cuda') for x in chip_smoke.scan_inputs(
            np.random.RandomState(npad + P), npad, P, kind)]
        want = kernels.consume_scan_plain(*a)
        for name, fn in fns.items():
            assert same(fn(*a), want), ('records differ', name, npad, P, kind)
        bms, _ = chip_smoke.scan_bound(npad, P, chip_smoke.nseq_of(
            a[2].cpu().numpy()))
        times = time_sources(fns, [a])
        report('K3 npad=%d P=%d %s' % (npad, P, kind), bms, times,
               ' (%d accepted)' % int(want[1][:, 0].sum()))
        results['shapes'].append(dict(npad=npad, P=P, kind=kind,
                                      bound_ms=bms, times=times))

    if args.traffic:
        traffic = torch.load(args.traffic)
        for path, calls in traffic.items():
            calls = [tuple(t.cuda() for t in c) for c in calls]
            ref = list(fns.values())[0]
            for k in sorted({0, len(calls) // 2, len(calls) - 1}):
                want = kernels.consume_scan_plain(*calls[k])
                for name, fn in fns.items():
                    assert same(fn(*calls[k]), want), ('records differ',
                                                       name, path, k)
            firsts = [ref(*c) for c in calls]
            for name, fn in fns.items():
                assert all(same(fn(*c), f) for c, f in zip(calls, firsts)), \
                    ('sources disagree on a real call', name, path)
            nacc = sum(int(f[1][:, 0].sum()) for f in firsts)
            nvalid = sum(int((c[2] > 0.5).sum()) for c in calls)
            bms = float(np.mean([chip_smoke.scan_bound(
                c[0].shape[0], c[1].shape[0],
                chip_smoke.nseq_of(c[2].cpu().numpy()))[0] for c in calls]))
            times = time_sources(fns, calls)
            report('K3 on %s\'s %d real calls' % (path, len(calls)), bms,
                   times, ' (P %s, %d of %d valid rows accepted)' % (
                       sorted({c[1].shape[0] for c in calls}), nacc, nvalid))
            results['traffic'][path] = dict(calls=len(calls), accepted=nacc,
                                            valid_rows=nvalid, bound_ms=bms,
                                            times=times)
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(results, f, indent=1)
    print('bench_consume_scan: done')
    return 0


if __name__ == '__main__':
    sys.exit(main())
