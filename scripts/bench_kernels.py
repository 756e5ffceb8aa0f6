#!/usr/bin/env python3
"""One kernel built from several sources and timed side by side.

``--kernel`` names the kernel: ``consume_scan`` (K3), ``radius_member``
(K1), ``radius_member_t`` (K1t), ``bootstrap_radius`` (K2),
``spec_propose`` (K4), ``spec_update`` (K5), ``sync_update`` (K6) or
``rwalk_accept`` (K7). Each ``--source NAME=PATH`` is a source file with
that kernel's C entry point (``un_consume_scan``, ``un_radius_member``,
``un_radius_member_t``, ``un_bootstrap_radius``, ``un_spec_propose``,
``un_spec_update``, ``un_sync_update``, ``un_rwalk_accept``), e.g.
the file of another commit taken from a ``git archive``; a header it
includes lies beside it. Each is built into a shared library of its own
with nvcc, all compilers started together. ``--legacy NAME`` marks a
source with the entry point of before the redesign of K1, K1t and K2 (no
group argument, no scratch argument), of K4 (no vector width), of K6
(no form, no tick) or of K7 (no next proposal: torch's multiply and add
write it after the kernel, as the walk did).
Then, on one CUDA card, at each of the kernel's shapes in
``chip_smoke.py`` (``SCAN_SHAPES``, ``MEMBER_SHAPES``,
``BOOTSTRAP_SHAPES``, ``SPEC_SHAPES``: K5 also beside an empty kernel;
K6 at ``SYNC_SHAPES`` and a sweep of P and d, inside a step and at a
step boundary, each form of a source that takes one, and K7 at
``RWALK_SHAPES``, a step with its next proposal, both only among 50
calls in a CUDA graph, as the walks run them, beside an empty kernel;
K1t: the membership shootout's shapes, at ``r2 =
4 d`` and at the candidates' median nearest distance, beside the
package's K1, and each group size of a source that takes one) and on
every path's real calls saved by ``python3 chip_smoke.py --save-traffic
FILE`` (no sampler path calls K1t):

* holds each source's result against the plain version (K3 and K2 bit
  for bit; K1 at 9 boundary radii per shape; on real calls K1 and K2 on
  every call, K3 on the first, middle and last call against the plain
  version and on every call against the first source);
* times each source as a mean per call, with CUDA events around at
  least 50 calls (host-paced, as ``chip_smoke.py`` times) and with the
  calls queued behind a spin kernel (``chip_smoke.queued_ms``: the card
  alone), in the order A B ... B A, and prints both passes; K1's real
  calls also by candidate count M.

``--host-floor`` instead splits the host time of one call of the
package's own K1 and K2 wrappers into the checks, ``torch.empty``, the
stream lookup and the ctypes call (host clock, 1000 calls each).

Run from the repository root on a CUDA machine::

    python3 scripts/bench_kernels.py --kernel radius_member \\
        --source parent=PATH/radius_member.cu --legacy parent \\
        --source change=ultranest_torch/csrc/radius_member.cu \\
        [--traffic FILE] [--out FILE.json]
"""

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from ultranest_torch.evaluate.bench_membership import (  # noqa: E402
    boundary_radii, cuda_ms)
from ultranest_torch.ops import kernels  # noqa: E402

REPS = 50
VP, CI, CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
same = chip_smoke.bits_equal


def build(sources):
    """{name: shared library path}, one nvcc per source, in parallel."""
    out_dir = kernels.build_dir(kernels.BUILD_DIR)
    procs, out = {}, {}
    for name, src in sources.items():
        h = hashlib.sha256()
        folder = os.path.dirname(os.path.abspath(src))
        for path in [src] + [os.path.join(folder, f) for f in kernels.HEADERS]:
            if os.path.exists(path):
                with open(path, 'rb') as f:
                    h.update(f.read())
        so = os.path.join(out_dir, 'bench-%s.so' % h.hexdigest()[:16])
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


def _stream():
    return VP(torch.cuda.current_stream().cuda_stream)


def _check_rc(name, rc):
    if rc != 0:
        raise RuntimeError('%s failed: cudaError_t %d' % (name, rc))


def scan_fn(so, legacy=False):
    """The source's K3 as ``kernels.consume_scan`` calls it (no count)."""
    fn = ctypes.CDLL(so).un_consume_scan
    fn.argtypes, fn.restype = [VP, CI, VP, VP, CI, VP, VP, VP], CI

    def call(live_L, rows_L, rows_valid):
        npad, P = live_L.shape[0], rows_L.shape[0]
        live_L2 = torch.empty_like(live_L)
        recs = torch.empty((P, 5), dtype=torch.float32, device=live_L.device)
        _check_rc('un_consume_scan', fn(
            live_L.data_ptr(), npad, rows_L.data_ptr(), rows_valid.data_ptr(),
            P, live_L2.data_ptr(), recs.data_ptr(), _stream()))
        return live_L2, recs

    return call


def member_fn(so, legacy=False):
    """The source's K1 as ``kernels.radius_member`` calls it (no count)."""
    fn = ctypes.CDLL(so).un_radius_member
    fn.argtypes = [VP, VP, CI, VP, CI, CI, CF] + ([] if legacy else [CI]) \
        + [VP, VP]
    fn.restype = CI

    def call(tpoints, tmask, cands, r2):
        (n, d), m = tpoints.shape, cands.shape[0]
        out = torch.empty(m, dtype=torch.int32, device=cands.device)
        group = [] if legacy else [kernels.member_group_size(m, n, d)]
        _check_rc('un_radius_member', fn(
            tpoints.data_ptr(), tmask.data_ptr(), n, cands.data_ptr(), m, d,
            CF(r2), *group, out.data_ptr(), _stream()))
        return out

    return call


def member_t_fn(so, legacy=False, group=None):
    """The source's K1t as ``kernels.radius_member_t`` calls it (no
    count); *group* forces the lanes a candidate."""
    fn = ctypes.CDLL(so).un_radius_member_t
    fn.argtypes = [VP, VP, CI, VP, CI, CI, CF] + ([] if legacy else [CI]) \
        + [VP, VP]
    fn.restype = CI

    def call(tp_t, tm, cd_t, r2):
        (d, n), m = tp_t.shape, cd_t.shape[1]
        out = torch.empty(m, dtype=torch.int32, device=cd_t.device)
        g = [] if legacy else [group or kernels.member_group_size(m, n, d)]
        _check_rc('un_radius_member_t', fn(
            tp_t.data_ptr(), tm.data_ptr(), n, cd_t.data_ptr(), m, d,
            CF(r2), *g, out.data_ptr(), _stream()))
        return out

    call.so, call.legacy = so, legacy
    return call


def bootstrap_fn(so, legacy=False):
    """The source's K2 as ``kernels.bootstrap_radius`` calls it."""
    fn = ctypes.CDLL(so).un_bootstrap_radius
    fn.argtypes = [VP, VP, VP, CI, CI, CI] + ([] if legacy else [VP]) \
        + [VP, VP]
    fn.restype = CI

    def call(tpoints, valid, masks):
        (npad, d), nrounds = tpoints.shape, masks.shape[0]
        out = torch.empty((), dtype=torch.float32, device=tpoints.device)
        scratch = [] if legacy else [torch.empty(
            -(-nrounds // 32) * npad, dtype=torch.int32,
            device=tpoints.device).data_ptr()]
        _check_rc('un_bootstrap_radius', fn(
            tpoints.data_ptr(), valid.data_ptr(), masks.data_ptr(), npad,
            nrounds, d, *scratch, out.data_ptr(), _stream()))
        return out

    return call


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
          % (label, extra, bound_ms, '; '.join(parts)), flush=True)


def bench_scan(fns, traffic, results):
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
    for path, calls in traffic.items():
        ref = list(fns.values())[0]
        for k in sorted({0, len(calls) // 2, len(calls) - 1}):
            want = kernels.consume_scan_plain(*calls[k])
            for name, fn in fns.items():
                assert same(fn(*calls[k]), want), ('records differ', name,
                                                   path, k)
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


def bench_member(fns, traffic, results):
    rng = np.random.RandomState(0)
    for npad, m, d in chip_smoke.MEMBER_SHAPES:
        (tp, tm, cd), nvalid = chip_smoke.member_inputs(rng, npad, m, d)
        r2s, _ = boundary_radii(tp[:nvalid], cd, nradii=9)
        for r2 in r2s:
            want = kernels.radius_member_plain(tp, tm, cd, r2)
            for name, fn in fns.items():
                assert torch.equal(fn(tp, tm, cd, r2), want), \
                    ('membership differs', name, npad, m, d, r2)
        call = (tp, tm, cd, r2s[len(r2s) // 2])
        bms = chip_smoke.member_call_bound(kernels, call)
        times = time_sources(fns, [call])
        report('K1 npad=%d M=%d d=%d' % (npad, m, d), bms, times)
        results['shapes'].append(dict(npad=npad, m=m, d=d, bound_ms=bms,
                                      times=times))
    for path, calls in traffic.items():
        for k, c in enumerate(calls):
            want = kernels.radius_member_plain(*c)
            for name, fn in fns.items():
                assert torch.equal(fn(*c), want), \
                    ('membership differs on a real call', name, path, k)
        bounds = [chip_smoke.member_call_bound(kernels, c) for c in calls]
        times = time_sources(fns, calls)
        report('K1 on %s\'s %d real calls' % (path, len(calls)),
               float(np.mean(bounds)), times)
        res = results['traffic'][path] = dict(
            calls=len(calls), bound_ms=float(np.mean(bounds)), times=times,
            by_m={})
        for m in sorted({c[2].shape[0] for c in calls}):
            idx = [k for k, c in enumerate(calls) if c[2].shape[0] == m]
            bms = float(np.mean([bounds[k] for k in idx]))
            times = time_sources(fns, [calls[k] for k in idx])
            report('K1 on %s\'s %d real calls of M %d'
                   % (path, len(idx), m), bms, times)
            res['by_m'][m] = dict(calls=len(idx), bound_ms=bms, times=times)


def bench_member_t(fns, traffic, results):
    """K1t at the membership shootout's shapes, at both radii; the
    package's row-major K1 on the same numbers beside it (its operands
    laid out row-major)."""
    from ultranest_torch.evaluate import bench_membership
    for npts, m, d in bench_membership.SHAPES:
        tp, tm, cd, r2 = bench_membership.make_inputs(npts, m, d)
        tp, tm, cd = (torch.as_tensor(a, device='cuda') for a in (tp, tm, cd))
        tp_t, cd_t = tp.T.contiguous(), cd.T.contiguous()
        r2s, _ = boundary_radii(tp, cd, nradii=9)
        for r in r2s:
            want = kernels.radius_member_t_plain(tp_t, tm, cd_t, r)
            for name, fn in fns.items():
                assert torch.equal(fn(tp_t, tm, cd_t, r), want), \
                    ('membership differs', name, npts, m, d, r)

        def k1(tp_t, tm, cd_t, r):
            return kernels.radius_member(tp, tm, cd, r)

        both = dict(fns, K1=k1)
        for label, r in (('r2 = 4 d', float(r2)),
                         ('median radius', r2s[len(r2s) // 2])):
            bms = chip_smoke.member_call_bound(kernels, (tp, tm, cd, r))
            times = time_sources(both, [(tp_t, tm, cd_t, r)])
            report('K1t N=%d M=%d d=%d at %s' % (npts, m, d, label), bms,
                   times)
            results['shapes'].append(dict(npts=npts, m=m, d=d, radius=label,
                                          bound_ms=bms, times=times))
        r = r2s[len(r2s) // 2]
        for name, fn in fns.items():
            if fn.legacy:
                continue
            sweep = {'G%d' % g: member_t_fn(fn.so, group=g)
                     for g in (1, 2, 4, 8, 16, 32)}
            times = time_sources(sweep, [(tp_t, tm, cd_t, r)])
            report('K1t %s N=%d M=%d d=%d at median radius by group size '
                   '(the wrapper takes G %d)' % (
                       name, npts, m, d,
                       kernels.member_group_size(m, npts, d)), 0.0, times)
            results['shapes'].append(dict(npts=npts, m=m, d=d, source=name,
                                          group_sweep=times))


def bench_bootstrap(fns, traffic, results):
    rng = np.random.RandomState(0)
    for n, nrounds, d in chip_smoke.BOOTSTRAP_SHAPES:
        _, masks, args = chip_smoke.bootstrap_inputs(rng, n, nrounds, d)
        want = kernels.bootstrap_radius_plain(*args)
        for name, fn in fns.items():
            assert same(fn(*args), want), ('radius differs', name, n,
                                           nrounds, d)
        bms = chip_smoke.bootstrap_bound(args[1], args[2], d)[0]
        times = time_sources(fns, [args])
        report('K2 N=%d B=%d d=%d' % (n, len(masks), d), bms, times)
        results['shapes'].append(dict(n=n, rounds=len(masks), d=d,
                                      bound_ms=bms, times=times))
    for path, calls in traffic.items():
        for k, c in enumerate(calls):
            want = kernels.bootstrap_radius_plain(*c)
            for name, fn in fns.items():
                assert same(fn(*c), want), \
                    ('radius differs on a real call', name, path, k)
        d = calls[0][0].shape[1]
        bms = float(np.mean([chip_smoke.bootstrap_bound(c[1], c[2], d)[0]
                             for c in calls]))
        times = time_sources(fns, calls)
        report('K2 on %s\'s %d real calls' % (path, len(calls)), bms, times,
               ' (npad %s, d %d)' % (sorted({c[0].shape[0] for c in calls}),
                                     d))
        results['traffic'][path] = dict(calls=len(calls), bound_ms=bms,
                                        times=times)


def propose_fn(so, legacy=False):
    """The source's K4 as ``kernels.spec_propose`` calls it (no count);
    *legacy*: the entry point of before its redesign (no vector width)."""
    fn = ctypes.CDLL(so).un_spec_propose
    fn.argtypes = [VP] * 6 + [CI] * (4 if legacy else 5) + [VP] * 5
    fn.restype = CI

    def call(u, v, tl, tr, xibank, it):
        (P, d), (R, _, D) = u.shape, xibank.shape
        dev = u.device
        ts = torch.empty((P, D), dtype=torch.float32, device=dev)
        tlc = torch.empty(P, dtype=torch.float32, device=dev)
        trc = torch.empty(P, dtype=torch.float32, device=dev)
        up = torch.empty((P * D, d), dtype=torch.float32, device=dev)
        vec = [] if legacy else [kernels.propose_vector_width(d, u, v, up)]
        _check_rc('un_spec_propose', fn(
            u.data_ptr(), v.data_ptr(), tl.data_ptr(), tr.data_ptr(),
            xibank.data_ptr(), it.data_ptr(), R, P, D, d, *vec,
            ts.data_ptr(), tlc.data_ptr(), trc.data_ptr(), up.data_ptr(),
            _stream()))
        return ts, tlc, trc, up

    return call


def update_fn(so, legacy=False):
    """The source's K5 as ``kernels.spec_update`` calls it (no count;
    its entry point is the same before and after its redesign)."""
    fn = ctypes.CDLL(so).un_spec_update
    fn.argtypes, fn.restype = [VP] * 7 + [CI] * 4 + [VP] * 13, CI

    def call(Lp, tin, ts, tlc, trc, Lmin, dirbank, st):
        (P, D), (nsteps, _, d) = ts.shape, dirbank.shape
        _check_rc('un_spec_update', fn(
            Lp.data_ptr(), None if tin is None else tin.data_ptr(),
            ts.data_ptr(), tlc.data_ptr(), trc.data_ptr(), Lmin.data_ptr(),
            dirbank.data_ptr(), nsteps, P, D, d,
            *(st[k].data_ptr() for k in kernels.SPEC_STATE), _stream()))

    return call


def _spec_inputs(P, D, d):
    return chip_smoke.spec_round_inputs(np.random.RandomState(P + D + d), P,
                                        D, d)


def bench_propose(fns, traffic, results):
    """K4 at ``chip_smoke.SPEC_SHAPES`` (no saved traffic: K4 runs inside
    the spec walk's graphs)."""
    for P, D, d in chip_smoke.SPEC_SHAPES:
        st, xibank, _, _, _, _ = _spec_inputs(P, D, d)
        a = (st['u'], st['v'], st['tl'], st['tr'], xibank, st['it'])
        want = kernels.spec_propose_plain(*a)
        for name, fn in fns.items():
            assert all(chip_smoke.values_equal(x, y)
                       for x, y in zip(fn(*a), want)), \
                ('spec_propose differs', name, P, D, d)
        bms, _ = chip_smoke.propose_bound(P, D, d)
        times = time_sources(fns, [a])
        report('K4 P=%d D=%d d=%d' % (P, D, d), bms, times)
        results['shapes'].append(dict(P=P, D=D, d=d, bound_ms=bms,
                                      times=times))


def bench_update(fns, traffic, results):
    """K5 at ``chip_smoke.SPEC_SHAPES``, bit-equal to the plain version
    with and without the filter's rows, timed on one state that each
    call moves on and mid-dispatch (``chip_smoke.mid_dispatch_update``);
    first an empty kernel (``torch.cuda._sleep(0)``), the floor of a
    launch."""
    floor = time_sources({'empty kernel': lambda: torch.cuda._sleep(0)},
                         [()])
    report('empty kernel', 0.0, floor)
    results['empty_kernel'] = floor
    for P, D, d in chip_smoke.SPEC_SHAPES:
        st, xibank, dirbank, Lp, tin, Lmin = _spec_inputs(P, D, d)
        ts, tlc, trc, _ = kernels.spec_propose_plain(
            st['u'], st['v'], st['tl'], st['tr'], xibank, st['it'])
        for t in (tin, None):
            plain = {k: x.clone() for k, x in st.items()}
            kernels.spec_update_plain(Lp, t, ts, tlc, trc, Lmin, dirbank,
                                      plain)
            for name, fn in fns.items():
                mine = {k: x.clone() for k, x in st.items()}
                fn(Lp, t, ts, tlc, trc, Lmin, dirbank, mine)
                bad = [k for k in kernels.SPEC_STATE
                       if not chip_smoke.values_equal(mine[k], plain[k])]
                assert not bad, ('spec_update differs', name, P, D, d,
                                 t is None, bad)
            if t is not None:
                bms, _ = chip_smoke.update_bound(P, D, d, t, st, plain)
        scratch = {k: x.clone() for k, x in st.items()}
        times = time_sources(fns, [(Lp, tin, ts, tlc, trc, Lmin, dirbank,
                                    scratch)])
        report('K5 P=%d D=%d d=%d' % (P, D, d), bms, times)
        mid, mid_bms = chip_smoke.mid_dispatch_update(kernels, st, Lp, tin,
                                                      ts, tlc, trc, Lmin)
        mid_times = time_sources(fns, [mid])
        report('K5 P=%d D=%d d=%d mid-dispatch' % (P, D, d), mid_bms,
               mid_times)
        del mid
        results['shapes'].append(dict(P=P, D=D, d=d, bound_ms=bms,
                                      times=times, mid_bound_ms=mid_bms,
                                      mid_times=mid_times))


def sync_fn(so, legacy=False):
    """The source's K6 as ``kernels.sync_update`` calls it (no count),
    its form forced where given; *legacy*: the entry point of before its
    redesign (no form, no tick)."""
    fn = ctypes.CDLL(so).un_sync_update
    fn.argtypes = [VP] * 7 + [CI] * (4 if legacy else 5) \
        + [VP] * (15 if legacy else 16)
    fn.restype = CI
    keys = kernels.SYNC_STATE[:-1] if legacy else kernels.SYNC_STATE

    def call(Lp, tin, ts, tlc, trc, Lmin, dirbank, max_it, st, form=-1):
        nsteps, P, d = dirbank.shape
        ints = (nsteps, max_it, P, d) + (() if legacy else (form,))
        _check_rc('un_sync_update', fn(
            Lp.data_ptr(), None if tin is None else tin.data_ptr(),
            ts.data_ptr(), tlc.data_ptr(), trc.data_ptr(), Lmin.data_ptr(),
            dirbank.data_ptr(), *ints, *(st[k].data_ptr() for k in keys),
            _stream()))
    call.legacy = legacy
    return call


# K6's shapes: chip_smoke.SYNC_SHAPES, then P and d on both sides of the
# one block's reach and of rank counting's (the thresholds were chosen
# from this sweep; they are kSingleElems, kSingleWalkers and kRankMax in
# csrc/sync_update.cu)
SYNC_SWEEP = chip_smoke.SYNC_SHAPES + (
    (128, 2), (256, 2), (512, 2), (1024, 2), (2048, 2), (256, 8),
    (512, 8), (1024, 8), (1025, 8), (2048, 8), (64, 50), (128, 50),
    (164, 50), (256, 50), (1024, 50))


def graph_sources(variants, args):
    """{name: [graph ms of each pass]}: each variant ``(fn, extra)``
    called as ``fn(*args(), *extra)`` among 50 calls in a CUDA graph
    (``chip_smoke.graph_ms``), in the order A B ... B A, on a fresh copy
    of the arguments each pass."""
    out = {name: [] for name in variants}
    for name in list(variants) + list(variants)[::-1]:
        fn, extra = variants[name]
        a = args()
        out[name].append(chip_smoke.graph_ms(lambda: fn(*a, *extra)))
    return out


def report_graph(label, bound_ms, times):
    print('%s: bound %.6f ms; in a graph, two passes: %s' % (
        label, bound_ms, '; '.join(
            '%s %s' % (name, ' / '.join('%.4f' % t for t in ts))
            for name, ts in times.items())), flush=True)


def _floor(results):
    floor = [chip_smoke.graph_ms(lambda: torch.cuda._sleep(0))
             for _ in range(2)]
    print('empty kernel in a graph: %s ms' % ' / '.join(
        '%.4f' % t for t in floor), flush=True)
    results['empty_kernel_graph_ms'] = floor


def bench_sync(fns, traffic, results):
    """K6 at :data:`SYNC_SWEEP`, inside a step and at a step boundary
    (``chip_smoke.sync_round_inputs``), every source and every form of a
    source that takes one bit-equal to the plain version, then timed in
    a graph (no saved traffic: K6 runs inside the sync walk's graphs)."""
    _floor(results)
    for P, d in SYNC_SWEEP:
        rng = np.random.RandomState(P + d)
        for kind in ('mid', 'boundary'):
            st, tbank, dirbank, Lp, tin, Lmin, max_it = \
                chip_smoke.sync_round_inputs(rng, P, d, kind)
            ts, tlc, trc, _ = kernels.spec_propose_plain(
                st['u'], st['v'], st['tl'], st['tr'], tbank, st['row'])
            plain = {k: x.clone() for k, x in st.items()}
            kernels.sync_update_plain(Lp, tin, ts, tlc, trc, Lmin, dirbank,
                                      max_it, plain)
            variants = {}
            for name, fn in fns.items():
                if fn.legacy:
                    variants[name] = (fn, ())
                else:
                    for fname, form in chip_smoke.sync_forms(kernels,
                                                             P).items():
                        variants['%s %s' % (name, fname)] = (fn, (form,))

            def args():
                return (Lp, tin, ts, tlc, trc, Lmin, dirbank, max_it,
                        {k: x.clone() for k, x in st.items()})
            for vname, (fn, extra) in variants.items():
                a = args()
                fn(*a, *extra)
                bad = [k for k in kernels.SYNC_STATE
                       if k != 'tick' and not
                       chip_smoke.values_equal(a[-1][k], plain[k])]
                assert not bad, ('sync_update differs', vname, P, d, kind,
                                 bad)
            bms = chip_smoke.sync_update_bound(P, d, tin, st, Lp, Lmin,
                                               kind == 'boundary')[0]
            times = graph_sources(variants, args)
            report_graph('K6 P=%d d=%d %s' % (
                P, d, 'inside a step' if kind == 'mid' else
                'at a step boundary'), bms, times)
            results['shapes'].append(dict(P=P, d=d, kind=kind, bound_ms=bms,
                                          graph_ms=times))


def rwalk_fn(so, legacy=False):
    """The source's K7 as a random-walk step calls it (no count): accept,
    then the next proposal ``u + scale * m`` into *up*; *legacy*: the
    kernel of before its redesign, then torch's multiply and add, as its
    walk built the proposal."""
    fn = ctypes.CDLL(so).un_rwalk_accept
    fn.argtypes = [VP] * (4 if legacy else 6) + [CI] * 2 + [VP] * 5
    fn.restype = CI

    def call(Lev, tin, up, Lmin, st, m, scale):
        P, d = up.shape
        ptrs = [Lev.data_ptr(), None if tin is None else tin.data_ptr(),
                up.data_ptr(), Lmin.data_ptr()]
        if not legacy:
            ptrs += [m.data_ptr(), scale.data_ptr()]
        _check_rc('un_rwalk_accept', fn(
            *ptrs, P, d, *(st[k].data_ptr() for k in kernels.RWALK_STATE),
            _stream()))
        if legacy:
            torch.add(st['u'], scale * m, out=up)
    return call


def bench_rwalk(fns, traffic, results):
    """K7 at ``chip_smoke.RWALK_SHAPES`` (``chip_smoke.rwalk_round_inputs``):
    a step with its next proposal, every source bit-equal to the plain
    version, then timed in a graph (no saved traffic: K7 runs inside the
    random walk's graph)."""
    _floor(results)
    for P, d in chip_smoke.RWALK_SHAPES:
        rng = np.random.RandomState(P + d)
        Lev, tin, up, Lmin, st, m, scale = chip_smoke.rwalk_round_inputs(
            rng, P, d)

        def args():
            return (Lev, tin, up.clone(), Lmin,
                    {k: x.clone() for k, x in st.items()}, m, scale)
        want = args()
        kernels.rwalk_accept_plain(*want)
        for name, fn in fns.items():
            a = args()
            fn(*a)
            bad = [k for k in kernels.RWALK_STATE
                   if not chip_smoke.values_equal(a[4][k], want[4][k])]
            if not chip_smoke.values_equal(a[2], want[2]):
                bad.append('up')
            assert not bad, ('rwalk_accept differs', name, P, d, bad)
        bms = chip_smoke.rwalk_accept_bound(P, d, tin, Lev, up, Lmin)[0]
        times = graph_sources({name: (fn, ()) for name, fn in fns.items()},
                              args)
        report_graph('K7 P=%d d=%d a step with its next proposal' % (P, d),
                     bms, times)
        results['shapes'].append(dict(P=P, d=d, bound_ms=bms,
                                      graph_ms=times))


BENCHES = {'consume_scan': (scan_fn, bench_scan),
           'radius_member': (member_fn, bench_member),
           'radius_member_t': (member_t_fn, bench_member_t),
           'bootstrap_radius': (bootstrap_fn, bench_bootstrap),
           'spec_propose': (propose_fn, bench_propose),
           'spec_update': (update_fn, bench_update),
           'sync_update': (sync_fn, bench_sync),
           'rwalk_accept': (rwalk_fn, bench_rwalk)}


def host_us(fn, n=1000, chunk=100):
    """Mean host microseconds per call of *fn* over *n* calls; the card
    is drained between chunks, outside the clock."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(n // chunk):
        t0 = time.perf_counter()
        for _ in range(chunk):
            fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return 1e6 * total / n


def host_floor():
    """The host time of one K1 and one K2 wrapper call, and of its parts,
    at the eggbox's shapes. Returns {kernel: {part: microseconds}}."""
    rng = np.random.RandomState(0)
    (tp, tm, cd), _ = chip_smoke.member_inputs(rng, 512, 4096, 2)
    _, _, (btp, bvalid, bmasks) = chip_smoke.bootstrap_inputs(rng, 400, 30, 2)
    lib = kernels._lib()
    out1 = torch.empty(4096, dtype=torch.int32, device='cuda')
    out2 = torch.empty((), dtype=torch.float32, device='cuda')
    sel = torch.empty(512, dtype=torch.int32, device='cuda')
    stream = _stream()

    def checks(tensors, specs):
        kernels._on_cpu(*tensors)
        for t, (name, dtype, ndim) in zip(tensors, specs):
            kernels._check(t, name, dtype, ndim)

    k1_specs = (('tpoints', torch.float32, 2), ('tmask', torch.int32, 1),
                ('cands', torch.float32, 2))
    k2_specs = (('tpoints', torch.float32, 2), ('valid', torch.uint8, 1),
                ('masks', torch.uint8, 2))
    out = {
        'radius_member': {
            'wrapper': host_us(lambda: kernels.radius_member(tp, tm, cd,
                                                             1.0)),
            'checks': host_us(lambda: checks((tp, tm, cd), k1_specs)),
            'group_size': host_us(lambda: kernels.member_group_size(
                4096, 512, 2)),
            'torch.empty': host_us(lambda: torch.empty(
                4096, dtype=torch.int32, device=cd.device)),
            'stream_lookup': host_us(_stream),
            'ctypes_call': host_us(lambda: lib.un_radius_member(
                tp.data_ptr(), tm.data_ptr(), 512, cd.data_ptr(), 4096, 2,
                CF(1.0), 32, out1.data_ptr(), stream)),
        },
        'bootstrap_radius': {
            'wrapper': host_us(lambda: kernels.bootstrap_radius(
                btp, bvalid, bmasks)),
            'checks': host_us(lambda: checks((btp, bvalid, bmasks),
                                             k2_specs)),
            'torch.empty_x2': host_us(lambda: (
                torch.empty((), dtype=torch.float32, device=btp.device),
                torch.empty(512, dtype=torch.int32, device=btp.device))),
            'stream_lookup': host_us(_stream),
            'ctypes_call': host_us(lambda: lib.un_bootstrap_radius(
                btp.data_ptr(), bvalid.data_ptr(), bmasks.data_ptr(), 512,
                bmasks.shape[0], 2, sel.data_ptr(), out2.data_ptr(),
                stream)),
        },
    }
    for name, parts in out.items():
        print('host floor of %s, microseconds per call over 1000 calls: %s'
              % (name, ', '.join('%s %.2f' % kv for kv in parts.items())),
              flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--kernel', choices=sorted(BENCHES))
    ap.add_argument('--source', action='append', default=[],
                    help='NAME=PATH of a source with the kernel\'s entry')
    ap.add_argument('--legacy', action='append', default=[],
                    help='NAME of a source with the entry point of before '
                    'its kernel\'s redesign')
    ap.add_argument('--traffic', help='file of chip_smoke.py --save-traffic')
    ap.add_argument('--host-floor', action='store_true',
                    help='split the K1 and K2 wrappers\' host time instead')
    ap.add_argument('--out', help='write the results here as JSON')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('bench_kernels: no CUDA device', file=sys.stderr)
        return 1
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    results = dict(card=smi.stdout.strip(), kernel=args.kernel, shapes=[],
                   traffic={})
    if args.host_floor:
        results['host_floor'] = host_floor()
    else:
        if not args.kernel or not args.source:
            ap.error('--kernel and --source are required')
        make_fn, bench = BENCHES[args.kernel]
        sources = dict(s.split('=', 1) for s in args.source)
        fns = {name: make_fn(so, legacy=name in args.legacy)
               for name, so in build(sources).items()}
        traffic = {}
        if args.traffic:
            for path, kcalls in torch.load(args.traffic).items():
                calls = [tuple(t.cuda() if torch.is_tensor(t) else t
                               for t in c)
                         for c in kcalls.get(args.kernel, [])]
                if calls:
                    traffic[path] = calls
        bench(fns, traffic, results)
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(results, f, indent=1)
    print('bench_kernels: done')
    return 0


if __name__ == '__main__':
    sys.exit(main())
