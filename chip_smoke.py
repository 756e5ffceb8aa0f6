#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ultranest_torch``) on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. checks for a CUDA device (exit 1 without one) and prints the card's
   name and power limit as ``nvidia-smi`` reports them;
2. builds the nine CUDA kernels with nvcc (one compiler per source,
   all started together) and prints the build time;
3. holds each kernel against its plain torch version on the card, at
   the shapes its paths give it (K1 also at d 40, its path for d > 32,
   and with 32768 live rows, in tiles; K2, bit for bit, also with 50
   rounds, two words of bits; K3 also with every row accepted, at
   npad 1024 to 32768, with no rows, and with signed zeros, NaN and
   infinities, bit for bit; K4 and K5, the two halves of a spec-walk
   round, bit for bit at every spec problem's shape and at D 1, with
   walkers done, at their last step, on a face and with zero axes; K4 at
   D 1 on the sync walk's bank rows and K6, its update and step
   boundary, bit for bit inside a step, at its boundary, all walkers
   accepting and after the last step, at the sync engine runs' shapes,
   above one block and at an odd P, in each of its forms (one block or
   a grid; rank counting or radix selection); K7, the random walk's
   acceptance and next proposal, and its prologue, bit for bit with
   rows outside the cube, on its faces and NaN; K8, the transform
   layer's radius graphs, its labels equal to its plain version's and
   to label propagation's and its centred points within 1e-5, at the
   rebuilds' shapes, with the rebuild's whole route timed beside the
   host path it replaces), times them with CUDA
   events (the kernel also on the device alone, its calls queued behind
   a spin kernel; K4 to K7 also among 50 calls in a CUDA graph, beside
   an empty kernel's time there, the floor of a launch), and prints
   each shape's bound: the larger of its float32
   operations at 67 TFLOP/s and its bytes at 3.35 TB/s (K4 and K5 also
   their share of it, their first form's device time and the registers
   ptxas gave their instantiation);
4. drives the paths, each with every kernel count set to 0 just before
   it and read just after it:

   * the membership shootout (``ultranest_torch.evaluate.bench_membership``,
     the path of K1t), at its three shapes; before it K1t is held against
     its plain version at 65 boundary radii for every group size 1 to 32,
     with a mask of 0, 1 and -1, at those shapes, at d 40 (candidates in
     shared memory) and at 32768 live rows (in tiles);
   * the region-rejection path: the eggbox with the JAX package's bench
     configuration (400 live points, ``bench.py:104-115``) through
     ``ReactiveNestedSampler(..., device='cuda')``, gated on the
     quadrature logZ;
   * the population spec-walk path at the bench's own settings
     (``bench.py:126-219``, 400 live points, dlogz 2, spec depth 8):
     asymgauss50 (d 50, popsize 4096, nsteps 100), then the extras
     rosenbrock8 (popsize 128, nsteps 16; no gate), multishell8 (128,
     16), loggamma30 (256, 60) and the governed gauss100 (2048, nsteps
     100 growing under ``adaptive_nsteps``), each gated as
     ``bench.py:353-372`` gates it; each prints the depth the spec-depth
     probe chose, t_row, the likelihood's fixed cost and A (as every
     sampler of every path that probes does), and where the depth is
     below 8 the same problem runs again at depth 8 with the probe off
     and both walls are printed; then A, one replayed round without the
     likelihood (``popfused.measure_round_overhead``), at each of the
     five problems' shapes; after the walk checks below, gauss100_hard
     at the bench's configuration, gated;
   * the sync, async and random-walk engines in segment mode at the JAX
     package's engine tests' configurations (``tests/test_popfused.py:
     40-107``), gated as those tests gate, and one classic-mode async
     run (segment path off) on the default MLFriends region; every
     dispatch's walk as CUDA graphs (sync: K4 and K6; random walk: K7
     and its prologue), each run's wall, rounds, host reads, replays and
     ms a round printed; one dispatch each of sync, sync8 and the random
     walk kept and run again from the host loop (every K4, K6 and K7
     call held bit for bit against the plain versions) and as graphs
     (every output the host loop's bits), and the kernel nodes of its
     round or step counted in a captured graph (a sync round: K4, the
     likelihood's and one K6; a random-walk step: the likelihood's and
     K7, nothing else);
   * the classic ``NestedSampler`` (``tests/test_run.py:79-90``: 2-d
     gauss, 200 live points, seed 5) and ``ReactiveNestedSampler`` with a
     host ``SliceSampler`` (mixture directions, the settings of
     ``tests/test_stepsamplers.py:123-131`` on a gauss of d 8), both with
     ``device='cuda'``, gated as those tests gate: K2 launched at every
     region rebuild, no plain version called;
   * ``sampler.plot()`` on the eggbox run's results (Agg backend; only
     where matplotlib is installed, and said so where it is not);
   * device label propagation against ``connected_components`` (the
     eggbox run's last region, and 4096 points of d 8 at their
     MLFriends radius), labels equal;
   * the dispatch watchdog: (a) a fetch behind a ~3 s spin kernel with a
     1 s deadline raises ``DeviceLostError``; (b) a region-rejection run
     and (c) a spec-walk ``FusedPopulationSliceSampler`` run (2-d gauss,
     400 live points) whose next read after their third result fetch
     waits behind a spin kernel, under a 1 s deadline: each warns "accelerator lost",
     degrades to the host samplers and ends inside
     ``tests/test_watchdog.py``'s gate;
   * warm starts: the eggbox at the bench configuration run cold into a
     ``storage_backend='csv'`` run directory, then again through
     ``warmstart_from_similar_file(..., torch_loglike=,
     torch_transform=)`` on the card, gated on the quadrature logZ with
     K1, K2 and K3 launched; the same for the 2-d gauss, sigma 0.1 then
     0.11, as ``tests/test_resume_similar.py:75-101``;
   * ``reuse_samples(torch_loglike=)``, the calibrator's ladder with
     ``FusedPopulationSliceSampler`` (nsteps 4, 8, 16, K3 in each rung),
     the torch gradients, one ``DynamicCHMCSampler`` and one
     ``DynamicHMCSampler`` step and a ``SamplingPathStepSampler`` run,
     gated as the reference's tests gate; ``read_file`` and
     ``resume='resume-similar'`` only where h5py is installed (said so
     where it is not);
   * the mesh phase (``ultranest_torch.parallel``): the collectives on
     CUDA tensors over a one-rank NCCL group, then two ranks on the one
     card, this script started twice more (``--mesh-rank``) in fresh
     interpreters joined by gloo on 127.0.0.1, the library built here
     first; each rank runs the sharded bootstrap radius at the eggbox
     rebuild shape (bit-equal to K2 on all rounds), the eggbox on the
     sharded rejection path and asymgauss50 on the sharded spec-walk
     segment path (2048 walkers a rank); the ranks must agree exactly
     in logZ, ncall and niter, the eggbox's ncall must be the root points
     plus its billed counts, and K1, K2 and K3 must launch;
   * the files outside the package, each through its own entry point:
     every ported example (``examples/torch_port/``:
     ``tutorial_highdim --torch`` at its defaults, K3 in every dispatch;
     ``run_problem --problem eggbox --torch``, K1, K2 and K3;
     ``evaluate_scaling`` with the fused method; the host tutorials,
     K2 at every region rebuild, the two sine tutorials at ``--quick``),
     each gated against its truth where it has one; the fuzzer's seeds
     25-36 with ``tests/test_fuzz.py``'s caps, each through the fuzzer's
     own check; the C and C++ runners on libraries built here with gcc
     and g++ (Fortran only where gfortran exists, and said so where it
     does not); ``bias_audit.run_one`` on shell8 for seeds 1-3 (each
     |z| < 4) and ``profile_run`` on asymgauss50 and the eggbox (its
     host split of a spec-walk round);

   and checks that each path's kernels were launched in its run (K3 on
   every segment path; the classic run consumes on the host and
   launches K2 in its region rebuilds), and that every spec walk ran as
   CUDA graphs (``SpecGraphs``): K4 and K5 launched, ``graph`` True on
   every dispatch of the five spec problems, the async engine, the
   mesh's asymgauss50 on both ranks, ``tutorial_highdim``, the shell8
   audit seeds, ``profile_run`` asymgauss50 and the calibrator ladder,
   and no dispatch of any path run from the host loop; one dispatch
   each of asymgauss50 and gauss100 is kept and run again from the host
   loop (every K4 and K5 call held bit for bit against the plain
   versions) and as graphs (uf, Lf, done, nc, nuseful and width the host
   loop's bits);
5. replays every path's K1, K2 and K3 calls, kept during its run: each
   kernel on real traffic, held against the plain version (K1 and K2 on
   every call, K2 bit for bit) and timed per call beside the bound of
   those inputs; times K4, K5, K6 and K7 in a CUDA graph at every shape
   the paths' walks ran them (K6 inside a step and at a step boundary,
   weighed by the paths' boundaries), checks that their launches booked
   by shape add up to the launches counted; then prints the kernels
   ranked by launches x (device ms - bound ms) over the paths;
6. prints one JSON line describing the kernels (each at its first
   shape), then the result line ``{"ok": true, "device": {...}}`` last.

``--save-traffic FILE`` also saves the kept calls, for
``scripts/bench_kernels.py``.

Any failed check raises, which exits non-zero before the last line.
"""

import collections
import json
import re
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
    # the two halves of the spec walk's lax.while_loop body (an XLA loop
    # of the JAX package, ported by hand as K3 was)
    'spec_propose': ('ultranest_torch/csrc/spec_propose.cu',
                     'ultranest_tpu/popfused.py:575'),
    'spec_update': ('ultranest_torch/csrc/spec_update.cu',
                    'ultranest_tpu/popfused.py:587'),
    # the sync engine's shrink update and step boundary, and the random
    # walk's acceptance (XLA loops of the JAX package, ported by hand)
    'sync_update': ('ultranest_torch/csrc/sync_update.cu',
                    'ultranest_tpu/popfused.py:849'),
    'rwalk_accept': ('ultranest_torch/csrc/rwalk_accept.cu',
                     'ultranest_tpu/popfused.py:1612'),
    # the transform layer's radius graphs: XLA and host code in the JAX
    # package (connected_components, label_propagation_components,
    # subtract_nearby), one kernel here
    'radius_graph': ('ultranest_torch/csrc/radius_graph.cu',
                     'ultranest_tpu/ops/cluster.py:37'),
}
# the paths beside the spec problems, the async engine and the mesh's
# asymgauss50 whose spec walks must run (as CUDA graphs, K4 and K5
# launched)
SPEC_PATHS = ('example_tutorial_highdim', 'bias_audit_shell8',
              'profile_run_asymgauss50', 'calibrator')
EGGBOX_LOGZ = 235.856
# the card's published peaks (H100 SXM, at a 700 W power limit): float32
# outside the tensor cores, and HBM3 bytes per second
F32_OPS_PER_S = 67e12
BYTES_PER_S = 3.35e12


def ptxas_summary(log):
    """[(kernel and its template arguments, registers, bytes spilled)]
    from the output of ``nvcc -Xptxas -v``, one entry per instantiation."""
    out = []
    lines = log.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '\w*?_cu_[0-9a-f]{8}(\d+)",
                      line)
        if not m:
            continue
        rest = line[m.end():]
        name, rest = rest[:int(m.group(1))], rest[int(m.group(1)):]
        args = re.findall(r'L[ib](\d+)E', rest.split('Ev')[0])
        if args:
            name += '<%s>' % ', '.join(args)
        # the entry's properties follow, up to the next entry's
        props = ' '.join(lines[i + 1:i + 5]).split('Compiling entry')[0]
        out.append((name,
                    int(re.search(r'Used (\d+) registers', props).group(1)),
                    int(re.search(r'(\d+) bytes spill stores',
                                  props).group(1))))
    return out


def bound(ops, nbytes):
    """(ms, 'operations' or 'bytes'): the least time the card could take
    for *ops* float32 operations and *nbytes* bytes moved."""
    t_ops, t_bytes = ops / F32_OPS_PER_S, nbytes / BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), \
        'operations' if t_ops >= t_bytes else 'bytes'


def member_bound(npts, nvalid, m, d, nmember):
    """Bound of a radius membership test (K1, K1t): a candidate outside
    needs its distance to every valid point, one inside at least one;
    each distance costs 3 d operations and a compare."""
    ops = ((m - nmember) * nvalid + nmember) * (3 * d + 1)
    return bound(ops, 4 * (npts * d + npts + m * d + m))


def bootstrap_bound(valid, masks, d, per_round=False):
    """Bound of K2 on these masks. Each distance that some round needs
    (from a point i the round selected to a valid point j it did not)
    is computed once, 3 d operations; then one min per (round, selected
    i, unselected j) and one max per (round, unselected j).

    *per_round* gives the yardstick this one replaced, which counted
    every distance anew in every round that needs it.
    """
    valid = valid.bool()
    sel = masks.bool()
    out = valid[None, :] & ~sel
    nsel = sel.sum(dim=1).double()
    nout = out.sum(dim=1).double()
    mins = float((nsel * nout).sum())
    if per_round:
        pairs = mins
    else:
        # pairs (i, j) that at least one round needs
        pairs = float(((sel.T.float() @ out.float()) > 0).sum())
    ops = pairs * 3 * d + mins + float(nout.sum())
    npad, nrounds = masks.shape[1], masks.shape[0]
    return bound(ops, 4 * npad * d + npad + nrounds * npad + 4)


def scan_bound(npad, P, nseq):
    """Bound of K3: three compares per live value for each row up to the
    last valid one (min, rank, dup), two for each row after it."""
    ops = npad * (3 * nseq + 2 * (P - nseq))
    return bound(ops, 4 * (2 * npad + 2 * P + 5 * P))


# K1's shapes (npad, M, d): the eggbox's smallest draw and the largest
# batch of its segments; d 16 and a larger live set; then d 40 (above
# d 32 the block stages its candidates in shared memory) and 32768 live
# rows (in tiles)
MEMBER_SHAPES = ((512, 4096, 2), (512, 131072, 2), (512, 4096, 16),
                 (2048, 16384, 8), (512, 4096, 40), (32768, 4096, 2))
# K2's shapes (N, rounds, d), the region rebuilds' (30 bootstrap rounds):
# the eggbox's 400 live points, the sync d-2 engine run's 100 (padded to
# 128) and the classic async run's 200 in d 8 (padded to 256); 2048 in
# d 8 as a large case; 50 rounds (the default of
# MLFriends.compute_maxradiussq), two words of bits
BOOTSTRAP_SHAPES = ((400, 30, 2), (100, 30, 2), (200, 30, 8), (2048, 30, 8),
                    (400, 50, 2))
# K8's shapes (N, d): the rebuilds' of eggbox2d.live800, of 400 live
# points, the widest of an improvement pass, and d 8
GRAPH_SHAPES = ((800, 2), (400, 2), (864, 2), (400, 8))


def member_inputs(rng, npad, m, d):
    """(tpoints, tmask, cands) on the card for K1, unit normals with the
    first 25/32 of the rows valid; and the number of valid rows."""
    import torch
    nvalid = npad * 25 // 32
    tp = rng.normal(size=(npad, d)).astype(np.float32)
    tmask = (np.arange(npad) < nvalid).astype(np.int32)
    cands = rng.normal(size=(m, d)).astype(np.float32)
    return tuple(torch.as_tensor(a, device='cuda')
                 for a in (tp, tmask, cands)), nvalid


def bootstrap_inputs(rng, n, nrounds, d):
    """(tpoints numpy, masks numpy, K2's padded inputs on the card)."""
    from ultranest_torch.ops.bootstrap import (make_bootstrap_masks,
                                               radius_inputs)
    tp = rng.normal(size=(n, d)).astype(np.float32)
    masks = make_bootstrap_masks(n, nrounds, rng=np.random.RandomState(n))
    return tp, masks, radius_inputs(tp, masks, 'cuda')


def check_radius_member(kernels, rng, npad, m, d):
    """K1 against its plain version at 65 boundary radii. Returns (0.0,
    kernel ms, plain ms, bound ms, what bounds it, device ms)."""
    from ultranest_torch.evaluate.bench_membership import (boundary_radii,
                                                           cuda_ms)
    (tp_t, tm_t, c_t), nvalid = member_inputs(rng, npad, m, d)
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
    dev = queued_ms([lambda: kernels.radius_member(tp_t, tm_t, c_t, r2)] * 50)
    plain = cuda_ms(lambda: kernels.radius_member_plain(tp_t, tm_t, c_t, r2),
                    5)
    bms, by = member_bound(npad, nvalid, m, d, round(frac * m))
    print('K1 radius_member npad=%d M=%d d=%d: equal at %d radii with %d '
          'candidates exactly on the boundary, kernel %.4f ms, device %.4f '
          'ms, plain %.4f ms, bound %.6f ms (%s)' % (
              npad, m, d, len(r2s), nboundary, ms, dev, plain, bms, by))
    return 0.0, ms, plain, bms, by, dev


def bits_equal(a, b):
    """Whether two float32 tensors, or two tuples of them, hold the same
    bits (torch.equal alone takes -0.0 for +0.0)."""
    import torch
    if torch.is_tensor(a):
        a, b = (a,), (b,)
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


def check_bootstrap_radius(kernels, rng, n, nrounds, d):
    """K2 against its plain version, bit for bit. Returns (0.0, kernel
    ms, plain ms, bound ms, what bounds it, device ms)."""
    from ultranest_torch.evaluate.bench_membership import cuda_ms
    from ultranest_torch.ops.bootstrap import _numpy_radius
    tp, masks, args = bootstrap_inputs(rng, n, nrounds, d)
    got = kernels.bootstrap_radius(*args)
    want = kernels.bootstrap_radius_plain(*args)
    assert bits_equal(got, want) and float(got) > 0, \
        ('bootstrap_radius disagrees', n, nrounds, d, float(got),
         float(want))
    got, want = float(got), float(want)
    ms = cuda_ms(lambda: kernels.bootstrap_radius(*args), 50)
    dev = queued_ms([lambda: kernels.bootstrap_radius(*args)] * 50)
    plain = cuda_ms(lambda: kernels.bootstrap_radius_plain(*args), 5)
    bms, by = bootstrap_bound(args[1], args[2], d)
    old_bms = bootstrap_bound(args[1], args[2], d, per_round=True)[0]
    t0 = time.perf_counter()
    for _ in range(10):
        host = _numpy_radius(tp, masks)
    host_ms = (time.perf_counter() - t0) * 100
    print('K2 bootstrap_radius N=%d B=%d d=%d: %.9g, bit-equal to plain, '
          'kernel %.4f ms, device %.4f ms, plain %.4f ms, bound %.6f ms (%s; '
          'each distance counted once: counted per round it was %.6f ms), '
          'host KNN path %.4f ms (value %.9g)' % (
              n, len(masks), d, got, ms, dev, plain, bms, by, old_bms,
              host_ms, host))
    return 0.0, ms, plain, bms, by, dev


def graph_inputs(rng, n, d):
    """(u, t, r2) for K8: *n* points in 18 blobs of the unit cube (an
    eggbox's live points late in a run), whitened per axis into t, and
    twice t's largest nearest-neighbour distance, squared."""
    import torch
    from ultranest_torch.ops.pairwise import pairwise_sqdist
    centres = rng.uniform(0.1, 0.9, size=(18, d))
    u = (centres[rng.randint(18, size=n)]
         + rng.normal(0, 0.01, size=(n, d))).clip(1e-3, 1 - 1e-3)
    t = (u - u.mean(axis=0)) / u.std(axis=0)
    tt = torch.as_tensor(t, dtype=torch.float32)
    d2 = pairwise_sqdist(tt, tt)
    d2.fill_diagonal_(float('inf'))
    return u, t, 4 * float(d2.min(dim=1).values.max())


def graph_bound(n, d, centre=True):
    """Bound of K8: the t-space distances of the pairs j < i and, with
    the centring, the u-space distances of all pairs, each 3 d operations
    and a compare; the points read once, labels and centred points
    written once."""
    pairs = n * (n - 1) // 2 + (n * n if centre else 0)
    values = n * d * (3 if centre else 1) + n
    return bound(pairs * (3 * d + 1), 4 * values)


def check_radius_graph(kernels, rng, n, d):
    """K8 against its plain version (labels equal, centred points within
    1e-5 relative) and label propagation on the card (labels equal),
    timed; then the rebuild's whole route (one copy there, K8, one fetch
    back) beside the host path it replaces on the card. Returns (max
    |centred - plain|, kernel ms, plain ms, bound ms, what bounds it,
    device ms)."""
    import torch
    from ultranest_torch.evaluate.bench_membership import cuda_ms
    from ultranest_torch.ops import cluster, pairwise
    u, t, r2 = graph_inputs(rng, n, d)
    tt = torch.as_tensor(t, dtype=torch.float32, device='cuda')
    uu = torch.as_tensor(u, dtype=torch.float32, device='cuda')
    out = kernels.radius_graph(tt, uu, r2)
    torch.cuda.synchronize()
    labels, centred = kernels.radius_graph_parts(out, n)
    want_labels, want_centred = kernels.radius_graph_parts(
        kernels.radius_graph_plain(tt, uu, r2), n)
    assert torch.equal(labels, want_labels), ('radius_graph labels', n, d)
    assert np.array_equal(labels.cpu().numpy(),
                          cluster.label_propagation_components(
                              t, r2, device='cuda')), \
        ('radius_graph labels against label propagation', n, d)
    err = float((centred - want_centred).abs().max())
    assert torch.allclose(centred, want_centred, rtol=1e-5, atol=1e-6), \
        ('radius_graph centred', n, d, err)
    ms = cuda_ms(lambda: kernels.radius_graph(tt, uu, r2), 50)
    dev = queued_ms([lambda: kernels.radius_graph(tt, uu, r2)] * 50)
    plain = cuda_ms(lambda: kernels.radius_graph_plain(tt, uu, r2), 5)
    bms, by = graph_bound(n, d)
    route = []
    for fn in (lambda: cluster.radius_graphs(t, r2, u, device='cuda'),
               lambda: (cluster.connected_components(t, r2, device='cpu'),
                        pairwise.subtract_nearby(u, r2, device='cpu'))):
        fn()
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        route.append((time.perf_counter() - t0) * 50)
    print('K8 radius_graph N=%d d=%d: %d components, labels equal to plain '
          'and to label propagation, centred within %.3g of plain; kernel '
          '%.4f ms, device %.4f ms, plain %.4f ms, bound %.6f ms (%s); the '
          'route (copy, K8, fetch) %.4f ms a call, the host path it '
          'replaces %.4f ms' % (n, d, len(torch.unique(labels)), err, ms,
                                dev, plain, bms, by, *route))
    return err, ms, plain, bms, by, dev


def queued_ms(fns):
    """Mean device milliseconds per call of the calls *fns*.

    The calls are enqueued behind a spin kernel (``torch.cuda._sleep``),
    so that the card runs them back to back and the host's enqueue does
    not pace them, as it does in :func:`cuda_ms`'s mean at small shapes.
    NaN (not measured) if the host could not get ahead of the card.
    """
    import torch
    for f in fns[:1]:
        f()
    cycles = 20_000_000
    for _ in range(4):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for f in fns:
            f()
        stop.record()
        behind = not start.query()
        torch.cuda.synchronize()
        if behind:
            return start.elapsed_time(stop) / len(fns)
        cycles *= 4
    return float('nan')


# K3's shapes (npad, P, kind of scan_inputs): an eggbox dispatch (1024
# candidates into 400 live points padded to 512); the population
# paths' (every row a finished walker): P 4096 (asymgauss50), 128
# (rosenbrock8, multishell8), 256 (loggamma30) and 2048 (gauss100) into
# 512, the engine runs' P 64 into 128 (sync, 100 live) and P 128 into
# 256 (200 live); then the edges: every row accepted (the chain's worst
# case), the largest live set in registers (1024) and live sets in
# shared memory (4096 to 32768), no rows, and signed zeros, NaN and inf
# among the live values and rows
SCAN_SHAPES = (
    (512, 1024, 'mixed'), (512, 4096, 'valid'), (512, 128, 'valid'),
    (512, 256, 'valid'), (512, 2048, 'valid'), (128, 64, 'valid'),
    (256, 128, 'valid'), (512, 4096, 'ascending'), (512, 2048, 'ascending'),
    (1024, 1024, 'mixed'), (1024, 2048, 'valid'), (4096, 1024, 'mixed'),
    (16384, 256, 'mixed'), (32768, 256, 'mixed'), (512, 0, 'mixed'),
    (512, 1024, 'special'), (512, 2048, 'special_valid'))


# K3 input kinds: 'mixed' (the first third of the rows valid, 80% of
# those, as an eggbox dispatch), 'valid' (every row a finished walker,
# as on the spec path), 'special' (-0.0 and +0.0 live values, a plateau
# of both at the minimum, and -0.0, +0.0, NaN and +-inf rows; with
# 'valid': every row valid), 'ascending' (every row valid and above the
# one before, so that every row is accepted: the chain's worst case)
def scan_inputs(rng, npad, P, kind='mixed'):
    """(live_L, rows_L, rows_valid) float32 numpy arrays for K3."""
    nlive = npad * 25 // 32
    live_L = np.full(npad, np.inf, np.float32)
    live_L[:nlive] = rng.uniform(-5, 0, nlive).astype(np.float32)
    live_L[[3, 17, 40]] = live_L[:nlive].min() - 1   # plateau at the min
    rows_L = rng.uniform(-5, 2, P).astype(np.float32)
    rows_L[::7] = live_L[rng.randint(nlive, size=len(rows_L[::7]))]  # dups
    rows_L[5:6] = live_L[3]                              # plateau value
    if kind.startswith('special'):
        live_L[:nlive] = np.abs(live_L[:nlive])
        live_L[[3, 17, 40, 66]] = np.array([-0.0, 0.0, -0.0, 0.0],
                                           np.float32)
        rows_L[::5] = np.array([-0.0, 0.0, np.nan, np.inf, -np.inf],
                               np.float32)[np.arange(len(rows_L[::5])) % 5]
    if kind == 'ascending':
        rows_L = np.linspace(-4, 6, P).astype(np.float32)
    rows_valid = np.zeros(P, np.float32)
    if kind in ('valid', 'special_valid', 'ascending'):
        rows_valid[:] = 1.0
    else:
        rows_valid[:P // 3] = rng.uniform(size=P // 3) < 0.8
    return live_L, rows_L, rows_valid


def nseq_of(rows_valid):
    """Rows up to the last valid one (the rows K3 runs in order)."""
    valid = np.nonzero(np.asarray(rows_valid) > 0.5)[0]
    return int(valid.max()) + 1 if len(valid) else 0


def scan_equal(kernels, fn, a):
    """Whether K3 *fn* gives the plain version's live set and records on
    the tensors *a*, bit for bit; returns (equal, the plain records)."""
    want = kernels.consume_scan_plain(*a)
    return bits_equal(fn(*a), want), want[1]


def check_consume_scan(kernels, rng, npad, P, kind='mixed'):
    """K3 against its plain version, bit for bit (signed zeros too), on
    :func:`scan_inputs` of *kind*. Returns (0.0, kernel ms, plain ms,
    bound ms, what bounds it, device ms)."""
    import torch
    from ultranest_torch.evaluate.bench_membership import cuda_ms
    live_L, rows_L, rows_valid = scan_inputs(rng, npad, P, kind)
    a = [torch.as_tensor(x, device='cuda') for x in (live_L, rows_L,
                                                      rows_valid)]
    ok, wrec = scan_equal(kernels, kernels.consume_scan, a)
    assert ok, ('consume_scan records differ', npad, P, kind)
    ms = cuda_ms(lambda: kernels.consume_scan(*a), 50)
    dev = queued_ms([lambda: kernels.consume_scan(*a)] * 50)
    plain = cuda_ms(lambda: kernels.consume_scan_plain(*a), 3)
    bms, by = scan_bound(npad, P, nseq_of(rows_valid))
    print('K3 consume_scan npad=%d P=%d %s: records bit-equal (%d accepted, '
          '%d plateau, %d dup), kernel %.4f ms, device %.4f ms, plain %.4f '
          'ms, bound %.6f ms (%s)' % (
              npad, P, kind, int(wrec[:, 0].sum()),
              int((wrec[:, 4] >= 2).sum()), int((wrec[:, 4] % 2).sum()), ms,
              dev, plain, bms, by))
    return 0.0, ms, plain, bms, by, dev


# --- K4 and K5: the round of the spec walk ---------------------------------

# K4/K5 shapes (P, D, d): asymgauss50, gauss100, loggamma30,
# rosenbrock8 and multishell8, tutorial_highdim, and the async engine
# (the spec walk at D 1, popsize 128, d 8)
SPEC_SHAPES = ((4096, 8, 50), (2048, 8, 100), (256, 8, 30), (128, 8, 8),
               (256, 8, 10), (128, 1, 8))
SPEC_NSTEPS = 100


def values_equal(a, b):
    """Bit equality of two tensors of any dtype (float32 as int32, so
    that -0.0 and +0.0 differ)."""
    import torch
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def spec_round_inputs(rng, P, D, d, nsteps=SPEC_NSTEPS):
    """A spec-walk state mid-dispatch on the card, with walkers done,
    walkers at their last step, points on a face and zero axes in the
    directions; the bank, its row's likelihoods, the filter's rows and
    the threshold (a quarter of the walkers' candidates above it)."""
    import torch
    from ultranest_torch import popfused
    from ultranest_torch.ops import kernels
    f32 = np.float32
    walk = popfused._SpecWalk(P, D, d, nsteps, 8, P, 'cuda')
    st = walk.state
    u = rng.uniform(0.05, 0.95, size=(P, d)).astype(f32)
    u[::7, 0] = 0.0
    v = (rng.normal(size=(P, d)) * 0.1).astype(f32)
    v[::5, 0] = 0.0
    st['u'].copy_(torch.as_tensor(u))
    st['v'].copy_(torch.as_tensor(v))
    tl, tr = kernels.cube_intersection(st['u'], st['v'])
    st['tl'].copy_(tl)
    st['tr'].copy_(tr)
    st['L'].copy_(torch.as_tensor(rng.normal(size=P).astype(f32)))
    step = rng.randint(0, nsteps, size=P)
    step[::9] = nsteps - 1
    st['step'].copy_(torch.as_tensor(step))
    st['done'].copy_(torch.as_tensor(rng.uniform(size=P) < 0.2))
    st['it'].fill_(3)
    xibank = walk.xibank.copy_(torch.as_tensor(
        rng.uniform(size=(8, P, D)).astype(f32)))
    dirbank = (rng.normal(size=(nsteps, P, d)) * 0.1).astype(f32)
    dirbank[:, ::3, 0] = 0.0
    dirbank = walk.dirbank.copy_(torch.as_tensor(dirbank))
    Lp = torch.as_tensor(rng.normal(size=P * D).astype(f32), device='cuda')
    tin = torch.as_tensor(rng.uniform(size=P * D) < 0.9, device='cuda')
    Lmin = torch.tensor(float(np.quantile(Lp.cpu().numpy(), 0.75)),
                        dtype=torch.float32, device='cuda')
    return st, xibank, dirbank, Lp, tin, Lmin


def propose_bound(P, D, d):
    """Bound of K4: it reads u, v, the bracket and the round's row and
    writes the chain, the shrunk bracket and the rows; 3 operations a
    candidate and 2 a row's coordinate."""
    ops = 3 * P * D + 2 * P * D * d
    return bound(ops, 4 * (2 * P * d + 2 * P + P * D) + 8
                 + 4 * (P * D + 2 * P + P * D * d))


def update_bound(P, D, d, tin, before, after):
    """Bound of K5 on these inputs: every walker's likelihoods (and the
    filter's rows) and flag; an accepted walker's chain value, bracket,
    step, point and direction read and its point, likelihood and step
    written, a renewed one's direction row read and its direction and
    bracket written, a rejecting one's shrunk bracket copied; 2
    operations an accepted coordinate, 6 a renewed one."""
    acc = int((after['nw'] - before['nw']).item())
    renew = int(((after['step'] > before['step']) & ~after['done']).sum())
    rej = int(((after['step'] == before['step']) & ~before['done']).sum())
    nbytes = (4 * P * D + (P * D if tin is not None else 0) + 2 * P + 4
              + 4 * P + 32
              + acc * (4 + 8 + 8 + 8 * d + 4 * d + 4 + 8)
              + renew * (8 * d + 8) + rej * 16)
    return bound(2 * acc * d + 6 * renew * d, nbytes)


# device-only ms of K4 and K5 in their first form, before their redesign,
# at each of SPEC_SHAPES (an NVIDIA H100 80GB HBM3 at 700 W; PERF.md's
# kernel table)
FIRST_FORM_DEVICE_MS = {(4096, 8, 50): (0.0174, 0.0056),
                        (2048, 8, 100): (0.0319, 0.0074),
                        (256, 8, 30): (0.0122, 0.0041),
                        (128, 8, 8): (0.0056, 0.0038),
                        (256, 8, 10): (0.0060, 0.0038),
                        (128, 1, 8): (0.0027, 0.0038)}


def spec_instantiations(d, vec):
    """The template instantiations of K4 and K5 that a row of *d* floats
    takes, K4 with *vec* floats a thread (as ptxas_summary names them)."""
    nk = 1 if d <= 32 else 2 if d <= 64 else 4
    return ('spec_propose_kernel<%d>' % vec, 'spec_update_kernel<%d>' % nk)


def graph_ms(fn, calls=50):
    """Device ms of one call of *fn* among *calls* captured in one CUDA
    graph and replayed behind a spin kernel (as the spec walk's graphs
    run the kernels; ``popfused.graph_call_seconds``)."""
    from ultranest_torch import popfused
    t = popfused.graph_call_seconds(fn, 'cuda', calls=calls, reps=2)
    assert t is not None, 'a kernel call could not be captured'
    return 1e3 * t


# rows of directions in a mid-dispatch state (mid_dispatch_update): more
# than the K5 calls one timing makes (graph_ms's warm-up and up to 4 x 5
# x 2 replays of 50 calls, queued_ms's 51)
MID_DISPATCH_STEPS = 2304


def mid_dispatch_update(kernels, st, Lp, tin, ts, tlc, trc, Lmin):
    """K5's arguments on a state mid-dispatch, and its bound there: no
    walker done and none near its last step (:data:`MID_DISPATCH_STEPS`
    rows of directions), so that every call of a timing updates as a
    round does before walkers finish, and each call does the same work
    (the same walkers accept, the same renew), the first call's."""
    import torch
    mid = {k: x.clone() for k, x in st.items()}
    mid['step'].zero_()
    mid['done'].zero_()
    P, d = st['u'].shape
    g = torch.Generator(device='cuda').manual_seed(P + d)
    dirs = 0.1 * torch.randn((MID_DISPATCH_STEPS, P, d), device='cuda',
                             generator=g)
    after = {k: x.clone() for k, x in mid.items()}
    kernels.spec_update_plain(Lp, tin, ts, tlc, trc, Lmin, dirs, after)
    bms = update_bound(P, ts.shape[1], d, tin, mid, after)[0]
    return (Lp, tin, ts, tlc, trc, Lmin, dirs, mid), bms


def check_spec_kernels(kernels, rng, P, D, d, registers=None):
    """K4 and K5 against their plain versions, bit for bit, at one shape,
    with and without the filter's rows; times each on the device alone
    (queued behind a spin kernel, and among 50 calls in a CUDA graph)
    and prints it beside its bound, its share of the bound, its first
    form's time and the registers of its instantiation (*registers*:
    name -> registers, from ptxas); K5 as its first form was timed (on
    a state each call moves on) and in a graph mid-dispatch
    (:func:`mid_dispatch_update`). Returns the two kernels' (0.0, kernel
    ms, plain ms, bound ms, what bounds it, device ms, graph ms)."""
    from ultranest_torch.evaluate.bench_membership import cuda_ms
    st, xibank, dirbank, Lp, tin, Lmin = spec_round_inputs(rng, P, D, d)
    prop = (st['u'], st['v'], st['tl'], st['tr'], xibank, st['it'])
    got = kernels.spec_propose(*prop)
    want = kernels.spec_propose_plain(*prop)
    assert all(values_equal(a, b) for a, b in zip(got, want)), \
        ('spec_propose disagrees', P, D, d)
    ts, tlc, trc, _ = want
    for t in (tin, None):
        mine = {k: x.clone() for k, x in st.items()}
        plain = {k: x.clone() for k, x in st.items()}
        kernels.spec_update(Lp, t, ts, tlc, trc, Lmin, dirbank, mine)
        kernels.spec_update_plain(Lp, t, ts, tlc, trc, Lmin, dirbank, plain)
        bad = [k for k in kernels.SPEC_STATE
               if not values_equal(mine[k], plain[k])]
        assert not bad, ('spec_update disagrees', P, D, d, t is None, bad)
    p_ms = cuda_ms(lambda: kernels.spec_propose(*prop), 50)
    p_dev = queued_ms([lambda: kernels.spec_propose(*prop)] * 50)
    p_graph = graph_ms(lambda: kernels.spec_propose(*prop))
    p_plain = cuda_ms(lambda: kernels.spec_propose_plain(*prop), 5)
    p_bms, p_by = propose_bound(P, D, d)
    u_bms, u_by = update_bound(P, D, d, tin, st, mine)
    # timed on copies: the update moves the walkers on
    scratch = {k: x.clone() for k, x in st.items()}
    upd = (Lp, tin, ts, tlc, trc, Lmin, dirbank, scratch)
    u_ms = cuda_ms(lambda: kernels.spec_update(*upd), 50)
    u_dev = queued_ms([lambda: kernels.spec_update(*upd)] * 50)
    u_graph = graph_ms(lambda: kernels.spec_update(*upd))
    u_plain = cuda_ms(lambda: kernels.spec_update_plain(*upd), 5)
    mid, mid_bms = mid_dispatch_update(kernels, st, Lp, tin, ts, tlc, trc,
                                       Lmin)
    mid_graph = graph_ms(lambda: kernels.spec_update(*mid))
    del mid
    names = spec_instantiations(d, kernels.propose_vector_width(
        d, st['u'], st['v'], got[3]))
    regs = [(registers or {}).get(n) for n in names]
    old = FIRST_FORM_DEVICE_MS.get((P, D, d), (float('nan'),) * 2)
    for i, (k, what, ms, dev, gms, plain_ms, bms, by) in enumerate((
            ('K4', 'spec_propose', p_ms, p_dev, p_graph, p_plain, p_bms,
             p_by),
            ('K5', 'spec_update', u_ms, u_dev, u_graph, u_plain, u_bms,
             u_by))):
        print('%s %s P=%d D=%d d=%d: bit-equal to plain%s, kernel %.4f ms, '
              'device %.4f ms, in a graph %.4f ms, plain %.4f ms, bound '
              '%.6f ms (%s), %.1f%% of the bound, first form device %.4f ms, '
              '%s: %s registers' % (
                  k, what, P, D, d, ' (with and without the filter), %d '
                  'accepted' % int((mine['nw'] - st['nw']).item())
                  if k == 'K5' else '', ms, dev, gms, plain_ms, bms, by,
                  100 * bms / dev, old[i], names[i], regs[i]))
    print('K5 spec_update P=%d D=%d d=%d mid-dispatch: in a graph %.4f ms, '
          'bound %.6f ms, %.1f%% of the bound' % (
              P, D, d, mid_graph, mid_bms, 100 * mid_bms / mid_graph))
    return ((0.0, p_ms, p_plain, p_bms, p_by, p_dev, p_graph),
            (0.0, u_ms, u_plain, u_bms, u_by, u_dev, u_graph))


def check_launch_floor():
    """An empty kernel's device ms among 50 in a CUDA graph, and queued:
    the floor of any launch, which K5's time is set beside (torch's spin
    kernel for 0 clocks, ``torch.cuda._sleep(0)``)."""
    import torch

    def empty():
        torch.cuda._sleep(0)
    g = graph_ms(empty)
    q = queued_ms([empty] * 50)
    print('empty kernel: device %.4f ms, in a graph %.4f ms (the floor of a '
          'launch)' % (q, g))
    return q, g


# --- K6 and K7: the sync and random walks' rounds ---------------------------

# K6 shapes (P, d): the sync engine run (d 2, popsize 64), sync8 (d 8,
# popsize 128), above one block (the boundary's block strides over the
# walkers) at d 50, and an odd P
SYNC_SHAPES = ((64, 2), (128, 8), (4096, 50), (65, 3))
# K7 shapes (P, d): the random-walk engine run (d 8, popsize 128), above
# one block at d 50, an odd P
RWALK_SHAPES = ((128, 8), (4096, 50), (63, 3))
# a 'mid' round's iteration cap: no timing call reaches it
NEVER = 2**30


def sync_round_inputs(rng, P, d, kind, nsteps=16):
    """A sync-walk state on the card and one round's inputs: K4's bank
    rows, the rows' likelihoods, the filter's rows and the threshold
    (three walkers in ten above it), with walkers done, points on a face
    and zero axes. *kind*: 'mid' a round inside a step whose rejecting
    walkers keep rejecting (every call of a timing does the same work,
    and none reaches the iteration cap); 'boundary' a round that ends its
    step (``max_it`` 1, :data:`MID_DISPATCH_STEPS` steps: every call of
    a timing ends a step); 'all_accept' every walker accepting; 'finished'
    a round after the last step. Returns ``(state, tbank, dirbank, Lp,
    tin, Lmin, max_it)``."""
    import torch
    from ultranest_torch import popfused
    from ultranest_torch.ops import kernels
    f32 = np.float32
    max_it = {'mid': NEVER, 'boundary': 1}.get(kind, 8)
    if kind == 'boundary':
        nsteps = MID_DISPATCH_STEPS
    # a sync walk's state and directions; the bank rows are this
    # function's own
    walk = popfused._SyncWalk(P, d, nsteps, 1, 'cuda')
    st = walk.state
    u = rng.uniform(0.05, 0.95, size=(P, d)).astype(f32)
    u[::7, 0] = 0.0
    v = (rng.normal(size=(P, d)) * 0.1).astype(f32)
    v[::5, 0] = 0.0
    st['u'].copy_(torch.as_tensor(u))
    st['v'].copy_(torch.as_tensor(v))
    tl, tr = kernels.cube_intersection(st['u'], st['v'])
    st['tl'].copy_(tl)
    st['tr'].copy_(tr)
    st['un'].copy_(st['u'])
    st['Ln'].copy_(torch.as_tensor(rng.normal(size=P).astype(f32)))
    st['done'].copy_(torch.as_tensor(rng.uniform(size=P) < 0.2))
    s = nsteps if kind == 'finished' else 0
    it = 0 if kind == 'boundary' else 1
    rows = 4 if kind == 'mid' else nsteps * max_it
    st['s'].fill_(s)
    st['it'].fill_(it)
    st['row'].fill_(min(s * max_it + it, rows - 1))
    st['flag'].fill_(kind == 'finished')
    tbank = torch.as_tensor(rng.uniform(size=(rows, P, 1)).astype(f32),
                            device='cuda')
    dirbank = (rng.normal(size=(nsteps, P, d)) * 0.1).astype(f32)
    dirbank[:, ::3, 0] = 0.0
    dirbank = walk.dirbank.copy_(torch.as_tensor(dirbank))
    Lp = rng.normal(size=P).astype(f32)
    if kind == 'all_accept':
        Lp[:] = 5.0
    Lp = torch.as_tensor(Lp, device='cuda')
    tin = torch.as_tensor(rng.uniform(size=P) < 0.9, device='cuda')
    Lmin = torch.tensor(0.5244, dtype=torch.float32, device='cuda')
    return st, tbank, dirbank, Lp, tin, Lmin, max_it


def sync_update_bound(P, d, tin, st, Lp, Lmin, boundary):
    """Bound of K6 on these inputs: every walker's likelihood, slice
    position, shrunk bracket, flag (and filter row) read; an accepting
    walker's point and direction read and its row, likelihood and flag
    written (2 operations a coordinate), a rejecting one's bracket
    written; at a step boundary every width read (1 operation), every
    walker's row and next direction read, its point, direction, chord
    (4 operations a coordinate) and flag written."""
    active = ~st['done']
    acc = int(((Lp > Lmin) & active).sum())
    rej = int(active.sum()) - acc
    nbytes = 17 * P + (P if tin is not None else 0) + 4 + 32 \
        + acc * (12 * d + 5) + rej * 8
    ops = 2 * acc * d
    if boundary:
        nbytes += 8 * P + 16 * P * d + 9 * P + 8
        ops += P + 4 * P * d
    return bound(ops, nbytes)


# K6's forms (kernels.SYNC_FORM_GRID | kernels.SYNC_FORM_RADIX bits):
# the one a shape takes on its own (-1), and each it can take
SYNC_FORMS = {'auto': -1, 'block, rank': 0, 'grid, rank': 1,
              'block, radix': 2, 'grid, radix': 3}


def sync_forms(kernels, P):
    """K6's forms that take P walkers (rank counting takes P <=
    ``kernels.SYNC_RANK_KEYS``)."""
    return {n: f for n, f in SYNC_FORMS.items()
            if f < 0 or f & kernels.SYNC_FORM_RADIX
            or P <= kernels.SYNC_RANK_KEYS}


def check_sync_kernels(kernels, rng, P, d, registers=None, floor=None):
    """K4 at D 1 on the sync walk's bank rows and K6 against their plain
    versions, bit for bit, at one shape: inside a step, at its boundary,
    every walker accepting and a finished round, with and without the
    filter's rows, K6 in each of its forms; times K6 in the form it takes
    (host-paced, on the device alone and among 50 calls in a CUDA graph)
    inside a step and at a boundary, beside the bounds and an empty
    kernel's time in a graph (*floor*), and prints the registers of its
    two instantiations (``scripts/bench_kernels.py --kernel sync_update``
    times every form). Returns (0.0, kernel ms,
    plain ms, bound ms, what bounds it, device ms, graph ms, boundary
    graph ms, boundary bound ms), the first five inside a step."""
    from ultranest_torch.evaluate.bench_membership import cuda_ms
    forms = sync_forms(kernels, P)
    inputs = {}
    for kind in ('mid', 'boundary', 'all_accept', 'finished'):
        st, tbank, dirbank, Lp, tin, Lmin, max_it = inputs[kind] = \
            sync_round_inputs(rng, P, d, kind)
        prop = (st['u'], st['v'], st['tl'], st['tr'], tbank, st['row'])
        got = kernels.spec_propose(*prop)
        want = kernels.spec_propose_plain(*prop)
        assert all(values_equal(a, b) for a, b in zip(got, want)), \
            ('spec_propose disagrees on sync rows', P, d, kind)
        ts, tlc, trc, _ = want
        for t in (tin, None):
            plain = {k: x.clone() for k, x in st.items()}
            kernels.sync_update_plain(Lp, t, ts, tlc, trc, Lmin, dirbank,
                                      max_it, plain)
            for name, form in forms.items():
                mine = {k: x.clone() for k, x in st.items()}
                kernels._sync_update_cuda(Lp, t, ts, tlc, trc, Lmin, dirbank,
                                          max_it, mine, form)
                bad = [k for k in kernels.SYNC_STATE
                       if not values_equal(mine[k], plain[k])]
                assert not bad, ('sync_update disagrees', P, d, kind,
                                 name, t is None, bad)
        inputs[kind] += (ts, tlc, trc)
    out = {}
    for kind in ('mid', 'boundary'):
        st, tbank, dirbank, Lp, tin, Lmin, max_it, ts, tlc, trc = \
            inputs[kind]
        bms, by = sync_update_bound(P, d, tin, st, Lp, Lmin,
                                    kind == 'boundary')

        def args():
            # a fresh copy of the state: every call moves it on
            return (Lp, tin, ts, tlc, trc, Lmin, dirbank, max_it,
                    {k: x.clone() for k, x in st.items()})
        a = args()
        ms = cuda_ms(lambda: kernels.sync_update(*a), 50)
        a = args()
        dev = queued_ms([lambda: kernels.sync_update(*a)] * 50)
        a = args()
        gms = graph_ms(lambda: kernels.sync_update(*a))
        a = args()
        plain_ms = cuda_ms(lambda: kernels.sync_update_plain(*a), 5)
        out[kind] = (ms, dev, gms, plain_ms, bms, by)
    regs = {n: (registers or {}).get(n)
            for n in ('sync_update_kernel<0>', 'sync_update_kernel<1>')}
    for kind, (ms, dev, gms, plain_ms, bms, by) in out.items():
        print('K6 sync_update P=%d d=%d %s: K4 at D 1 and K6 bit-equal to '
              'plain (inside a step, at its boundary, all accepting, '
              'finished; with and without the filter; forms %s), kernel '
              '%.4f ms, device %.4f ms, in a graph %.4f ms (an empty kernel '
              '%.4f), plain %.4f ms, bound %.6f ms (%s), %.1f%% of the bound '
              'in a graph; registers %s'
              % (P, d, 'inside a step' if kind == 'mid' else
                 'at a step boundary', ', '.join(forms), ms, dev, gms,
                 floor if floor is not None else float('nan'), plain_ms,
                 bms, by, 100 * bms / gms, json.dumps(regs)))
    ms, dev, gms, plain_ms, bms, by = out['mid']
    return (0.0, ms, plain_ms, bms, by, dev, gms, out['boundary'][2],
            out['boundary'][4])


def rwalk_round_inputs(rng, P, d):
    """One random-walk step's inputs on the card: proposals inside the
    cube and outside it, on its faces, NaN coordinates, NaN and infinite
    likelihoods, the filter's rows, the threshold, a state, the next
    step's products (a signed zero among them) and the scale."""
    import torch
    f32 = np.float32
    up = rng.uniform(-0.02, 1.02, size=(P, d)).astype(f32)
    up[::3] = rng.uniform(0.2, 0.8, size=up[::3].shape)
    up[1::11] = 0.0
    up[2::13, 0] = np.nan
    Lev = rng.normal(size=P).astype(f32)
    Lev[::19] = np.nan
    Lev[1::23] = np.inf
    st = dict(u=torch.as_tensor(rng.uniform(size=(P, d)).astype(f32),
                                device='cuda'),
              L=torch.as_tensor(rng.normal(size=P).astype(f32),
                                device='cuda'),
              nacc=torch.zeros((), dtype=torch.int64, device='cuda'),
              nc=torch.zeros((), dtype=torch.int64, device='cuda'))
    tin = torch.as_tensor(rng.uniform(size=P) < 0.9, device='cuda')
    Lmin = torch.tensor(-0.5, dtype=torch.float32, device='cuda')
    m = (rng.normal(size=(P, d)) * 0.05).astype(f32)
    m[::5, 0] = -0.0
    scale = torch.tensor(0.1, dtype=torch.float32, device='cuda')
    return (torch.as_tensor(Lev, device='cuda'), tin,
            torch.as_tensor(up, device='cuda'), Lmin, st,
            torch.as_tensor(m, device='cuda'), scale)


def rwalk_accept_bound(P, d, tin, Lev, up, Lmin, proposal=True):
    """Bound of K7 on these inputs: every proposal, likelihood (and filter
    row) read, 2 compares a coordinate; an accepted walker's row and
    likelihood written; with the next *proposal*, the next products
    read, a rejecting walker's point read, the next proposal written,
    a multiply and an add a coordinate."""
    inside = ((up > 0) & (up < 1)).all(dim=1)
    acc = int((inside & (Lev > Lmin)).sum())
    nbytes = 4 * P * d + 4 * P + (P if tin is not None else 0) + 4 + 16 \
        + acc * (4 * d + 4)
    ops = 2 * P * d
    if proposal:
        nbytes += 4 * P * d + 4 * (P - acc) * d + 4 * P * d + 4
        ops += 2 * P * d
    return bound(ops, nbytes)


def rwalk_prologue_bound(P, d):
    """Bound of K7's prologue: the point and the products read, the
    proposal written, a multiply and an add a coordinate."""
    return bound(2 * P * d, 12 * P * d + 4)


def check_rwalk_kernel(kernels, rng, P, d, registers=None, floor=None):
    """K7 against its plain version, bit for bit, at one shape: its
    prologue, a step that writes the next proposal and the last step
    (none), with and without the filter's rows; times the step with its
    proposal (host-paced, on the device alone and among 50 calls in a
    CUDA graph) and the prologue in a graph, beside their bounds and an
    empty kernel's time in a graph (*floor*). Returns (0.0, kernel ms,
    plain ms, bound ms, what bounds it, device ms, graph ms, prologue
    graph ms, prologue bound ms)."""
    from ultranest_torch.evaluate.bench_membership import cuda_ms
    Lev, tin, up, Lmin, st, m, scale = rwalk_round_inputs(rng, P, d)
    mine, plain = up.clone(), up.clone()
    kernels.rwalk_accept(None, None, mine, None, st, m, scale)
    kernels.rwalk_accept_plain(None, None, plain, None, st, m, scale)
    assert values_equal(mine, plain), ('rwalk_accept\'s prologue disagrees',
                                       P, d)
    for t in (tin, None):
        for nxt in (m, None):
            mine = {k: x.clone() for k, x in st.items()}
            plain = {k: x.clone() for k, x in st.items()}
            up_mine, up_plain = up.clone(), up.clone()
            kernels.rwalk_accept(Lev, t, up_mine, Lmin, mine, nxt, scale)
            kernels.rwalk_accept_plain(Lev, t, up_plain, Lmin, plain, nxt,
                                       scale)
            bad = [k for k in kernels.RWALK_STATE
                   if not values_equal(mine[k], plain[k])]
            if not values_equal(up_mine, up_plain):
                bad.append('up')
            assert not bad, ('rwalk_accept disagrees', P, d, t is None,
                             nxt is None, bad)
    bms, by = rwalk_accept_bound(P, d, tin, Lev, up, Lmin)
    pbms = rwalk_prologue_bound(P, d)[0]
    # timed on copies: a step moves the walkers on and rewrites up
    a = (Lev, tin, up.clone(), Lmin, {k: x.clone() for k, x in st.items()},
         m, scale)
    ms = cuda_ms(lambda: kernels.rwalk_accept(*a), 50)
    dev = queued_ms([lambda: kernels.rwalk_accept(*a)] * 50)
    gms = graph_ms(lambda: kernels.rwalk_accept(*a))
    plain_ms = cuda_ms(lambda: kernels.rwalk_accept_plain(*a), 5)
    p = (None, None, up.clone(), None, st, m, scale)
    pgms = graph_ms(lambda: kernels.rwalk_accept(*p))
    print('K7 rwalk_accept P=%d d=%d: the prologue and the step (with its '
          'next proposal and without) bit-equal to plain (with and without '
          'the filter); the step with its proposal: kernel %.4f ms, device '
          '%.4f ms, in a graph %.4f ms (an empty kernel %.4f), plain %.4f '
          'ms, bound %.6f ms (%s), %.1f%% of the bound in a graph; the '
          'prologue in a graph %.4f ms (bound %.6f); registers %s' % (
              P, d, ms, dev, gms,
              floor if floor is not None else float('nan'), plain_ms, bms,
              by, 100 * bms / gms, pgms, pbms,
              (registers or {}).get('rwalk_step_kernel')))
    return (0.0, ms, plain_ms, bms, by, dev, gms, pgms, pbms)


# the kernels each walk launches, by walk, every round (the random walk's
# K7 once more a dispatch, for its prologue)
WALK_KERNELS = dict(spec=('spec_propose', 'spec_update'),
                    sync=('spec_propose', 'sync_update'),
                    rwalk=('rwalk_accept',))


class Walks:
    """Keeps the ``stats`` of every population walk made inside the block
    (``popfused.spec_walk``: the spec and async walks; ``sync_walk``;
    ``rwalk_walk``) and books each kernel's launches by shape: K4 and K5
    of a spec walk under "P,D,d", K4 of a sync walk under "P,1,d", K6
    and K7 (its prologue included) under "P,d"; and the sync walks' step
    boundaries (``nsteps`` a walk) under K6's shape."""

    def __enter__(self):
        from ultranest_torch import popfused
        from ultranest_torch.ops import kernels
        self.mod, self.walks = popfused, collections.defaultdict(list)
        self.orig = {kind: getattr(popfused, kind + '_walk')
                     for kind in WALK_KERNELS}
        self.by_shape = collections.defaultdict(collections.Counter)
        self.boundaries = collections.Counter()

        def recorder(kind, orig):
            def record(*args, **kw):
                if kw.get('stats') is None:
                    kw['stats'] = {}
                banks, d = args[0], args[1].shape[1]
                if kind == 'spec':
                    P, D = banks['xibank'].shape[1:]
                elif kind == 'sync':
                    P, D = banks['tbank'].shape[2], 1
                    self.boundaries['%d,%d' % (P, d)] += \
                        banks['tbank'].shape[0]
                else:
                    P, D = banks['eps'].shape[1], None
                booked = WALK_KERNELS[kind]
                seen = {k: kernels.LAUNCHES[k] for k in booked}
                try:
                    out = orig(*args, **kw)
                finally:
                    # every launch of the walk, its warm-up round and a
                    # walk cut short by the watchdog's deadline included
                    for k in booked:
                        key = '%d,%d,%d' % (P, D, d) \
                            if k in ('spec_propose', 'spec_update') \
                            else '%d,%d' % (P, d)
                        self.by_shape[k][key] += kernels.LAUNCHES[k] - seen[k]
                self.walks[kind].append(kw['stats'])
                return out
            return record
        for kind, orig in self.orig.items():
            setattr(popfused, kind + '_walk', recorder(kind, orig))
        return self

    def __exit__(self, *exc):
        for kind, orig in self.orig.items():
            setattr(self.mod, kind + '_walk', orig)

    def summary(self):
        """Per walk kind: walks, those run as graphs and from the host
        loop, rounds, replays, captures and capture seconds; each
        kernel's launches by shape (its launches over each walk), and
        the sync walks' step boundaries by shape."""
        kinds = {}
        for kind, ws in self.walks.items():
            w = [s for s in ws if 'graph' in s]
            kinds[kind] = dict(
                walks=len(w), graph=sum(bool(s['graph']) for s in w),
                host_loop=sum(not s['graph'] for s in w),
                rounds=sum(s['rounds'] for s in w),
                replays=sum(s['replays'] for s in w),
                captures=sum(s['captures'] for s in w),
                capture_s=sum(s['capture_s'] for s in w))
        return dict(kinds=kinds,
                    launches_by_shape={k: dict(v) for k, v in
                                       self.by_shape.items() if v},
                    boundaries=dict(self.boundaries))


# each path's kernel launches by shape and the sync walks' step
# boundaries by shape, booked by check_walk_path, for the ranking
# (walk_gaps)
WALK_LAUNCHES = {}
SYNC_BOUNDARIES = {}


def check_walk_path(name, walks, launched, required=()):
    """A path's population walks all ran as CUDA graphs; each walk kind
    of *required* ('spec', 'sync', 'rwalk') ran some, and launched its
    kernels in each round. Books the path's launches by shape in
    :data:`WALK_LAUNCHES` and its step boundaries in
    :data:`SYNC_BOUNDARIES`."""
    kinds = walks['kinds']
    for kind, w in kinds.items():
        assert w['host_loop'] == 0, \
            ('a %s walk fell back to the host loop' % kind, name, w)
    for kind in required:
        w = kinds.get(kind, dict(graph=0, rounds=0))
        assert w['graph'] > 0, ('no %s walk ran as graphs' % kind, name)
        # the random walk's K7 launches once more a walk, its prologue
        prologues = w['graph'] if kind == 'rwalk' else 0
        for k in WALK_KERNELS[kind]:
            assert launched.get(k, 0) >= w['rounds'] + prologues > 0, \
                ('%s not launched on the %s walks' % (k, kind), name,
                 launched)
    if walks['launches_by_shape']:
        WALK_LAUNCHES[name] = walks['launches_by_shape']
    if walks['boundaries']:
        SYNC_BOUNDARIES[name] = walks['boundaries']
    for kind, w in sorted(kinds.items()):
        if w['walks']:
            print('%s %s walks: %d dispatches as CUDA graphs, %d rounds, %d '
                  'replays, %d captures in %.3f s' % (
                      name, kind, w['graph'], w['rounds'], w['replays'],
                      w['captures'], w['capture_s']))


class DepthProbes:
    """Records, inside the block, the spec-depth probe's decision of
    every sampler that makes one
    (``FusedPopulationSliceSampler._resolve_spec_depth``), under the name
    in :attr:`path`, and prints one line for each: the depth chosen,
    t_row (the likelihood's device seconds per popsize batch), its
    fixed cost a call (and how both were taken) and A
    (``ROUND_OVERHEAD_S``)."""

    def __init__(self):
        self.path, self.rows = None, []

    def __enter__(self):
        from ultranest_torch.popfused import FusedPopulationSliceSampler
        self.cls = FusedPopulationSliceSampler
        self.orig = FusedPopulationSliceSampler._resolve_spec_depth
        probes = self

        def resolve(sampler, x_dim):
            fresh = not sampler._depth_resolved
            probes.orig(sampler, x_dim)
            if fresh and sampler.spec_probe is not None:
                p = sampler.spec_probe
                probes.rows.append(dict(path=probes.path, x_dim=x_dim,
                                        popsize=sampler.popsize, **p))
                print('spec depth (%s): popsize %d, d %d: depth %d -> %d, '
                      't_row %.6f ms a batch, the likelihood\'s fixed cost '
                      '%.6f ms a call (%s), A %.6f ms' % (
                          probes.path, sampler.popsize, x_dim,
                          p['depth_from'], p['depth'], 1e3 * p['t_row_s'],
                          1e3 * p['fixed_s'], p['how'],
                          1e3 * p['round_overhead_s']))
        FusedPopulationSliceSampler._resolve_spec_depth = resolve
        return self

    def __exit__(self, *exc):
        self.cls._resolve_spec_depth = self.orig


def measure_round_overheads(names):
    """A, one replayed round without the likelihood
    (``popfused.measure_round_overhead``), at each spec problem's shape
    (popsize, depth 8, d, nsteps); prints them beside
    ``ROUND_OVERHEAD_S``. Returns {name: seconds}."""
    from ultranest_torch import popfused
    from ultranest_torch.models import problems
    out = {}
    for name in names:
        (factory, kw), popsize, nsteps = POPULATION_PROBLEMS[name][:3]
        ndim = getattr(problems, factory)(**kw).ndim
        out[name] = popfused.measure_round_overhead(popsize, 8, ndim, nsteps)
    print('A, a replayed round without the likelihood (K4, K5, the width '
          'sum, an eighth of the flag; popfused.measure_round_overhead), ms: '
          '%s; mean %.6f ms; popfused.ROUND_OVERHEAD_S %.6f ms' % (
              ', '.join('%s %.6f' % (k, 1e3 * v) for k, v in out.items()),
              1e3 * np.mean(list(out.values())),
              1e3 * popfused.ROUND_OVERHEAD_S))
    return out


class DispatchKeeper:
    """Keeps the inputs of the *index*-th walk of a population sampler
    made inside the block (``FusedPopulationSliceSampler._walk``, or
    ``FusedPopulationRandomWalkSampler._walk`` with *rwalk*)."""

    def __init__(self, index, rwalk=False):
        self.index, self.count, self.kept = index, 0, None
        self.rwalk = rwalk

    def __enter__(self):
        from ultranest_torch import popfused
        self.cls = popfused.FusedPopulationRandomWalkSampler if self.rwalk \
            else popfused.FusedPopulationSliceSampler
        self.orig = self.cls.__dict__['_walk']
        keeper = self

        def keep(sampler, banks, live_u, live_L, nlive, axes, Lmin, scale,
                 treg):
            if keeper.count == keeper.index:
                def c(x):
                    return x.clone() if hasattr(x, 'clone') else x
                keeper.kept = dict(
                    sampler=sampler, banks={k: c(x) for k, x in banks.items()},
                    live_u=c(live_u), live_L=c(live_L), nlive=nlive,
                    axes=c(axes), Lmin=c(Lmin), scale=scale, treg=c(treg),
                    nsteps=sampler.nsteps, treg_key=sampler._treg_key)
            keeper.count += 1
            return keeper.orig(sampler, banks, live_u, live_L, nlive, axes,
                               Lmin, scale, treg)
        self.cls._walk = keep
        return self

    def __exit__(self, *exc):
        self.cls._walk = self.orig


def check_walk_traffic(kernels, name, kept):
    """One real dispatch, kept by :class:`DispatchKeeper`: run from the
    host loop with K4 and K5, each call held against the plain versions
    bit for bit; then as CUDA graphs (a first run captures, a second
    replays), whose uf, Lf, done, nc, nuseful and width must be the host
    loop's bits. Prints rounds and wall per round of both."""
    import torch
    from ultranest_torch import popfused
    from ultranest_torch.fused import _f32
    s = kept['sampler']
    saved, s._treg_key = s._treg_key, kept['treg_key']
    ev = s._treg_eval()
    s._treg_key = saved
    banks, treg = kept['banks'], kept['treg']
    P = banks['xibank'].shape[1]
    args = (banks, kept['live_u'], kept['live_L'], kept['nlive'],
            kept['axes'], kept['Lmin'], _f32(kept['scale']))
    calls = dict(spec_propose=0, spec_update=0)
    orig_p, orig_u = kernels.spec_propose, kernels.spec_update

    def propose(*a):
        got = orig_p(*a)
        want = kernels.spec_propose_plain(*a)
        assert all(values_equal(x, y) for x, y in zip(got, want)), \
            ('spec_propose disagrees on real traffic', name,
             calls['spec_propose'])
        calls['spec_propose'] += 1
        return got

    def update(Lp, tin, ts, tlc, trc, Lmin, dirbank, st):
        plain = {k: x.clone() for k, x in st.items()}
        orig_u(Lp, tin, ts, tlc, trc, Lmin, dirbank, st)
        kernels.spec_update_plain(Lp, tin, ts, tlc, trc, Lmin, dirbank,
                                  plain)
        bad = [k for k in kernels.SPEC_STATE
               if not values_equal(st[k], plain[k])]
        assert not bad, ('spec_update disagrees on real traffic', name,
                         calls['spec_update'], bad)
        calls['spec_update'] += 1

    kernels.spec_propose, kernels.spec_update = propose, update
    host = {}
    try:
        want = popfused.spec_walk(*args, lambda r: ev(r, treg),
                                  kept['nsteps'], target_done=P, stats=host)
        torch.cuda.synchronize()
    finally:
        kernels.spec_propose, kernels.spec_update = orig_p, orig_u
    assert calls['spec_propose'] == calls['spec_update'] == host['rounds']
    t0 = time.perf_counter()
    popfused.spec_walk(*args, lambda r: ev(r, treg), kept['nsteps'],
                       target_done=P)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    graphs = popfused.SpecGraphs(name)
    treg_s = graphs.static('treg', treg)
    runs = []
    for _ in range(2):
        st = {}
        t0 = time.perf_counter()
        got = popfused.spec_walk(*args, lambda r: ev(r, treg_s),
                                 kept['nsteps'], target_done=P, stats=st,
                                 graphs=graphs)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0, st))
        for i in (0, 1, 2, 4, 5, 6):
            assert values_equal(got[i], want[i]), \
                ('the graph dispatch differs from the host loop', name, i)
        assert st['graph'] and st['rounds'] == host['rounds']
    (cap_wall, cap), (rep_wall, rep) = runs
    print('%s real dispatch (P %d, D %d, d %d, nsteps %d, %d rounds): every '
          'K4 and K5 call bit-equal to plain (%d each); host loop %.4f ms a '
          'round; as CUDA graphs uf, Lf, done, nc, nuseful and width '
          'bit-equal to the host loop, %.4f ms a round replayed (%d '
          'replays), first run %.3f s with %d captures in %.3f s' % (
              name, P, banks['xibank'].shape[2], kept['live_u'].shape[1],
              kept['nsteps'], host['rounds'], calls['spec_propose'],
              1e3 * host_s / host['rounds'], 1e3 * rep_wall / rep['rounds'],
              rep['replays'], cap_wall, cap['captures'], cap['capture_s']))
    return dict(rounds=host['rounds'], host_ms_per_round=1e3 * host_s
                / host['rounds'], graph_ms_per_round=1e3 * rep_wall
                / rep['rounds'])


def engine_graph_nodes(kernels, kind, banks, live_u, live_L, axes, Lmin,
                       scale, evaluate):
    """The kernel nodes of a real dispatch's round (sync) or walk (random
    walk), each captured in a CUDA graph and read from it
    (``ultranest_torch.evaluate.graph_nodes``), beside the likelihood's own nodes:
    a sync round must be K4, the likelihood's kernels and one K6; the
    random walk its products, K7's prologue and, a step, the likelihood's
    kernels and K7, nothing else. Returns the counts by part."""
    from ultranest_torch import popfused
    from ultranest_torch.evaluate.graph_nodes import \
        graph_kernel_names as names
    dev, d = live_u.device, live_u.shape[1]

    def count(nodes, kernel):
        return sum(kernel in n for n in nodes)
    if kind == 'sync':
        nsteps, max_it, P = banks['tbank'].shape
        walk = popfused._SyncWalk(P, d, nsteps, max_it, dev)
    else:
        nsteps, P, _ = banks['eps'].shape
        walk = popfused._RwalkWalk(P, d, nsteps, dev)
    walk.load(banks, live_u, live_L, axes, Lmin, scale, evaluate)
    walk.init()
    walk.round()                # the likelihood's first calls, eagerly
    if kind == 'sync':
        st = walk.state
        up = kernels.spec_propose(st['u'], st['v'], st['tl'], st['tr'],
                                  walk.tbank, st['row'])[3]
        round_nodes = names(walk.round, dev)
        like = names(lambda: evaluate(up), dev)
        out = dict(round=len(round_nodes), likelihood=len(like),
                   K4=count(round_nodes, 'spec_propose_kernel'),
                   K6=count(round_nodes, 'sync_update_kernel'))
        out['other'] = out['round'] - out['likelihood'] - out['K4'] - \
            out['K6']
        assert out['K4'] == out['K6'] == 1 and out['other'] == 0, \
            ('a sync round is not K4, the likelihood and one K6', out,
             round_nodes)
        return out
    walk_nodes = names(walk.round, dev)
    products = names(lambda: popfused._rwalk_products(walk.eps, walk.axes,
                                                      walk.m), dev)
    like = names(lambda: evaluate(walk.up), dev)
    k7 = count(walk_nodes, 'rwalk_step_kernel')
    out = dict(walk=len(walk_nodes), products=len(products),
               likelihood=len(like), K7=k7, steps=nsteps,
               step=(len(walk_nodes) - len(products) - 1) / nsteps)
    out['other'] = len(walk_nodes) - len(products) - 1 - \
        nsteps * (len(like) + 1)
    assert k7 == nsteps + 1 and out['other'] == 0, \
        ('a random-walk step is not the likelihood and K7', out, walk_nodes)
    return out


def check_engine_traffic(kernels, name, kept):
    """One real dispatch of a sync or random-walk engine run, kept by
    :class:`DispatchKeeper`: run from the host loop with K4 and K6 (or
    K7, its prologue included), each call held against the plain
    versions bit for bit; then as CUDA graphs (a first run captures, a
    second replays), whose outputs must be the host loop's bits; then the
    kernel nodes of its round or step (:func:`engine_graph_nodes`).
    Prints rounds and wall per round of both; returns them."""
    import torch
    from ultranest_torch import popfused
    from ultranest_torch.fused import _f32
    s = kept['sampler']
    saved, s._treg_key = s._treg_key, kept['treg_key']
    ev = s._treg_eval()
    s._treg_key = saved
    banks, treg = kept['banks'], kept['treg']
    kind = 'sync' if 'tbank' in banks else 'rwalk'
    walk = getattr(popfused, kind + '_walk')
    args = (banks, kept['live_u'], kept['live_L'], kept['axes'],
            kept['Lmin'], _f32(kept['scale']))
    calls = collections.Counter()
    wrapped = ('spec_propose', 'sync_update', 'rwalk_accept')
    orig = {k: getattr(kernels, k) for k in wrapped}

    def propose(*a):
        got = orig['spec_propose'](*a)
        want = kernels.spec_propose_plain(*a)
        assert all(values_equal(x, y) for x, y in zip(got, want)), \
            ('spec_propose disagrees on real traffic', name,
             calls['spec_propose'])
        calls['spec_propose'] += 1
        return got

    def sync_update(*a):
        st = a[-1]
        plain = {key: x.clone() for key, x in st.items()}
        orig['sync_update'](*a)
        kernels.sync_update_plain(*a[:-1], plain)
        bad = [key for key in kernels.SYNC_STATE
               if not values_equal(st[key], plain[key])]
        assert not bad, ('sync_update disagrees on real traffic', name,
                         calls['sync_update'], bad)
        calls['sync_update'] += 1

    def rwalk_accept(Lev, tin, up, Lmin, st, m=None, scale=None):
        plain = {key: x.clone() for key, x in st.items()}
        up_plain = up.clone()
        orig['rwalk_accept'](Lev, tin, up, Lmin, st, m, scale)
        kernels.rwalk_accept_plain(Lev, tin, up_plain, Lmin, plain, m, scale)
        bad = [key for key in kernels.RWALK_STATE
               if not values_equal(st[key], plain[key])]
        if not values_equal(up, up_plain):
            bad.append('up')
        assert not bad, ('rwalk_accept disagrees on real traffic', name,
                         calls['rwalk_accept'], bad)
        calls['rwalk_accept'] += 1
        calls['prologue'] += Lev is None
    checks = dict(spec_propose=propose, sync_update=sync_update,
                  rwalk_accept=rwalk_accept)
    for k in wrapped:
        setattr(kernels, k, checks[k])
    host = {}
    try:
        want = walk(*args, lambda r: ev(r, treg), stats=host)
        torch.cuda.synchronize()
    finally:
        for k, f in orig.items():
            setattr(kernels, k, f)
    # the random walk's K7 once more, for its prologue
    prologues = int(kind == 'rwalk')
    for k in WALK_KERNELS[kind]:
        assert calls[k] == host['rounds'] + prologues, (k, dict(calls), host)
    assert calls['prologue'] == prologues, dict(calls)
    t0 = time.perf_counter()
    walk(*args, lambda r: ev(r, treg))
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    graphs = popfused.SpecGraphs(name)
    treg_s = graphs.static('treg', treg)
    runs = []
    for _ in range(2):
        st = {}
        t0 = time.perf_counter()
        got = walk(*args, lambda r: ev(r, treg_s), stats=st, graphs=graphs)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0, st))
        for i, (a, b) in enumerate(zip(got, want)):
            assert values_equal(a, b), \
                ('the graph dispatch differs from the host loop', name, i)
        assert st['graph'] and st['rounds'] == host['rounds']
    (cap_wall, cap), (rep_wall, rep) = runs
    nodes = engine_graph_nodes(kernels, kind, *args,
                               lambda r: ev(r, treg_s))
    P, d = banks['idx0'].shape[0], kept['live_u'].shape[1]
    print('%s real dispatch (P %d, d %d, %d rounds): every %s call bit-equal '
          'to plain (%d each); host loop %.4f ms a round; as CUDA graphs '
          'every output bit-equal to the host loop, %.4f ms a round replayed '
          '(%d replays), first run %.3f s with %d captures in %.3f s; kernel '
          'nodes in a captured graph: %s' % (
              name, P, d, host['rounds'], ' and '.join(WALK_KERNELS[kind]),
              calls[WALK_KERNELS[kind][-1]], 1e3 * host_s / host['rounds'],
              1e3 * rep_wall / rep['rounds'], rep['replays'], cap_wall,
              cap['captures'], cap['capture_s'], json.dumps(nodes)))
    return dict(rounds=host['rounds'], host_ms_per_round=1e3 * host_s
                / host['rounds'], graph_ms_per_round=1e3 * rep_wall
                / rep['rounds'], nodes=nodes)


class KernelCapture:
    """Keeps a copy of the inputs of every K1, K2 and K3 call made inside
    the block.

    Wraps the wrappers of :mod:`ultranest_torch.ops.kernels` through
    which the paths reach the kernels; each call still launches its
    kernel once. The copies (``calls``, by kernel name) are a path's real
    traffic for :func:`check_scan_traffic`, :func:`check_member_traffic`
    and :func:`check_bootstrap_traffic`.
    """

    NAMES = ('consume_scan', 'radius_member', 'bootstrap_radius')

    def __init__(self, kernels):
        self.kernels = kernels
        self.calls = {name: [] for name in self.NAMES}

    def __enter__(self):
        import torch
        self.orig = {name: getattr(self.kernels, name) for name in self.NAMES}

        def wrap(name, orig):
            def capture(*args):
                self.calls[name].append(tuple(
                    a.clone() if torch.is_tensor(a) else a for a in args))
                return orig(*args)
            return capture

        for name, orig in self.orig.items():
            setattr(self.kernels, name, wrap(name, orig))
        return self

    def __exit__(self, *exc):
        for name, orig in self.orig.items():
            setattr(self.kernels, name, orig)


def check_scan_traffic(kernels, name, calls):
    """K3 on a path's real calls: the records of its first, middle and
    last call held against the plain version bit for bit, then every
    call replayed in order, timed as a mean per call with CUDA events
    (host-paced, and on the device alone with :func:`queued_ms`), beside
    the mean bound of its calls and the share of valid rows accepted.
    Returns these numbers as a dict."""
    for k in sorted({0, len(calls) // 2, len(calls) - 1}):
        assert scan_equal(kernels, kernels.consume_scan, calls[k])[0], \
            ('consume_scan records differ on a real call', name, k)
    nseqs = [nseq_of(c[2].cpu().numpy()) for c in calls]
    nvalid = sum(int((c[2] > 0.5).sum()) for c in calls)
    naccept = sum(int(kernels.consume_scan(*c)[1][:, 0].sum())
                  for c in calls)
    ms, dev = replay_ms(kernels.consume_scan, calls)
    out = dict(
        calls=len(calls), P=sorted({int(c[1].shape[0]) for c in calls}),
        npad=sorted({int(c[0].shape[0]) for c in calls}),
        valid_rows=nvalid, accepted=naccept,
        ms=ms, device_ms=dev,
        bound_ms=float(np.mean([scan_bound(int(c[0].shape[0]),
                                           int(c[1].shape[0]), n)[0]
                                for c, n in zip(calls, nseqs)])))
    print('K3 on %s\'s %d real calls (npad %s, P %s): records bit-equal at '
          'the first, middle and last call; %d of %d valid rows accepted '
          '(%.1f%%); per call kernel %.4f ms, device %.4f ms, bound %.6f ms'
          % (name, out['calls'], out['npad'], out['P'], naccept, nvalid,
             100.0 * naccept / max(nvalid, 1), out['ms'], out['device_ms'],
             out['bound_ms']))
    return out


# calls queued behind one spin for the device-only time: the launch
# queue holds about a thousand kernels (K2 launches two a call), and the
# host cannot get ahead of a full queue
QUEUED_CALLS = 256


def replay_ms(fn, calls):
    """(CUDA-event ms, device-only ms) per call of *fn* over *calls*, each
    call replayed in order, repeated to at least 50 calls; the device-only
    time over the first :data:`QUEUED_CALLS` of them."""
    from ultranest_torch.evaluate.bench_membership import cuda_ms
    fns = [lambda c=c: fn(*c) for c in calls]
    reps = max(1, -(-50 // len(calls)))
    return (cuda_ms(lambda: [f() for f in fns], reps) / len(calls),
            queued_ms((fns * reps)[:QUEUED_CALLS]))


def member_call_bound(kernels, call):
    """Bound (ms) of one K1 call from its own valid rows and members."""
    tpoints, tmask, cands, r2 = call
    nmember = int(kernels.radius_member_plain(*call).sum())
    return member_bound(tpoints.shape[0], int((tmask != 0).sum()),
                        cands.shape[0], tpoints.shape[1], nmember)[0]


def check_member_traffic(kernels, name, calls):
    """K1 on a path's real calls: every call equal to the plain version,
    then the calls replayed in order and by candidate count M, timed as a
    mean per call (host-paced, and on the device alone) beside the mean
    bound of those calls' own valid rows and members. Returns these
    numbers as a dict (``by_m``: M -> calls, device ms, bound ms)."""
    for k, c in enumerate(calls):
        assert bool((kernels.radius_member(*c) ==
                     kernels.radius_member_plain(*c)).all()), \
            ('radius_member disagrees on a real call', name, k)
    bounds = [member_call_bound(kernels, c) for c in calls]
    ms, dev = replay_ms(kernels.radius_member, calls)
    by_m = {}
    for m in sorted({int(c[2].shape[0]) for c in calls}):
        idx = [k for k, c in enumerate(calls) if c[2].shape[0] == m]
        by_m[m] = dict(
            calls=len(idx),
            device_ms=replay_ms(kernels.radius_member,
                                [calls[k] for k in idx])[1],
            bound_ms=float(np.mean([bounds[k] for k in idx])))
    out = dict(calls=len(calls), ms=ms, device_ms=dev,
               bound_ms=float(np.mean(bounds)), by_m=by_m,
               npad=sorted({int(c[0].shape[0]) for c in calls}),
               d=int(calls[0][0].shape[1]))
    print('K1 on %s\'s %d real calls (npad %s, d %d): every call equal to '
          'plain; per call kernel %.4f ms, device %.4f ms, bound %.6f ms; by '
          'M: %s' % (name, out['calls'], out['npad'], out['d'], ms, dev,
                     out['bound_ms'], '; '.join(
                         'M %d x %d device %.4f ms (bound %.6f)' % (
                             m, r['calls'], r['device_ms'], r['bound_ms'])
                         for m, r in by_m.items())))
    return out


def check_bootstrap_traffic(kernels, name, calls):
    """K2 on a path's real calls: every call bit-equal to the plain
    version, then the calls replayed in order, timed as a mean per call
    (host-paced, and on the device alone) beside the mean bound of those
    calls' own masks. Returns these numbers as a dict."""
    for k, c in enumerate(calls):
        assert bits_equal(kernels.bootstrap_radius(*c),
                          kernels.bootstrap_radius_plain(*c)), \
            ('bootstrap_radius disagrees on a real call', name, k)
    d = int(calls[0][0].shape[1])
    ms, dev = replay_ms(kernels.bootstrap_radius, calls)
    out = dict(
        calls=len(calls), ms=ms, device_ms=dev, d=d,
        bound_ms=float(np.mean([bootstrap_bound(c[1], c[2], d)[0]
                                for c in calls])),
        npad=sorted({int(c[0].shape[0]) for c in calls}),
        nvalid=sorted({int(c[1].sum()) for c in calls}),
        rounds=sorted({int(c[2].shape[0]) for c in calls}))
    print('K2 on %s\'s %d real calls (npad %s, valid rows %s, rounds %s, d '
          '%d): every call bit-equal to plain; per call kernel %.4f ms, '
          'device %.4f ms, bound %.6f ms' % (
              name, out['calls'], out['npad'], out['nvalid'], out['rounds'],
              d, ms, dev, out['bound_ms']))
    return out


def run_eggbox(seed=42, keep=None, mesh=None):
    """One eggbox run at the bench configuration on the card.

    *keep*, a list, receives the finished sampler (for the plots). With a
    *mesh* the run is sharded (``ReactiveNestedSampler(mesh=)``): it takes
    the classic budgeted path, K1 in every dispatch and K2 in every
    rebuild, the consumption on the host, and its ncall must be the 400
    root evaluations plus the summed billed counts of its dispatches.

    Every kernel count is set to 0 just before the run and read just
    after it. Raises if logZ is outside the bench gate, the posterior
    samples are malformed, the segment path never engaged (without a
    mesh) or a kernel of the path was never launched; returns the run's
    summary.
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
        ndraw_min=4096, ndraw_max=32768, mesh=mesh)
    billed = []
    unpack = sampler.fused_sampler._unpack

    def counted(*args):
        out = unpack(*args)
        billed.append(out[3])
        return out
    sampler.fused_sampler._unpack = counted
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
               classic_dispatches=len(billed), billed=sum(billed),
               launches=dict(kernels.LAUNCHES))
    assert abs(res['logz'] - EGGBOX_LOGZ) < max(4 * res['logzerr'], 1.0), \
        ('eggbox logZ outside the gate', res['logz'], res['logzerr'])
    assert np.isfinite(res['samples']).all() and \
        res['samples'].shape[1] == 2, 'bad posterior samples'
    if mesh is None:
        assert out['segment_exits'], 'the segment path never engaged'
        path_kernels = kernels.REGION_KERNELS
    else:
        assert not out['segment_exits'], 'a sharded run took the segment path'
        assert out['ncall'] == out['billed'] + 400, \
            ('ncall is not the root points plus the billed counts',
             out['ncall'], out['billed'])
        path_kernels = ('radius_member', 'bootstrap_radius')
    for name in path_kernels:
        assert out['launches'].get(name, 0) > 0, ('kernel not launched',
                                                  name)
    if keep is not None:
        keep.append(sampler)
    return out


# K1t's shapes (N, M, d) beside the shootout's three: d 40 (above d 32
# the block stages its candidates in shared memory) and 32768 live rows
# (in tiles)
MEMBER_T_EXTRA_SHAPES = ((512, 4096, 40), (32768, 4096, 2))


def check_member_t_groups(kernels, npts, m, d):
    """K1t with every group size 1 to 32 forced, against its plain
    version at 65 boundary radii, on the shootout's inputs with a mask
    of 1, 1, 0, -1, ...: a negative entry is an invalid row for K1t.
    Returns the number of boundary candidates checked."""
    import torch
    from ultranest_torch.evaluate import bench_membership
    tp, _, cd, _ = bench_membership.make_inputs(npts, m, d)
    tm = np.array([1, 1, 0, -1], np.int32)[np.arange(npts) % 4]
    tp_d, tm_d, cd_d = (torch.as_tensor(a, device='cuda')
                        for a in (tp, tm, cd))
    tp_t, cd_t = tp_d.T.contiguous(), cd_d.T.contiguous()
    radii, mind = bench_membership.boundary_radii(tp_d[tm_d > 0], cd_d)
    nboundary, sign_matters = 0, False
    for r2 in radii:
        want = kernels.radius_member_t_plain(tp_t, tm_d, cd_t, r2)
        for group in (1, 2, 4, 8, 16, 32):
            got = kernels._radius_member_t_cuda(tp_t, tm_d, cd_t, r2, group)
            nmis = int((got != want).sum())
            assert nmis == 0, ('radius_member_t disagrees', npts, m, d, r2,
                               group, nmis)
        on = mind == r2
        assert bool(on.any()) and bool(want[on].all()), \
            ('no member on the boundary', npts, m, d, r2)
        nboundary += int(on.sum())
        # the same rows with -1 taken for valid give another answer
        sign_matters |= not torch.equal(want, kernels.radius_member_t_plain(
            tp_t, tm_d.abs(), cd_t, r2))
    assert sign_matters, 'the mask\'s negative entries changed nothing'
    print('K1t radius_member_t N=%d M=%d d=%d, mask of 1, 1, 0, -1: equal to '
          'the plain version at %d radii for each group size 1, 2, 4, 8, 16, '
          '32, %d candidates exactly on the boundary' % (
              npts, m, d, len(radii), nboundary))
    return nboundary


def check_membership_shootout(kernels):
    """K1t phase: equality at the shootout's shapes, then its main path.

    Holds K1 and K1t against the plain version at 65 boundary radii per
    shape, and K1t with every group size forced and a signed mask, also
    at :data:`MEMBER_T_EXTRA_SHAPES` (those launches are comparisons),
    then sets the counts to 0 and runs the shootout's timing, the path
    that launches K1t, and reads K1t's count; then times K1t and K1 on
    the device alone, beside the bound at each radius.
    Returns (per-shape timing rows, K1t launches of that run).
    """
    import torch
    from ultranest_torch.evaluate import bench_membership
    for shape in bench_membership.SHAPES + MEMBER_T_EXTRA_SHAPES:
        check_member_t_groups(kernels, *shape)
    for npts, m, d in bench_membership.SHAPES:
        nb = bench_membership.check_shape(npts, m, d, 'cuda')
        print('K1t radius_member_t N=%d M=%d d=%d: K1t and K1 equal to the '
              'plain version at 65 radii, %d candidates exactly on the '
              'boundary' % (npts, m, d, nb))
    kernels.reset_counts()
    rows = bench_membership.run()
    launches = kernels.LAUNCHES['radius_member_t']
    assert launches > 0, 'the shootout never launched K1t'
    for row in rows:
        # the bound at the shootout's own radius, r2 = 4 d
        tp, tm, cd, r2 = bench_membership.make_inputs(row['npts'], row['m'],
                                                      row['d'])
        nmember = int(kernels.radius_member_plain(
            *(torch.as_tensor(a, device='cuda') for a in (tp, tm, cd)),
            float(r2)).sum())
        row['bound_ms'], row['bound_by'] = member_bound(
            row['npts'], row['npts'], row['m'], row['d'], nmember)
        # on the device alone, at the shootout's radius (where almost
        # every candidate has a hit within the first rows, so the time
        # is the launch's floor) and at the candidates' median nearest
        # distance (half of them walk every row): K1t beside K1
        tp_d, tm_d, cd_d = (torch.as_tensor(a, device='cuda')
                            for a in (tp, tm, cd))
        tp_t, cd_t = tp_d.T.contiguous(), cd_d.T.contiguous()
        r2m = bench_membership.boundary_radii(tp_d, cd_d, nradii=3)[0][1]
        row['nmember_median'] = int(kernels.radius_member_plain(
            tp_d, tm_d, cd_d, r2m).sum())
        row['bound_ms_median'], row['bound_by_median'] = member_bound(
            row['npts'], row['npts'], row['m'], row['d'],
            row['nmember_median'])
        for key, radius in (('', float(r2)), ('_median', r2m)):
            row['k1t_device_ms' + key] = queued_ms(
                [lambda: kernels.radius_member_t(tp_t, tm_d, cd_t,
                                                 radius)] * 50)
            row['k1_device_ms' + key] = queued_ms(
                [lambda: kernels.radius_member(tp_d, tm_d, cd_d,
                                               radius)] * 50)
        print('K1t radius_member_t N=%d M=%d d=%d at r2 = 4 d: %d of %d '
              'candidates inside, bound %.6f ms (%s), device %.4f ms (K1 '
              '%.4f); at the median nearest distance: %d inside, bound %.6f '
              'ms (%s), device %.4f ms (K1 %.4f), G %d' % (
                  row['npts'], row['m'], row['d'], nmember, row['m'],
                  row['bound_ms'], row['bound_by'], row['k1t_device_ms'],
                  row['k1_device_ms'], row['nmember_median'],
                  row['bound_ms_median'], row['bound_by_median'],
                  row['k1t_device_ms_median'], row['k1_device_ms_median'],
                  kernels.member_group_size(row['m'], row['npts'],
                                            row['d'])))
    return rows, launches


# The population spec-walk problems at the JAX package's bench settings
# (bench.py:126-219): factory and arguments, popsize, nsteps, extra
# sampler settings, the seed and the logZ gate as (truth, floor):
# |logZ - truth| < max(4 logzerr, floor) (bench.py:353-372), truth None
# for the problem's analytic logz; rosenbrock8 has no gate there.
POPULATION_PROBLEMS = {
    'asymgauss50': (('asymgauss', dict(ndim=50, sigma_min=0.01)), 4096, 100,
                    {}, 1, (0.0, 1.5)),
    'rosenbrock8': (('rosenbrock', dict(ndim=8)), 128, 16, {}, 3, None),
    'multishell8': (('multishell', dict(ndim=8)), 128, 16, {}, 3,
                    (None, 1.0)),
    'loggamma30': (('loggamma', dict(ndim=30)), 256, 60, {}, 3, (0.0, 1.5)),
    'gauss100': (('gauss', dict(ndim=100, sigma=0.1)), 2048, 100,
                 dict(adaptive_nsteps=True), 3, (0.0, 2.0)),
    'gauss100_hard': (('gauss', dict(ndim=100, sigma=0.01)), 2048, 100,
                      dict(adaptive_nsteps=True), 3, (0.0, 2.0)),
}


def run_population_problem(name, seed=None, mesh=None, spec_depth=8,
                           spec_depth_auto=None):
    """One problem of :data:`POPULATION_PROBLEMS` on the spec-walk path.

    As ``bench.py:_run_popfused``: ``ScalingLayer``, ``SimpleRegion``,
    ``FusedPopulationSliceSampler(engine='spec', spec_depth=8)``, 400
    live points, ``dlogz=2.0``, ``frac_remain=0.1``, on the card; with a
    *mesh*, the walkers split over its shards (``mesh=`` on the sampler
    and the step sampler). *spec_depth* and *spec_depth_auto* go to the
    step sampler (the depth probe runs on the card unless it is False).
    Every
    kernel count is set to 0 just before the run and read just after it.
    Raises if logZ is outside the bench gate, the samples are malformed,
    the segment path never engaged or K3 was never launched; returns the
    run's summary.
    """
    import torch
    from ultranest_torch import ReactiveNestedSampler
    from ultranest_torch.mlfriends import ScalingLayer, SimpleRegion
    from ultranest_torch.models import problems
    from ultranest_torch.ops import kernels
    from ultranest_torch.popfused import FusedPopulationSliceSampler
    (factory, kw), popsize, nsteps, extra, seed0, gate = \
        POPULATION_PROBLEMS[name]
    seed = seed0 if seed is None else seed
    prob = getattr(problems, factory)(**kw)
    sampler = ReactiveNestedSampler(
        seed=seed, device='cuda', mesh=mesh,
        **prob.sampler_kwargs(use_torch=False))
    sampler.transform_layer_class = ScalingLayer
    ss = sampler.stepsampler = FusedPopulationSliceSampler(
        popsize=popsize, nsteps=nsteps, torch_loglike=prob.torch_loglike,
        torch_transform=prob.torch_transform, seed=seed, engine='spec',
        spec_depth=spec_depth, spec_depth_auto=spec_depth_auto,
        device='cuda', mesh=mesh, **extra)
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
    phases = dict(getattr(sampler, '_segment_phase_s', {}))
    rounds = sum(w['rounds'] for w in walks)
    changes = [(i, walks[i - 1]['nsteps'], w['nsteps'])
               for i, w in enumerate(walks)
               if i and w['nsteps'] != walks[i - 1]['nsteps']]
    out = dict(name=name, seed=seed, wall_s=wall, ncall=int(res['ncall']),
               ncall_useful=ncall_useful, niter=int(res['niter']),
               logz=float(res['logz']), logzerr=float(res['logzerr']),
               logz_expected=prob.logz,
               evals_per_s=res['ncall'] / wall,
               useful_evals_per_s=ncall_useful / wall,
               dispatches=len(walks), rounds=rounds,
               launch_ms_per_round=1e3 * phases.get('launch', 0.0)
               / max(rounds, 1),
               ms_per_round=1e3 * (phases.get('launch', 0.0)
                                   + phases.get('fetch', 0.0))
               / max(rounds, 1),
               graph_walks=sum(bool(w.get('graph')) for w in walks),
               replays=sum(w.get('replays', 0) for w in walks),
               captures=sum(w.get('captures', 0) for w in walks),
               capture_s=sum(w.get('capture_s', 0.0) for w in walks),
               rounds_per_dispatch=[w['rounds'] for w in walks],
               reads_per_dispatch=[w['reads'] for w in walks],
               nsteps_changes=changes, spec_depth=ss.spec_depth,
               spec_probe=ss.spec_probe,
               peak_device_mib=torch.cuda.max_memory_allocated() / 2**20,
               nsteps_final=int(ss.nsteps), phases_s=phases,
               billed=int(ss.ncalls),
               segment_exits=dict(getattr(sampler, '_segment_exits', {})),
               launches=dict(kernels.LAUNCHES))
    if gate is not None:
        truth = prob.logz if gate[0] is None else gate[0]
        assert abs(res['logz'] - truth) < max(4 * res['logzerr'], gate[1]), \
            ('%s logZ outside the gate' % name, res['logz'], res['logzerr'],
             truth)
    assert np.isfinite(res['samples']).all() and \
        res['samples'].shape[1] == prob.ndim, 'bad posterior samples'
    assert out['segment_exits'], 'the popfused segment path never engaged'
    assert out['launches'].get('consume_scan', 0) > 0, \
        'K3 was not launched on the spec path of %s' % name
    return out


def run_asymgauss50(seed=1):
    """asymgauss50 at the bench's full width (``bench.py:126-175``)."""
    return run_population_problem('asymgauss50', seed=seed)


def print_population_run(run):
    """The summary lines of one :func:`run_population_problem` run."""
    name = run['name']
    gate = POPULATION_PROBLEMS[name][-1]
    truth = 'no gate' if gate is None else 'truth %.4f, gate max(4 logzerr, ' \
        '%.1f)' % (run['logz_expected'] if gate[0] is None else gate[0],
                   gate[1])
    print('%s: logZ %.4f +- %.4f (%s), wall %.3f s, ncall %d, ncall_useful '
          '%d, %.0f evals/s, %.0f useful evals/s, niter %d, %d dispatches, '
          '%d rounds, launch %.3f ms per round, spec depth %d, nsteps_final '
          '%d, peak device memory %.1f MiB' % (
              name, run['logz'], run['logzerr'], truth, run['wall_s'],
              run['ncall'], run['ncall_useful'], run['evals_per_s'],
              run['useful_evals_per_s'], run['niter'], run['dispatches'],
              run['rounds'], run['launch_ms_per_round'], run['spec_depth'],
              run['nsteps_final'], run['peak_device_mib']))
    print('%s phases (s):' % name, json.dumps(run['phases_s']))
    print('%s spec walk: %.4f ms per round (launch + fetch over rounds), %d '
          'of %d dispatches as CUDA graphs, %d replays, %d captures in %.3f '
          's' % (name, run['ms_per_round'], run['graph_walks'],
                 run['dispatches'], run['replays'], run['captures'],
                 run['capture_s']))
    print('%s segment exits:' % name, json.dumps(run['segment_exits']))
    print('%s nsteps changes (dispatch, from, to):' % name,
          json.dumps(run['nsteps_changes']))
    print('%s rounds per dispatch:' % name,
          json.dumps(run['rounds_per_dispatch']))
    print('%s host reads per dispatch:' % name,
          json.dumps(run['reads_per_dispatch']))
    print('%s kernel launches:' % name, json.dumps(run['launches']))


# The engines at the JAX package's engine tests' configurations
# (tests/test_popfused.py:40-107): factory and arguments, sampler
# settings, live points, seed, and whether the run uses a ScalingLayer
# and SimpleRegion (else the default MLFriends region).
ENGINE_RUNS = {
    'sync': (('gauss', dict(ndim=2, sigma=0.1)),
             dict(engine='sync', popsize=64, nsteps=8), 100, 1, False),
    'async': (('asymgauss', dict(ndim=8, sigma_min=0.02)),
              dict(engine='async', popsize=128, nsteps=16), 200, 4, True),
    'sync8': (('asymgauss', dict(ndim=8, sigma_min=0.02)),
              dict(engine='sync', popsize=128, nsteps=16), 200, 4, True),
    'rwalk': (('asymgauss', dict(ndim=8, sigma_min=0.02)),
              dict(popsize=128, nsteps=40, scale=0.1), 200, 9, True),
    'async_classic': (('asymgauss', dict(ndim=8, sigma_min=0.02)),
                      dict(engine='async', popsize=128, nsteps=16,
                           harvest_frac=1.0), 200, 4, False),
}
# the walk each engine run drives, as CUDA graphs on every dispatch
ENGINE_WALKS = {'sync': ('sync',), 'async': ('spec',), 'sync8': ('sync',),
                'rwalk': ('rwalk',), 'async_classic': ('spec',)}


def run_engine(name):
    """One engine run of :data:`ENGINE_RUNS` on the card.

    Every kernel count is set to 0 just before the run and read just
    after it. ``async_classic`` turns the segment path off, so its walk
    runs in classic mode and its harvest is consumed on the host; every
    other run must engage the segment path and launch K3. Every dispatch
    must run its walk as CUDA graphs. Gated as the reference's tests
    gate: sync |logZ| < 1, the others |logZ| < 3 max(logzerr, 0.5).
    Returns the run's summary (wall, ncall, niter, logZ, dispatches,
    rounds, host reads, replays, captures, ms a round: wall over
    rounds).
    """
    import torch
    from ultranest_torch import ReactiveNestedSampler
    from ultranest_torch.mlfriends import ScalingLayer, SimpleRegion
    from ultranest_torch.models import problems
    from ultranest_torch.ops import kernels
    from ultranest_torch.popfused import (FusedPopulationRandomWalkSampler,
                                          FusedPopulationSliceSampler)
    (factory, kw), cfg, live, seed, scaling = ENGINE_RUNS[name]
    prob = getattr(problems, factory)(**kw)
    sampler = ReactiveNestedSampler(
        seed=seed, device='cuda', **prob.sampler_kwargs(use_torch=False))
    cls = FusedPopulationRandomWalkSampler if name == 'rwalk' \
        else FusedPopulationSliceSampler
    ss = sampler.stepsampler = cls(
        torch_loglike=prob.torch_loglike, seed=seed, device='cuda', **cfg)
    run = dict(min_num_live_points=live, viz_callback=False,
               show_status=False, max_num_improvement_loops=0, min_ess=0,
               dlogz=2.0, frac_remain=0.1)
    if scaling:
        sampler.transform_layer_class = ScalingLayer
        run.update(region_class=SimpleRegion, cluster_num_live_points=0)
    classic = name == 'async_classic'
    if classic:
        ss.segment_capable = False
    kernels.reset_counts()
    t0 = time.perf_counter()
    res = sampler.run(**run)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = dict(name=name, wall_s=wall, ncall=int(res['ncall']),
               niter=int(res['niter']), logz=float(res['logz']),
               logzerr=float(res['logzerr']),
               ncall_per_iter=res['ncall'] / res['niter'],
               dispatches=len(ss.walk_log),
               rounds=sum(w['rounds'] for w in ss.walk_log),
               reads=sum(w['reads'] for w in ss.walk_log),
               replays=sum(w['replays'] for w in ss.walk_log),
               captures=sum(w['captures'] for w in ss.walk_log),
               scale=ss.scale,
               segment_exits=dict(getattr(sampler, '_segment_exits', {})),
               launches=dict(kernels.LAUNCHES))
    if name.startswith('sync') and not scaling:
        assert abs(res['logz'] - prob.logz) < 1.0, (name, res['logz'])
    else:
        assert abs(res['logz'] - prob.logz) < \
            3 * max(res['logzerr'], 0.5), (name, res['logz'],
                                           res['logzerr'])
    assert np.isfinite(res['samples']).all(), 'bad posterior samples'
    assert ss.walk_log, 'the walk never ran'
    assert all(w['graph'] for w in ss.walk_log), \
        ('a dispatch of %s ran from the host loop' % name)
    out['ms_per_round'] = 1e3 * wall / out['rounds']
    if classic:
        assert not out['segment_exits'] and \
            out['launches'].get('consume_scan', 0) == 0
        assert out['launches'].get('bootstrap_radius', 0) > 0, \
            'K2 was not launched in the classic run'
    else:
        assert out['segment_exits'], 'the segment path never engaged'
        assert out['launches'].get('consume_scan', 0) > 0, \
            'K3 was not launched on the %s segment path' % name
    if name == 'rwalk':
        assert ss.scale != 0.1, 'the random walk never adapted its scale'
    return out


def gauss_loglike(theta):
    """Unit-cube gaussian at 0.5 with sigma 0.1 on every axis (numpy),
    the likelihood of the reference's sampler tests."""
    return -0.5 * (((theta - 0.5) / 0.1) ** 2).sum(axis=1)


def count_rebuilds(obj, method):
    """Wraps ``obj.method`` to count its calls; returns the count's list."""
    orig, calls = getattr(obj, method), []

    def counted(*args, **kwargs):
        calls.append(1)
        return orig(*args, **kwargs)

    setattr(obj, method, counted)
    return calls


def run_classic_sampler():
    """The classic ``NestedSampler`` at the reference test's settings
    (``tests/test_run.py:79-90``: 2-d gauss, 200 live points, seed 5,
    4000 iterations at most) with ``device='cuda'`` and no run directory.

    Every kernel count is set to 0 just before the run and read just
    after it. Raises if logZ is outside that test's tolerance (1.0), if
    K2 was not launched once per region rebuild or if a plain version
    was called; returns the run's summary.
    """
    import torch
    from ultranest_torch import NestedSampler
    from ultranest_torch.ops import kernels
    sampler = NestedSampler(
        ['a', 'b'], gauss_loglike, transform=lambda x: x, vectorized=True,
        num_live_points=200, log_dir=None, seed=5, device='cuda')
    rebuilds = count_rebuilds(sampler, '_rebuild_region')
    kernels.reset_counts()
    t0 = time.perf_counter()
    res = sampler.run(max_iters=4000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sampler.print_results()
    truth = float(np.log(2 * np.pi * 0.1 ** 2))
    out = dict(wall_s=wall, ncall=int(res['ncall']), niter=int(res['niter']),
               logz=float(res['logz']), logzerr=float(res['logzerr']),
               logz_expected=truth, rebuilds=len(rebuilds),
               launches=dict(kernels.LAUNCHES),
               plain_calls=dict(kernels.PLAIN_CALLS))
    assert abs(res['logz'] - truth) < 1.0, ('classic logZ outside the gate',
                                            res['logz'], truth)
    assert np.isfinite(res['samples']).all() and \
        res['samples'].shape[1] == 2, 'bad posterior samples'
    assert out['rebuilds'] > 0 and \
        out['launches'].get('bootstrap_radius', 0) == out['rebuilds'], \
        ('K2 was not launched once per rebuild', out)
    assert not out['plain_calls'], ('a plain version ran', out['plain_calls'])
    return out


def run_host_slice_sampler(ndim=8, seed=4):
    """``ReactiveNestedSampler(device='cuda')`` with a host
    ``SliceSampler`` on mixture directions, on a *ndim*-d gauss at the
    settings of the reference's step sampler tests
    (``tests/test_stepsamplers.py:123-131``: 100 live points, dlogz 2,
    frac_remain 0.1; nsteps 2 *ndim*).

    Every kernel count is set to 0 just before the run and read just
    after it. Raises if logZ is outside that test's gate (2.0), if K2
    was not launched once per region bootstrap or if a plain version was
    called; returns the run's summary.
    """
    import torch
    from ultranest_torch import ReactiveNestedSampler
    from ultranest_torch import stepsampler
    from ultranest_torch.ops import kernels
    np.random.seed(seed)
    sampler = ReactiveNestedSampler(
        ['p%d' % i for i in range(ndim)], gauss_loglike,
        transform=lambda x: x, vectorized=True, seed=seed, device='cuda')
    ss = sampler.stepsampler = stepsampler.SliceSampler(
        nsteps=2 * ndim,
        generate_direction=stepsampler.generate_mixture_random_direction)
    kernels.reset_counts()
    t0 = time.perf_counter()
    res = sampler.run(min_num_live_points=100, viz_callback=False,
                      show_status=False, max_num_improvement_loops=0,
                      min_ess=0, dlogz=2.0, frac_remain=0.1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ss.print_diagnostic()
    truth = ndim / 2.0 * float(np.log(2 * np.pi * 0.1 ** 2))
    info = ss.get_info_dict()
    out = dict(ndim=ndim, wall_s=wall, ncall=int(res['ncall']),
               niter=int(res['niter']), logz=float(res['logz']),
               logzerr=float(res['logzerr']), logz_expected=truth,
               nsteps=int(ss.nsteps), chains=int(info['num_logs']),
               rejection_rate=float(info['rejection_rate']),
               frac_far_enough=float(info['frac_far_enough']),
               launches=dict(kernels.LAUNCHES),
               plain_calls=dict(kernels.PLAIN_CALLS))
    assert abs(res['logz'] - truth) < 2.0, ('host slice sampler logZ outside '
                                            'the gate', res['logz'], truth)
    assert np.isfinite(res['samples']).all() and \
        res['samples'].shape[1] == ndim, 'bad posterior samples'
    assert out['chains'] > 0, 'the host step sampler never finished a chain'
    assert out['launches'].get('bootstrap_radius', 0) > 0, \
        'K2 was not launched under the host step sampler'
    assert not out['plain_calls'], ('a plain version ran', out['plain_calls'])
    return out


def check_plots(sampler):
    """``sampler.plot()`` writes corner, run and trace plots of a finished
    run into a run directory made for them (the run itself kept none).
    Returns the files' sizes, or None where matplotlib is not installed:
    the plots are host code, and the CPU tests cover them."""
    import importlib.util
    import os
    import tempfile
    if importlib.util.find_spec('matplotlib') is None:
        return None
    import matplotlib
    matplotlib.use('Agg')
    from ultranest_torch.utils import make_run_dir
    with tempfile.TemporaryDirectory() as tmp:
        sampler.logs = make_run_dir(tmp, append_run_num=False)
        sampler.log_to_disk = True
        try:
            sampler.plot()
        finally:
            sampler.log_to_disk = False
        sizes = {kind: os.path.getsize(os.path.join(
            sampler.logs['plots'], kind + '.pdf'))
            for kind in ('corner', 'run', 'trace')}
    assert all(size > 0 for size in sizes.values()), sizes
    return sizes


# --- the phases of the stored runs, warm starts, calibrator, watchdog and
# trajectory samplers ---------------------------------------------------

# a spin of ~3 s at the H100's 1.98 GHz (torch.cuda._sleep counts clocks)
SPIN_CYCLES = 6_000_000_000
# the bench's eggbox run options (bench.py:104-115)
EGGBOX_RUN = dict(min_num_live_points=400, viz_callback=False,
                  show_status=False, max_num_improvement_loops=0, min_ess=0,
                  dlogz=0.5, frac_remain=0.1, Lepsilon=0.001,
                  max_ncalls=400000)
# the reference tests' small runs (tests/test_resume_similar.py,
# tests/test_watchdog.py), at 400 live points
GAUSS_RUN = dict(min_num_live_points=400, viz_callback=False,
                 show_status=False, max_num_improvement_loops=0, min_ess=0,
                 dlogz=2.0, frac_remain=0.1)


def sigma_gauss(sigma):
    """(numpy, torch) log-likelihoods of the unnormalised unit-cube
    gaussian at 0.5 with *sigma* on every axis, as
    ``tests/test_resume_similar.py``; its logZ in 2-d is
    log(2 pi sigma^2)."""
    def loglike(theta):
        return -0.5 * (((theta - 0.5) / sigma) ** 2).sum(axis=1)

    def torch_loglike(theta):
        return -0.5 * (((theta - 0.5) / sigma) ** 2).sum(dim=1)

    return loglike, torch_loglike


def identity(x):
    """The unit-cube transform of the gaussians here."""
    return x


class DispatchDeadline:
    """Sets ``ULTRANEST_TORCH_DISPATCH_DEADLINE`` inside the block."""

    def __init__(self, seconds):
        self.value = '%g' % seconds

    def __enter__(self):
        import os
        self.old = os.environ.get('ULTRANEST_TORCH_DISPATCH_DEADLINE')
        os.environ['ULTRANEST_TORCH_DISPATCH_DEADLINE'] = self.value

    def __exit__(self, *exc):
        import os
        if self.old is None:
            del os.environ['ULTRANEST_TORCH_DISPATCH_DEADLINE']
        else:
            os.environ['ULTRANEST_TORCH_DISPATCH_DEADLINE'] = self.old


def check_label_propagation(eggbox_region):
    """Device label propagation against ``connected_components``: the
    eggbox run's last region (its 400 live points in whitened space),
    and 4096 points of d 8 in four blobs in a region built on the card,
    each at its bootstrapped MLFriends radius (30 rounds, K2). Labels
    must be equal; returns [(case, n, components, label propagation ms,
    connected_components ms)]."""
    import torch
    from ultranest_torch.mlfriends import MLFriends, ScalingLayer
    from ultranest_torch.ops import cluster
    rng = np.random.RandomState(8)
    pts = np.concatenate([rng.normal(c, 0.03, size=(1024, 8))
                          for c in rng.uniform(0.25, 0.75, size=(4, 8))])
    pts = pts.clip(1e-3, 1 - 1e-3)
    layer = ScalingLayer()
    layer.optimize(pts, pts)
    region = MLFriends(pts, layer, device='cuda')
    out = []
    for name, reg in (('eggbox', eggbox_region), ('blobs8', region)):
        tp = reg.unormed
        radius = reg.compute_maxradiussq(nbootstraps=30,
                                         rng=np.random.RandomState(0))
        times = []
        for fn in (cluster.label_propagation_components,
                   cluster.connected_components):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            labels = fn(tp, radius, device='cuda')
            times.append(1e3 * (time.perf_counter() - t0))
            if fn is cluster.label_propagation_components:
                got = labels
        assert np.array_equal(got, labels), ('label propagation differs',
                                             name)
        ncomp = len(np.unique(got))
        assert 1 <= ncomp < len(tp), (name, ncomp)
        print('label propagation on %s (%d points, d %d, r2 %.6g): labels '
              'equal to connected_components, %d components; %.3f ms '
              '(connected_components %.3f ms)' % (
                  name, len(tp), tp.shape[1], radius, ncomp, *times))
        out.append((name, len(tp), ncomp, *times))
    return out


def check_deadline_spin():
    """Watchdog check (a): a fetch queued behind a ~3 s spin kernel, with
    a 1 s deadline, must raise DeviceLostError. Also times one deadline
    read of a finished copy beside a bare ``Event.synchronize()``: the
    poll's cost per read. Returns the numbers as a dict."""
    import torch
    from ultranest_torch.parallel import launch
    x = torch.arange(4, device='cuda')
    done = torch.cuda.Event()
    done.record()
    torch.cuda.synchronize()
    cost = {}
    for name, fn in (('synchronize_us', done.synchronize),
                     ('wait_ready_us', lambda: launch.wait_ready(done))):
        t0 = time.perf_counter()
        for _ in range(10000):
            fn()
        cost[name] = 1e6 * (time.perf_counter() - t0) / 10000
    torch.cuda._sleep(SPIN_CYCLES)
    handle = launch.start_fetch(x)
    t0 = time.perf_counter()
    try:
        launch.finish_fetch(handle, deadline=1.0)
    except launch.DeviceLostError:
        raised = time.perf_counter() - t0
    else:
        raise AssertionError('no DeviceLostError behind the spin kernel')
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    out = dict(raised_s=raised, spin_rest_s=time.perf_counter() - t1, **cost)
    assert 1.0 <= raised < 1.5, out
    assert np.array_equal(launch.finish_fetch(handle), [0, 1, 2, 3])
    print('watchdog (a): a fetch behind a ~3 s spin kernel raised '
          'DeviceLostError after %.3f s (deadline 1 s); the spin ended %.3f '
          's later; one read of a finished copy: wait_ready %.2f us, '
          'Event.synchronize %.2f us' % (
              out['raised_s'], out['spin_rest_s'], out['wait_ready_us'],
              out['synchronize_us']))
    return out


def run_watchdog(kind):
    """Watchdog checks (b) and (c): a 2-d gauss (sigma 0.1, 400 live
    points) on the card, by region rejection (*kind* 'rejection') or with
    a spec-walk ``FusedPopulationSliceSampler`` (popsize 64, nsteps 8;
    *kind* 'population'), under a 1 s dispatch deadline. After the
    path's third result, a ~3 s spin kernel is queued and the next device
    read (the walk's flag read or a result fetch, whichever comes first)
    waits behind it, so it misses the deadline. The run must warn "accelerator lost", swap the
    device sampler for the host one and finish inside
    ``tests/test_watchdog.py``'s gate, 3 max(logzerr, 0.5). Every kernel
    count is set to 0 just before the run and read just after it.
    Returns the run's summary."""
    import warnings
    import torch
    from ultranest_torch import ReactiveNestedSampler, fused, popfused
    from ultranest_torch.models.problems import gauss
    from ultranest_torch.ops import kernels
    from ultranest_torch.parallel.launch import DeviceLostError
    prob = gauss(ndim=2, sigma=0.1)
    if kind == 'rejection':
        sampler = ReactiveNestedSampler(
            seed=2, device='cuda', **prob.sampler_kwargs(use_torch=True))
        mod = fused
    else:
        sampler = ReactiveNestedSampler(
            seed=1, device='cuda', **prob.sampler_kwargs(use_torch=False))
        sampler.stepsampler = popfused.FusedPopulationSliceSampler(
            popsize=64, nsteps=8, torch_loglike=prob.torch_loglike, seed=1,
            device='cuda')
        mod = popfused
    # every blocking read of the path goes through its finish_fetch: the
    # walk's done flag (a 0-d tensor) and the results; a population
    # result comes home in two fetches (rows and counts)
    per_result = 2 if kind == 'population' else 1
    state = dict(fetches=0, spin_at=None, lost_at=None, caught_at=None)
    read = mod.finish_fetch

    def watched(handle, deadline=None):
        what = 'flag read' if handle[0].dim() == 0 else 'result fetch'
        if state['fetches'] >= 3 * per_result and state['spin_at'] is None:
            # the card stops answering: this read waits behind a spin
            torch.cuda._sleep(SPIN_CYCLES)
            behind = torch.cuda.Event()
            behind.record()
            handle = (handle[0], behind)
            state['spin_at'] = time.perf_counter()
        try:
            out = read(handle, deadline)
        except DeviceLostError:
            state['caught_at'] = state['caught_at'] or what
            raise
        state['fetches'] += what == 'result fetch'
        return out

    degrade = sampler._degrade_to_host

    def degraded(why):
        state['lost_at'] = time.perf_counter()
        degrade(why)

    sampler._degrade_to_host = degraded
    mod.finish_fetch = watched
    kernels.reset_counts()
    t0 = time.perf_counter()
    try:
        with DispatchDeadline(1.0), warnings.catch_warnings(record=True) as w:
            warnings.simplefilter('always')
            res = sampler.run(**GAUSS_RUN)
    finally:
        mod.finish_fetch = read
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = dict(kind=kind, wall_s=wall, ncall=int(res['ncall']),
               niter=int(res['niter']), logz=float(res['logz']),
               logzerr=float(res['logzerr']), logz_expected=prob.logz,
               caught_at=state['caught_at'],
               hang_to_degrade_s=(state['lost_at'] - state['spin_at'])
               if state['lost_at'] and state['spin_at'] else None,
               host_sampler=type(sampler.stepsampler).__name__
               if sampler.stepsampler is not None else None,
               segment_exits=dict(getattr(sampler, '_segment_exits', {})),
               launches=dict(kernels.LAUNCHES))
    assert state['spin_at'] is not None, 'the hang was never injected'
    assert any('accelerator lost' in str(x.message) for x in w), \
        'no "accelerator lost" warning'
    assert state['lost_at'] is not None and state['caught_at'], out
    assert sampler.fused_sampler is None
    if kind == 'population':
        assert out['host_sampler'] == 'SliceSampler' and \
            sampler.stepsampler.nsteps == 8, out
    assert abs(res['logz'] - prob.logz) < 3 * max(res['logzerr'], 0.5), \
        ('%s watchdog run outside the gate' % kind, out)
    assert np.isfinite(res['samples']).all(), 'bad posterior samples'
    print('watchdog (%s): hang caught at %s %.3f s after the spin was '
          'queued (deadline 1 s), degraded to %s; logZ %.4f +- %.4f '
          '(analytic %.4f, gate 3 max(logzerr, 0.5)), wall %.3f s, ncall '
          '%d, niter %d, segment exits %s, kernel launches %s' % (
              'b' if kind == 'rejection' else 'c', out['caught_at'],
              out['hang_to_degrade_s'], out['host_sampler'] or
              'host region sampling', out['logz'], out['logzerr'],
              out['logz_expected'], wall, out['ncall'], out['niter'],
              json.dumps(out['segment_exits']), json.dumps(out['launches'])))
    return out


def timed_run(sampler, reset=True, **options):
    """(results, wall s, kernel launches) of ``sampler.run`` on the card,
    every kernel count set to 0 just before it (unless not *reset*) and
    read just after."""
    import torch
    from ultranest_torch.ops import kernels
    if reset:
        kernels.reset_counts()
    t0 = time.perf_counter()
    res = sampler.run(**options)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, dict(kernels.LAUNCHES)


def run_warm_start(kind, tmp):
    """A cold run into a ``storage_backend='csv'`` run directory under
    *tmp*, then ``warmstart_from_similar_file(..., torch_loglike=,
    torch_transform=)`` on its ``weighted_post_untransformed.txt`` and a
    warm run of the aux problem on the card (its ``.torch`` functions).

    *kind* 'eggbox': the bench configuration (400 live points,
    ``bench.py:104-115``) again from its own posterior, gated on the
    quadrature logZ (235.856, floor 1.0) with K1, K2 and K3 launched in
    the warm run. *kind* 'gauss': the 2-d gauss, sigma 0.1 then 0.11, 400
    live points, as ``tests/test_resume_similar.py:75-101``, gated at
    |logZ - log(2 pi 0.11^2)| < 1.5. Returns {'cold': ..., 'warm': ...,
    'launches': the two runs' kernel launches}.
    """
    import os
    from ultranest_torch import (ReactiveNestedSampler,
                                 warmstart_from_similar_file)
    from ultranest_torch.models.problems import eggbox
    from ultranest_torch.ops import kernels
    if kind == 'eggbox':
        prob = eggbox()
        names, tr, ttr = prob.param_names, prob.transform, \
            prob.torch_transform
        cold_ll, cold_tll = prob.loglike, prob.torch_loglike
        warm_ll, warm_tll = cold_ll, cold_tll
        extra = dict(ndraw_min=4096, ndraw_max=32768)
        options, truth, floor = EGGBOX_RUN, EGGBOX_LOGZ, 1.0
    else:
        names, tr, ttr = ['a', 'b'], identity, identity
        cold_ll, cold_tll = sigma_gauss(0.1)
        warm_ll, warm_tll = sigma_gauss(0.11)
        extra = {}
        options, truth, floor = GAUSS_RUN, float(np.log(2 * np.pi * 0.11 ** 2)), \
            None
    cold = ReactiveNestedSampler(
        names, cold_ll, transform=tr, vectorized=True, seed=42,
        torch_loglike=cold_tll, torch_transform=ttr, device='cuda',
        log_dir=os.path.join(tmp, kind), resume='overwrite',
        storage_backend='csv', **extra)
    res_c, wall_c, launch_c = timed_run(cold, **options)
    usamples = os.path.join(cold.logs['chains'],
                            'weighted_post_untransformed.txt')
    aux_names, aux_ll, aux_tr, vec = warmstart_from_similar_file(
        usamples, names, warm_ll, tr, vectorized=True,
        torch_loglike=warm_tll, torch_transform=ttr)
    assert aux_names == list(names) + ['aux_logweight'], aux_names
    warm = ReactiveNestedSampler(
        aux_names, aux_ll, transform=aux_tr, vectorized=vec, seed=43,
        torch_loglike=aux_ll.torch, torch_transform=aux_tr.torch,
        device='cuda', **extra)
    assert warm.fused_sampler is not None
    res_w, wall_w, launch_w = timed_run(warm, **options)
    out = {}
    for name, res, wall, launched, sampler in (
            ('cold', res_c, wall_c, launch_c, cold),
            ('warm', res_w, wall_w, launch_w, warm)):
        out[name] = dict(wall_s=wall, ncall=int(res['ncall']),
                         niter=int(res['niter']), logz=float(res['logz']),
                         logzerr=float(res['logzerr']),
                         segment_exits=dict(getattr(sampler,
                                                    '_segment_exits', {})),
                         launches=launched)
        assert np.isfinite(res['samples']).all(), 'bad posterior samples'
    if floor is None:
        assert abs(res_w['logz'] - truth) < 1.5, \
            ('warm gauss outside the gate', out)
    else:
        assert abs(res_c['logz'] - truth) < max(4 * res_c['logzerr'], floor)
        assert abs(res_w['logz'] - truth) < max(4 * res_w['logzerr'],
                                                floor), \
            ('warm eggbox outside the gate', out)
        for name in kernels.REGION_KERNELS:
            assert launch_w.get(name, 0) > 0, ('kernel not launched in the '
                                               'warm eggbox run', name)
    out['launches'] = {k: launch_c.get(k, 0) + launch_w.get(k, 0)
                       for k in set(launch_c) | set(launch_w)}
    for name in ('cold', 'warm'):
        r = out[name]
        print('warm start %s, %s run: logZ %.4f +- %.4f (truth %.4f), wall '
              '%.3f s, ncall %d, niter %d, segment exits %s, kernel launches '
              '%s' % (kind, name, r['logz'], r['logzerr'], truth, r['wall_s'],
                      r['ncall'], r['niter'], json.dumps(r['segment_exits']),
                      json.dumps(r['launches'])))
    return out


def check_reuse_samples():
    """``reuse_samples(torch_loglike=)`` on the card: the case of
    ``tests/test_aux_modules.py:118-134`` and its checks."""
    from ultranest_torch.hotstart import reuse_samples
    rng = np.random.RandomState(8)
    points = rng.normal(0.5, 0.1, size=(500, 2))
    logl = -0.5 * (((points - 0.5) / 0.1) ** 2).sum(axis=1)
    np.random.seed(8)
    res = reuse_samples(['a', 'b'], None, points, logl,
                        torch_loglike=sigma_gauss(0.1)[1], device='cuda')
    assert np.isfinite(res['logz']) and res['ess'] > 10, res['logz']
    assert np.allclose(res['posterior']['mean'], [0.5, 0.5], atol=0.05)
    print('reuse_samples(torch_loglike=, device=cuda): logZ %.6f, ess %.1f, '
          'ncall %d, posterior mean %s' % (
              res['logz'], res['ess'], res['ncall'],
              np.round(res['posterior']['mean'], 4).tolist()))
    return res


def run_calibrator():
    """``ReactiveNestedCalibrator`` with ``FusedPopulationSliceSampler``
    on a gauss of d 4 (popsize 64, nsteps 4), as
    ``tests/test_aux_modules.py:314-339``, on the card. Every kernel count
    is set to 0 just before the ladder and read after each rung: nsteps
    must begin 4, 8, 16, each rung run a fresh clone and launch K3.
    Returns the rungs and the ladder's kernel launches."""
    import torch
    from ultranest_torch.calibrator import ReactiveNestedCalibrator
    from ultranest_torch.models.problems import gauss
    from ultranest_torch.ops import kernels
    from ultranest_torch.popfused import FusedPopulationSliceSampler
    prob = gauss(ndim=4, sigma=0.1)
    calib = ReactiveNestedCalibrator(seed=1, device='cuda',
                                     **prob.sampler_kwargs(use_torch=False))
    calib.stepsampler = FusedPopulationSliceSampler(
        popsize=64, nsteps=4, torch_loglike=prob.torch_loglike, seed=1,
        device='cuda')
    kernels.reset_counts()
    rungs, clones, seen = [], [], 0
    t0 = time.perf_counter()
    for nsteps, res in calib.run_iter(
            min_num_live_points=50, viz_callback=False, show_status=False,
            max_num_improvement_loops=0, min_ess=0, dlogz=2.0,
            frac_remain=0.5):
        torch.cuda.synchronize()
        k3 = kernels.LAUNCHES['consume_scan'] - seen
        seen += k3
        clones.append(calib.sampler.stepsampler)
        rungs.append(dict(nsteps=nsteps, logz=float(res['logz']),
                          logzerr=float(res['logzerr']),
                          ncall=int(res['ncall']), niter=int(res['niter']),
                          k3=k3))
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    assert [r['nsteps'] for r in rungs[:3]] == [4, 8, 16], rungs
    assert all(r['k3'] > 0 for r in rungs), ('K3 not launched in a rung',
                                             rungs)
    assert len({id(c) for c in clones + [calib.stepsampler]}) == \
        len(clones) + 1, 'a rung did not get a fresh clone'
    assert all(c.nsteps == r['nsteps'] for c, r in zip(clones, rungs))
    assert np.isfinite(rungs[-1]['logz'])
    print('calibrator (FusedPopulationSliceSampler, gauss d 4): %d rungs in '
          '%.3f s: %s; kernel launches %s' % (
              len(rungs), wall, '; '.join(
                  'nsteps %d logZ %.4f +- %.4f ncall %d niter %d K3 %d' % (
                      r['nsteps'], r['logz'], r['logzerr'], r['ncall'],
                      r['niter'], r['k3']) for r in rungs),
              json.dumps(launches)))
    return dict(rungs=rungs, launches=launches)


def run_trajectory():
    """The trajectory samplers on the card, as ``tests/test_trajectory.py:
    141-228``: ``gradient_from_torch`` and
    ``transform_loglike_gradient_from_torch`` against the analytic
    gradient; one ``DynamicCHMCSampler`` and one ``DynamicHMCSampler``
    step in an MLFriends region built on the card; then a
    ``SamplingPathStepSampler`` run (50 live points), gated at 2.5. Every
    kernel count is set to 0 just before the phase and read just after
    it (the regions' rebuilds launch K2). Returns its summary."""
    from ultranest_torch import ReactiveNestedSampler
    from ultranest_torch.dychmc import DynamicCHMCSampler, gradient_from_torch
    from ultranest_torch.dyhmc import (DynamicHMCSampler,
                                       transform_loglike_gradient_from_torch)
    from ultranest_torch.mlfriends import AffineLayer, MLFriends
    from ultranest_torch.ops import kernels
    from ultranest_torch.pathsampler import SamplingPathStepSampler
    loglike, torch_loglike = sigma_gauss(0.1)
    kernels.reset_counts()
    u0 = np.array([0.6, 0.5])
    analytic = -(u0 - 0.5) / 0.01
    g = gradient_from_torch(torch_loglike, device='cuda')(u0)
    assert np.allclose(g, analytic / np.linalg.norm(analytic), atol=1e-6), g
    tlg = transform_loglike_gradient_from_torch(torch_loglike, device='cuda')
    p, L, dL = tlg(u0)
    assert np.allclose(p, u0, atol=1e-6) and \
        abs(L - loglike(u0[None])[0]) < 1e-4 and \
        np.allclose(dL, analytic, rtol=1e-5), (p, L, dL)
    steps = {}
    for name, seed in (('chmc', 4), ('hmc', 6)):
        rng = np.random.RandomState(seed)
        u = rng.uniform(0.3, 0.7, size=(200, 2))
        layer = AffineLayer()
        layer.optimize(u, u)
        region = MLFriends(u, layer, device='cuda')
        region.maxradiussq, region.enlarge = region.compute_enlargement(
            nbootstraps=10, rng=np.random.RandomState(seed))
        region.create_ellipsoid()
        Ls = loglike(region.u)
        Lmin = np.percentile(Ls, 20)
        np.random.seed(seed - 1)
        if name == 'chmc':
            ss = DynamicCHMCSampler(scale=0.05, nsteps=4)
            ss.set_gradient(gradient_from_torch(torch_loglike,
                                                device='cuda'))
            ok = Ls > Lmin
            un, _, Ln, nc = ss.__next__(region, Lmin, region.u[ok], Ls[ok],
                                        identity, loglike)
            assert Ln > Lmin
        else:
            ss = DynamicHMCSampler(ndim=2, nsteps=3,
                                   transform_loglike_gradient=tlg)
            un, _, Ln, nc = ss.__next__(region, Lmin, region.u, Ls,
                                        identity, loglike)
        assert nc > 0 and (un > 0).all() and (un < 1).all(), (name, un, nc)
        steps[name] = dict(u=np.asarray(un).tolist(), L=float(Ln),
                           ncall=int(nc))
    np.random.seed(7)
    sampler = ReactiveNestedSampler(['a', 'b'], loglike, transform=identity,
                                    vectorized=True, seed=7, device='cuda')
    sampler.stepsampler = SamplingPathStepSampler(nresets=3, nsteps=5)
    res, wall, launched = timed_run(
        sampler, reset=False, min_num_live_points=50, viz_callback=False,
        show_status=False, max_num_improvement_loops=0, min_ess=0,
        dlogz=2.0, frac_remain=0.5, max_ncalls=20000)
    truth = float(np.log(2 * np.pi * 0.1 ** 2))
    assert abs(res['logz'] - truth) < 2.5, ('path sampler outside the gate',
                                            res['logz'])
    assert launched.get('bootstrap_radius', 0) > 0, \
        'K2 was not launched under the path sampler'
    out = dict(wall_s=wall, ncall=int(res['ncall']), niter=int(res['niter']),
               logz=float(res['logz']), logzerr=float(res['logzerr']),
               gradient=g.tolist(), steps=steps, launches=launched)
    print('trajectory samplers: gradient_from_torch %s (analytic direction '
          '[-1, 0]), transform_loglike_gradient_from_torch L %.6f dL/du %s; '
          'DynamicCHMCSampler step %s; DynamicHMCSampler step %s; '
          'SamplingPathStepSampler run logZ %.4f +- %.4f (analytic %.4f, '
          'gate 2.5), wall %.3f s, ncall %d, niter %d, kernel launches %s'
          % (np.round(g, 6).tolist(), L, np.round(dL, 4).tolist(),
             json.dumps(steps['chmc']), json.dumps(steps['hmc']), out['logz'],
             out['logzerr'], truth, wall, out['ncall'], out['niter'],
             json.dumps(launched)))
    return out


def run_stored_runs(tmp):
    """``read_file`` and ``resume='resume-similar'`` on the card, where
    h5py imports (both read HDF5 point stores): a stored 2-d gauss run
    (sigma 0.1, region rejection on the card) read back, then salvaged
    for sigma 0.11 and run on, gated as ``tests/test_run.py:123-142``
    and ``tests/test_resume_similar.py:47-72`` gate. Returns None where
    h5py is not installed (the CPU tests cover both there)."""
    import importlib.util
    import os
    if importlib.util.find_spec('h5py') is None:
        return None
    from ultranest_torch import ReactiveNestedSampler, read_file
    loglike_a, torch_loglike_a = sigma_gauss(0.1)
    loglike_b, _ = sigma_gauss(0.11)
    log_dir = os.path.join(tmp, 'stored')
    first = ReactiveNestedSampler(
        ['a', 'b'], loglike_a, transform=identity, vectorized=True, seed=3,
        torch_loglike=torch_loglike_a, torch_transform=identity,
        device='cuda', log_dir=log_dir, resume=True)
    res1, wall1, _ = timed_run(first, **GAUSS_RUN)
    first.pointstore.close()
    seq, final = read_file(first.logs['run_dir'], 2, num_bootstraps=10,
                           random=False)
    assert abs(final['logz'] - res1['logz']) < 0.5 and \
        seq['niter'] >= res1['niter'], (final['logz'], res1['logz'])
    second = ReactiveNestedSampler(
        ['a', 'b'], loglike_b, transform=identity, vectorized=True, seed=4,
        device='cuda', log_dir=log_dir, resume='resume-similar',
        warmstart_max_tau=0.3)
    res2, wall2, _ = timed_run(second, **GAUSS_RUN)
    truth = float(np.log(2 * np.pi * 0.11 ** 2))
    assert abs(res2['logz'] - truth) < 1.5, res2['logz']
    out = dict(read_file_logz=float(final['logz']), logz=float(res1['logz']),
               salvaged_logz=float(res2['logz']), salvaged_ncall=int(
                   res2['ncall']), ncall=int(res1['ncall']))
    print('stored runs: read_file logZ %.4f (run %.4f); resume-similar '
          'logZ %.4f (truth %.4f), ncall %d after %d' % (
              out['read_file_logz'], out['logz'], out['salvaged_logz'],
              truth, out['salvaged_ncall'], out['ncall']))
    return out


# the mesh phase: two ranks on the one card, joined by gloo
MESH_RANKS = 2
# seconds a rank may take (start-up, the radius, the eggbox, asymgauss50)
MESH_TIMEOUT_S = 420


def free_port():
    """A free TCP port on 127.0.0.1."""
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def traffic_on_host(traffic):
    """*traffic* (path -> kernel -> calls) with every tensor on the CPU,
    for ``torch.save``."""
    import torch
    return {name: {k: [tuple(t.cpu() if torch.is_tensor(t) else t for t in c)
                       for c in kcalls] for k, kcalls in calls.items()}
            for name, calls in traffic.items()}


def check_nccl_collectives():
    """The collectives on CUDA tensors over a one-rank NCCL group.

    ``all_gather_rows``, ``psum``, ``pmax`` and ``pmean`` of
    :mod:`ultranest_torch.parallel` must return their inputs; with one
    rank NCCL still initialises its communicator and launches on the
    card. Returns the group's backend name.
    """
    import torch
    import torch.distributed as dist
    from ultranest_torch import parallel
    from ultranest_torch.parallel import launch
    launch.init_distributed('127.0.0.1:%d' % free_port(), 1, 0)
    try:
        mesh = launch.global_mesh()
        backend = dist.get_backend(mesh.get_group())
        assert backend == 'nccl', backend
        x = torch.arange(8192, dtype=torch.float32, device='cuda').reshape(
            4096, 2)
        c = torch.tensor([2**40 + 3, 7], dtype=torch.int64, device='cuda')
        got = parallel.all_gather_rows(x, mesh)
        assert got.device == x.device and torch.equal(got, x)
        assert torch.equal(parallel.psum(c, mesh), c)
        assert torch.equal(parallel.pmax(x, mesh), x)
        assert torch.equal(parallel.pmean(x, mesh), x)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    print('NCCL one-rank group (backend %s, mesh device %s): all_gather_rows, '
          'psum (int64), pmax and pmean on cuda tensors returned their inputs'
          % (backend, mesh.device_type))
    return backend


def check_mesh_radius(kernels, mesh):
    """The sharded bootstrap radius at the eggbox rebuild shape (N 400,
    30 rounds, d 2): each shard runs K2 on its rounds, then the maximum
    over the shards; bit-equal to K2 on all the rounds (not counted).
    Returns (radius, K2 launches of the sharded call)."""
    from ultranest_torch.ops.bootstrap import (_bootstrap_radius,
                                               make_bootstrap_masks,
                                               radius_inputs)
    rng = np.random.RandomState(400)
    tp = rng.normal(size=(400, 2)).astype(np.float32)
    masks = make_bootstrap_masks(400, 30, rng=rng)
    kernels.reset_counts()
    got = _bootstrap_radius(tp, masks, 'cuda', mesh=mesh)
    launched = kernels.LAUNCHES['bootstrap_radius']
    want = kernels.bootstrap_radius(*radius_inputs(tp, masks, 'cuda'))
    assert np.float32(got).view(np.int32) == \
        want.cpu().numpy().view(np.int32), ('sharded radius differs', got,
                                            float(want))
    assert launched == 1, launched
    return got, launched


def mesh_child(rank, port, out_dir):
    """One rank of the mesh phase (:func:`run_mesh_phase` starts both).

    Joins a gloo group of :data:`MESH_RANKS` ranks on 127.0.0.1:*port*,
    puts its samplers on ``cuda:0`` and runs, on a 1-axis mesh over the
    ranks: the sharded bootstrap radius (:func:`check_mesh_radius`), the
    eggbox on the sharded rejection path and asymgauss50 on the sharded
    spec-walk segment path (2048 walkers a rank), each under
    :class:`KernelCapture`. Saves the kept calls to
    *out_dir*/traffic<rank>.pt and prints one ``MESH_RANK {json}`` line.
    """
    import os
    import torch
    import torch.distributed as dist
    from ultranest_torch.ops import kernels
    from ultranest_torch.parallel import launch
    torch.cuda.set_device(0)
    launch.init_distributed('127.0.0.1:%d' % port, MESH_RANKS, rank,
                            backend='gloo')
    try:
        mesh = launch.global_mesh()
        out = dict(rank=rank, backend=dist.get_backend(mesh.get_group()),
                   nshards=mesh.size())
        t0 = time.perf_counter()
        out['radius'], out['radius_launches'] = check_mesh_radius(kernels,
                                                                  mesh)
        out['radius_wall_s'] = time.perf_counter() - t0
        traffic = {}
        with KernelCapture(kernels) as cap, Walks() as walks:
            out['eggbox'] = run_eggbox(mesh=mesh)
        traffic['eggbox'] = cap.calls
        out['eggbox']['spec_walks'] = walks.summary()
        with KernelCapture(kernels) as cap, Walks() as walks:
            out['asymgauss50'] = run_population_problem('asymgauss50',
                                                        mesh=mesh)
        traffic['asymgauss50'] = cap.calls
        out['asymgauss50']['spec_walks'] = walks.summary()
        torch.save(traffic_on_host(traffic),
                   os.path.join(out_dir, 'traffic%d.pt' % rank))
        print('MESH_RANK ' + json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def run_mesh_phase():
    """Two ranks on the one card: ``chip_smoke.py`` run twice more, as
    :func:`mesh_child`, in fresh interpreters joined by gloo on 127.0.0.1
    (``GLOO_SOCKET_IFNAME=lo``), the CUDA library already built here.

    Raises unless both ranks exit 0 within :data:`MESH_TIMEOUT_S` with
    identical logZ, ncall and niter for each run, both runs inside their
    gates (checked in the ranks), the eggbox's ncall the root points plus
    its billed counts, and K1, K2 and K3 launched on the mesh paths.
    Returns (per-rank summaries, the ranks' kept calls on the card, the
    phase's wall in seconds).
    """
    import os
    import tempfile
    import torch
    with tempfile.TemporaryDirectory() as tmp:
        port = free_port()
        env = dict(os.environ, GLOO_SOCKET_IFNAME='lo')
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), '--mesh-rank',
             str(rank), '--mesh-port', str(port), '--mesh-out', tmp],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env) for rank in range(MESH_RANKS)]
        try:
            outs = [p.communicate(timeout=MESH_TIMEOUT_S)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        wall = time.perf_counter() - t0
        ranks = []
        for rank, (p, out) in enumerate(zip(procs, outs)):
            lines = [ln for ln in out.splitlines()
                     if ln.startswith('MESH_RANK ')]
            assert p.returncode == 0 and lines, \
                ('mesh rank failed', rank, p.returncode, out[-4000:])
            ranks.append(json.loads(lines[-1][len('MESH_RANK '):]))
        traffic = [{name: {k: [tuple(t.cuda() if torch.is_tensor(t) else t
                                     for t in c) for c in kcalls]
                           for k, kcalls in calls.items()}
                    for name, calls in torch.load(
                        os.path.join(tmp, 'traffic%d.pt' % rank)).items()}
                   for rank in range(MESH_RANKS)]
    for run in ('eggbox', 'asymgauss50'):
        for key in ('logz', 'logzerr', 'ncall', 'niter', 'billed'):
            vals = [r[run][key] for r in ranks]
            assert len(set(vals)) == 1, ('ranks differ', run, key, vals)
        for r in ranks:
            assert r[run]['ncall'] == r[run]['billed'] + 400, \
                ('ncall is not the root points plus the billed counts', run)
    for r in ranks:
        assert r['backend'] == 'gloo' and r['nshards'] == MESH_RANKS
        assert r['radius'] == ranks[0]['radius'] and r['radius_launches'] == 1
        for name in ('radius_member', 'bootstrap_radius'):
            assert r['eggbox']['launches'].get(name, 0) > 0, \
                ('not launched on the sharded eggbox', name)
        assert r['asymgauss50']['launches'].get('consume_scan', 0) > 0, \
            'K3 not launched on the sharded asymgauss50'
    return ranks, traffic, wall


# ---------------------------------------------------------------------------
# the files outside the package: the ported examples, the fuzzer, the
# language runners and the evaluation tools, each through its own entry
# point on the card

def load_script(path, name):
    """Import the script at *path* (relative to this file) as module
    *name*: the ported examples share their file names with the JAX
    package's, so they never go on ``sys.path``."""
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(os.path.dirname(os.path.abspath(__file__)), path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def summary(res):
    """(logz, logzerr, ncall, niter) of a results dict (either
    convention: the solvecompat results use logZ / logZerr)."""
    if 'logz' in res:
        return (float(res['logz']), float(res['logzerr']),
                int(res['ncall']), int(res['niter']))
    return (float(res['logZ']), float(res['logZerr']), None, None)


def in_gate(logz, logzerr, truth, floor):
    """|logZ - truth| < max(4 logzerr, floor), as ``bench.py:353-372``."""
    return abs(logz - truth) < max(4 * logzerr, floor)


def near(post, name, truth, results):
    """Raise unless the posterior mean of *name* is within 4 of its
    standard deviations of *truth*."""
    i = results['paramnames'].index(name)
    mean, std = post['mean'][i], post['stdev'][i]
    assert abs(mean - truth) < 4 * std, ('posterior far from the truth',
                                         name, mean, std, truth)


def example_tutorial_highdim():
    m = load_script('examples/torch_port/tutorial_highdim.py',
                    'torch_port_tutorial_highdim')
    res = m.main(use_torch=True, device='cuda')
    near(res['posterior'], 'period', 7.0, res)
    return {'tutorial_highdim --torch': res}


def example_run_problem():
    m = load_script('examples/torch_port/run_problem.py',
                    'torch_port_run_problem')
    res = m.main(['--problem', 'eggbox', '--torch'], device='cuda')
    assert in_gate(res['logz'], res['logzerr'], EGGBOX_LOGZ, 1.0), \
        ('run_problem eggbox outside the gate', res['logz'])
    return {'run_problem --problem eggbox --torch': res}


def example_evaluate_scaling():
    m = load_script('examples/torch_port/evaluate_scaling.py',
                    'torch_port_evaluate_scaling')
    rows = m.main(['--methods', 'popslice'], device='cuda')
    for row in rows:
        assert in_gate(row['logz'], row['logzerr'], 0.0, 1.5), \
            ('evaluate_scaling gauss outside the gate', row)
    return {'evaluate_scaling popslice d %d' % r['ndim']: r for r in rows}


def example_tutorial_linefit():
    m = load_script('examples/torch_port/tutorial_linefit.py',
                    'torch_port_tutorial_linefit')
    r_const, r_line = m.main(device='cuda')
    assert r_line['logz'] - r_const['logz'] > 5, 'the line is not preferred'
    for name, truth in (('slope', m.slope_true), ('offset', m.offset_true),
                        ('sigma', m.sigma_true)):
        near(r_line['posterior'], name, truth, r_line)
    return {'linefit const': r_const, 'linefit line': r_line}


def example_tutorial_outliers():
    m = load_script('examples/torch_port/tutorial_outliers.py',
                    'torch_port_tutorial_outliers')
    results = m.main(device='cuda')
    best = max(results, key=lambda k: results[k]['logz'])
    assert best != 'gaussian', 'the plain gaussian won against the outliers'
    return {'outliers ' + k: v for k, v in results.items()}


def example_tutorial_intrinsic_distribution():
    m = load_script('examples/torch_port/tutorial_intrinsic_distribution.py',
                    'torch_port_tutorial_intrinsic_distribution')
    res = m.main(device='cuda')
    near(res['posterior'], 'mean', m.mean_true, res)
    near(res['posterior'], 'spread', m.spread_true, res)
    return {'intrinsic_distribution': res}


def example_tutorial_warmstart():
    import os
    import tempfile
    m = load_script('examples/torch_port/tutorial_warmstart.py',
                    'torch_port_tutorial_warmstart')
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            cold, warm, cold2 = m.main(storage_backend='csv', device='cuda')
        finally:
            os.chdir(cwd)
    dz = abs(warm['logz'] - cold2['logz'])
    assert dz < 3 * (warm['logzerr'] + cold2['logzerr']), \
        ('warm and cold logZ disagree', dz)
    return {'warmstart cold': cold, 'warmstart warm': warm,
            'warmstart cold rerun': cold2}


def example_tutorial_sine_modelcomparison():
    m = load_script('examples/torch_port/tutorial_sine_modelcomparison.py',
                    'torch_port_tutorial_sine_modelcomparison')
    out = m.main(quick=True, device='cuda')
    assert np.isfinite(out['K_simulated']).all()
    return {'sine_modelcomparison sine': out['result1'],
            'sine_modelcomparison null': out['result0']}


def example_tutorial_sine_bayesian_workflow():
    m = load_script(
        'examples/torch_port/tutorial_sine_bayesian_workflow.py',
        'torch_port_tutorial_sine_bayesian_workflow')
    out = m.main(quick=True, device='cuda')
    runs = {'bayesian_workflow fit': out['result']}
    for nsteps, res in zip(out['calib'].nsteps, out['calib'].results):
        runs['bayesian_workflow calibrator nsteps %d' % nsteps] = res
    return runs


# (name, function, what it runs at): the host tutorials that take over a
# minute at their defaults on the card's host run --quick here
EXAMPLES = (
    ('tutorial_highdim', example_tutorial_highdim, 'defaults, --torch'),
    ('run_problem', example_run_problem, 'defaults, --problem eggbox --torch'),
    ('evaluate_scaling', example_evaluate_scaling,
     'defaults, --methods popslice'),
    ('tutorial_linefit', example_tutorial_linefit, 'defaults'),
    ('tutorial_outliers', example_tutorial_outliers, 'defaults'),
    ('tutorial_intrinsic_distribution',
     example_tutorial_intrinsic_distribution, 'defaults'),
    ('tutorial_warmstart', example_tutorial_warmstart,
     'defaults, --storage-backend csv'),
    ('tutorial_sine_modelcomparison', example_tutorial_sine_modelcomparison,
     '--quick'),
    ('tutorial_sine_bayesian_workflow',
     example_tutorial_sine_bayesian_workflow, '--quick'),
)


def run_example(name, fn, how):
    """One ported example through its ``main`` on the card, every kernel
    count set to 0 just before it and read just after; prints its wall,
    each run's ncall, logZ and niter, and the launches. Its gate is
    checked in *fn*. Returns {'wall_s', 'runs', 'launches'}."""
    import torch
    from ultranest_torch.ops import kernels
    kernels.reset_counts()
    t0 = time.perf_counter()
    runs = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = dict(kernels.LAUNCHES)
    print('example %s (%s): wall %.3f s, kernel launches %s' % (
        name, how, wall, json.dumps(launched)))
    for label, res in runs.items():
        logz, logzerr, ncall, niter = summary(res)
        print('  %s: logZ %.4f +- %.4f, ncall %s, niter %s' % (
            label, logz, logzerr, ncall, niter))
    return dict(wall_s=wall, runs={k: summary(v) for k, v in runs.items()},
                launches=launched)


# tests/test_fuzz.py:13-30: the seeds and caps of the JAX package's
# fuzzer replay
FUZZ_SEEDS = range(25, 37)


def fuzz_runargs(seed, generate_runargs, log_dir):
    """The fuzzer's configuration for *seed*, capped as
    ``tests/test_fuzz.py:13-30`` caps it."""
    import random
    random.seed(seed)

    def choose(myargs):
        if random.random() < 0.25:
            return myargs[0]
        return random.choice(myargs)

    runargs = generate_runargs(choose)
    runargs['num_live_points'] = min(runargs['num_live_points'], 100)
    runargs['max_ncalls'] = min(runargs['max_ncalls'], 30000.0)
    runargs['x_dim'] = min(runargs['x_dim'], 6)
    runargs['min_ess'] = 0
    runargs['dlogz'] = max(runargs['dlogz'], 1.0)
    runargs['frac_remain'] = max(runargs['frac_remain'], 0.05)
    if runargs['log_dir'] is not None:
        runargs['log_dir'] = log_dir
    return runargs


def run_fuzz_seed(seed, tmp):
    """One fuzzer configuration on the card (run directories as csv: no
    h5py there); the fuzzer's own 3-sigma check runs inside its main."""
    import os

    import torch
    from ultranest_torch.ops import kernels
    m = load_script('examples/torch_port/testfeatures.py',
                    'torch_port_testfeatures')
    runargs = fuzz_runargs(seed, m.generate_runargs,
                           os.path.join(tmp, 'logs'))
    kernels.reset_counts()
    t0 = time.perf_counter()
    res = m.main(m.AttrDict(runargs), device='cuda', storage_backend='csv')
    torch.cuda.synchronize()
    out = dict(seed=seed, wall_s=time.perf_counter() - t0,
               launches=dict(kernels.LAUNCHES),
               config={k: runargs[k] for k in (
                   'problem', 'x_dim', 'stepsampler', 'engine', 'use_jax',
                   'segment', 'pass_transform', 'log_dir', 'resume')})
    out['ran'] = res is not None
    if res is not None:
        out.update(logz=float(res['logz']), logzerr=float(res['logzerr']),
                   ncall=int(res['ncall']), niter=int(res['niter']))
    print('fuzz seed %d %s: %s, wall %.3f s, kernel launches %s' % (
        seed, json.dumps(out['config']),
        'logZ %.4f +- %.4f, ncall %d, niter %d' % (
            out['logz'], out['logzerr'], out['ncall'], out['niter'])
        if res is not None else 'skipped by the fuzzer itself',
        out['wall_s'], json.dumps(out['launches'])))
    return out


def build_language_libraries():
    """Build ``languages/c/mylib.so`` and ``languages/c++/mycpplib.so``
    with gcc and g++ (the Makefiles' flags) beside their sources, where
    the runners load them (``languages/*/*.so`` is gitignored), and
    ``languages/fortran/myfortlib.so`` if gfortran exists. Returns
    {language: path}."""
    import os
    import shutil
    here = os.path.dirname(os.path.abspath(__file__))
    libs = {}
    for lang, compiler, src, so, extra in (
            ('c', 'gcc', 'mylib.c', 'mylib.so', ['-lm']),
            ('c++', 'g++', 'mycpplib.cpp', 'mycpplib.so', []),
            ('fortran', 'gfortran', 'myfortlib.f90', 'myfortlib.so', [])):
        if lang == 'fortran' and shutil.which('gfortran') is None:
            continue
        d = os.path.join(here, 'languages', lang)
        out = os.path.join(d, so)
        subprocess.run([compiler, '-O3', '-march=native', '-fPIC', '-shared',
                        '-o', out, os.path.join(d, src)] + extra,
                       check=True, capture_output=True, text=True,
                       timeout=120)
        libs[lang] = out
    return libs


# the runners' problems: runc's 3-d gaussian (sigma 0.1) inside the prior
# cube (-1, 1)^3, logZ = -log 8; runcpp's gaussian shell (r 0.4, width
# 0.02) in the unit cube, logZ = log(4 pi (r^2 + w^2)); runfort's
# normalised 3-d gaussian at 0.5 (sigma 0.1), logZ = 0
LANGUAGE_RUNS = (
    ('c', 'languages/c/runc_torch.py', -np.log(8.0)),
    ('c++', 'languages/c++/runcpp_torch.py',
     np.log(4 * np.pi * (0.4 ** 2 + 0.02 ** 2))),
    ('fortran', 'languages/fortran/runfort_torch.py', 0.0),
)


def run_language(lang, script):
    """One language runner's ``main`` on the card with its library
    beside it, kernel counts set to 0 just before and read just after."""
    import torch
    from ultranest_torch.ops import kernels
    m = load_script(script, 'torch_%s_runner' % lang.replace('+', 'p'))
    kernels.reset_counts()
    t0 = time.perf_counter()
    res = m.main(device='cuda', show_status=False)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, dict(kernels.LAUNCHES)


def run_audit_seeds(seeds=(1, 2, 3)):
    """``bias_audit.run_one`` on shell8 for *seeds* on the card, each
    |z| < 4; kernel counts set to 0 just before and read just after."""
    import torch
    from ultranest_torch.evaluate import bias_audit
    from ultranest_torch.ops import kernels
    kernels.reset_counts()
    rows = [bias_audit.run_one(bias_audit.PROBLEMS['shell8'], seed,
                               device='cuda') for seed in seeds]
    torch.cuda.synchronize()
    launched = dict(kernels.LAUNCHES)
    for row in rows:
        z = (row['logz'] - row['truth']) / row['logzerr']
        print('bias_audit.run_one shell8 seed %d: logZ %.4f +- %.4f (truth '
              '%.4f, z %.3f), ncall %d, wall %.2f s' % (
                  row['seed'], row['logz'], row['logzerr'], row['truth'], z,
                  row['ncall'], row['wall_s']))
        assert abs(z) < 4, ('shell8 audit seed outside |z| < 4', row)
    print('bias_audit shell8 seeds %s kernel launches %s' % (
        list(seeds), json.dumps(launched)))
    return dict(rows=rows, launches=launched)


def run_profile(problem):
    """``profile_run`` on *problem* on the card (a warm-up run, then a
    profiled one); prints the phase split and, for the spec walk, the
    host ms per round of each of the round body's callees. Kernel counts
    set to 0 just before and read just after (both runs)."""
    import contextlib
    import io

    from ultranest_torch.evaluate import profile_run
    from ultranest_torch.ops import kernels
    kernels.reset_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = profile_run.main(['--problem', problem, '--top', '15'],
                               device='cuda')
    launched = dict(kernels.LAUNCHES)
    warm, row = out['warm'], out['profiled']
    gate = (EGGBOX_LOGZ, 1.0) if problem == 'eggbox' else (0.0, 1.5)
    for r in (warm, row):
        assert in_gate(r['logz'], r['logzerr'], *gate), \
            ('profile_run %s outside the gate' % problem, r)
    print('profile_run %s: warm-up wall %.3f s, profiled wall %.3f s, ncall '
          '%d, logZ %.4f +- %.4f, kernel launches %s' % (
              problem, warm['wall_s'], row['wall_s'], row['ncall'],
              row['logz'], row['logzerr'], json.dumps(launched)))
    print('profile_run %s phases (s), warm-up: %s; profiled: %s' % (
        problem, json.dumps(warm['phases_s']), json.dumps(row['phases_s'])))
    if out['round_split_ms']:
        print('profile_run %s host ms per spec-walk round (%d rounds, '
              'profiled; total %.4f): %s' % (
                  problem, row['rounds'], out['round_split_total_ms'],
                  json.dumps({k: round(v, 4) for k, v in list(
                      out['round_split_ms'].items())[:15]})))
    tottime = buf.getvalue().split('==== sorted by tottime ====')[-1]
    print('profile_run %s top tottime entries:' % problem)
    for line in tottime.strip().splitlines()[:24]:
        print('  ' + line)
    return dict(out, launches=launched)


def walk_gaps(kernels, walk_launches, boundaries):
    """K4's, K5's, K6's and K7's launches x (device ms - bound ms) over
    the paths: *walk_launches* maps a path to each kernel's launches by
    shape (:meth:`Walks.summary`), *boundaries* to its sync walks' step
    boundaries by shape. Each shape is timed once among 50 calls in a
    CUDA graph, as the paths' graphs run the kernels, beside its bound:
    K4 on :func:`spec_round_inputs` at its depth (1 for the sync walk),
    K5 mid-dispatch (:func:`mid_dispatch_update`), K6 inside a step and
    at a boundary (:func:`sync_round_inputs`; the boundary launches
    weighed apart), K7's step with its next proposal and its prologue on
    :func:`rwalk_round_inputs`. Prints each shape and returns {kernel:
    ms}."""
    shapes = collections.defaultdict(collections.Counter)
    for by_kernel in walk_launches.values():
        for k, by_shape in by_kernel.items():
            shapes[k].update(by_shape)
    nbound = collections.Counter()
    for by_shape in boundaries.values():
        nbound.update(by_shape)

    def paths_of(k, key):
        return ', '.join(sorted(p for p, v in walk_launches.items()
                                if key in v.get(k, {})))
    gap = {k: 0.0 for k in kernels.POPULATION_KERNELS}
    rng = np.random.RandomState(7)
    for key, n in sorted(shapes['spec_propose'].items()):
        P, D, d = (int(x) for x in key.split(','))
        st, xibank = spec_round_inputs(rng, P, D, d)[:2]
        prop = (st['u'], st['v'], st['tl'], st['tr'], xibank, st['it'])
        g = graph_ms(lambda: kernels.spec_propose(*prop))
        b = propose_bound(P, D, d)[0]
        gap['spec_propose'] += n * (g - b)
        print('K4 at P=%d D=%d d=%d, %d launches on the paths (%s): in a '
              'graph %.4f ms (bound %.6f)' % (P, D, d, n,
                                              paths_of('spec_propose', key),
                                              g, b))
    for key, n in sorted(shapes['spec_update'].items()):
        P, D, d = (int(x) for x in key.split(','))
        st, xibank, _, Lp, tin, Lmin = spec_round_inputs(rng, P, D, d)
        prop = (st['u'], st['v'], st['tl'], st['tr'], xibank, st['it'])
        ts, tlc, trc, _ = kernels.spec_propose(*prop)
        upd, b = mid_dispatch_update(kernels, st, Lp, tin, ts, tlc, trc,
                                     Lmin)
        g = graph_ms(lambda: kernels.spec_update(*upd))
        del upd
        gap['spec_update'] += n * (g - b)
        print('K5 at P=%d D=%d d=%d, %d launches on the paths (%s): '
              'mid-dispatch in a graph %.4f ms (bound %.6f)' % (
                  P, D, d, n, paths_of('spec_update', key), g, b))
    for key, n in sorted(shapes['sync_update'].items()):
        P, d = (int(x) for x in key.split(','))
        times = {}
        for kind in ('mid', 'boundary'):
            st, tbank, dirbank, Lp, tin, Lmin, max_it = \
                sync_round_inputs(rng, P, d, kind)
            ts, tlc, trc, _ = kernels.spec_propose(
                st['u'], st['v'], st['tl'], st['tr'], tbank, st['row'])
            b = sync_update_bound(P, d, tin, st, Lp, Lmin,
                                  kind == 'boundary')[0]
            a = (Lp, tin, ts, tlc, trc, Lmin, dirbank, max_it, st)
            times[kind] = (graph_ms(lambda: kernels.sync_update(*a)), b)
            del a, st, dirbank
        nb = min(nbound[key], n)
        (gm, bm), (gb, bb) = times['mid'], times['boundary']
        gap['sync_update'] += (n - nb) * (gm - bm) + nb * (gb - bb)
        print('K6 at P=%d d=%d, %d launches on the paths (%s), %d of them '
              'step boundaries: in a graph %.4f ms inside a step (bound '
              '%.6f), %.4f ms at a boundary (bound %.6f)' % (
                  P, d, n, paths_of('sync_update', key), nb, gm, bm, gb, bb))
    for key, n in sorted(shapes['rwalk_accept'].items()):
        P, d = (int(x) for x in key.split(','))
        Lev, tin, up, Lmin, st, m, scale = rwalk_round_inputs(rng, P, d)
        b = rwalk_accept_bound(P, d, tin, Lev, up, Lmin)[0]
        g = graph_ms(lambda: kernels.rwalk_accept(Lev, tin, up, Lmin, st, m,
                                                  scale))
        # the prologues among the launches are charged as steps
        gap['rwalk_accept'] += n * (g - b)
        print('K7 at P=%d d=%d, %d launches on the paths (%s), its '
              'prologues included: a step with its next proposal in a '
              'graph %.4f ms (bound %.6f)' % (
                  P, d, n, paths_of('rwalk_accept', key), g, b))
    return gap


def print_ranking(real, spec=None):
    """Prints each kernel's launches x (device ms - bound ms) summed over
    the sampler paths of this run, largest first, every term from the
    path's own replayed calls (*real*: kernel -> path -> its numbers)
    and, for K4 to K7, from their launches by shape (*spec*:
    :func:`walk_gaps`)."""
    gap = {k: sum(r['calls'] * (r['device_ms'] - r['bound_ms'])
                  for r in paths.values()) for k, paths in real.items()}
    gap.update(spec or {})
    gap['radius_member_t'] = 0.0
    print('ranking by launches x (device ms - bound ms) over the sampler '
          'paths: ' + ', '.join(
              '%s %.3f ms' % (k, v) for k, v in sorted(
                  gap.items(), key=lambda kv: -kv[1])))
    return gap


def main(argv=()):
    """*argv*: ``--save-traffic PATH`` also saves every path's K1, K2 and
    K3 inputs (``torch.save``: path -> kernel -> list of calls, the
    tensors on the CPU) for ``scripts/bench_kernels.py``. ``--mesh-rank R
    --mesh-port P --mesh-out DIR`` runs one rank of the mesh phase
    (:func:`mesh_child`; :func:`run_mesh_phase` starts the ranks)."""
    if '--mesh-rank' in argv:
        opt = {flag: argv[argv.index(flag) + 1]
               for flag in ('--mesh-rank', '--mesh-port', '--mesh-out')}
        return mesh_child(int(opt['--mesh-rank']), int(opt['--mesh-port']),
                          opt['--mesh-out'])
    save_traffic = argv[argv.index('--save-traffic') + 1] \
        if '--save-traffic' in argv else None
    import torch
    t_start = time.time()
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
    # the kernels whose launches are summed over the paths: the region
    # path's, K8 of the region rebuilds, the population walks'
    path_kernels = kernels.REGION_KERNELS + ('radius_graph',) + \
        kernels.POPULATION_KERNELS
    t0 = time.time()
    so = kernels.build()
    print('built %s in %.2f s' % (so.rsplit('/', 1)[-1], time.time() - t0))
    for name, regs, spill in ptxas_summary(kernels.BUILD_LOG):
        print('  ptxas: %s: %d registers, %d bytes spilled' % (name, regs,
                                                              spill))
        assert spill == 0, ('a kernel spills registers', name)

    rng = np.random.RandomState(0)
    # each kernel's numbers at each shape: (max |err|, kernel ms, plain
    # ms, bound ms, what bounds it, device ms); the JSON line takes the
    # first shape's
    errs, launches, shapes = {}, {}, {}
    for npad, m, d in MEMBER_SHAPES:
        res = check_radius_member(kernels, rng, npad, m, d)
        errs['radius_member'] = max(errs.get('radius_member', 0.0), res[0])
        shapes.setdefault('radius_member', []).append(res)
    for n, nrounds, d in BOOTSTRAP_SHAPES:
        res = check_bootstrap_radius(kernels, rng, n, nrounds, d)
        errs['bootstrap_radius'] = max(errs.get('bootstrap_radius', 0.0),
                                       res[0])
        shapes.setdefault('bootstrap_radius', []).append(res)
    shapes['consume_scan'] = [check_consume_scan(kernels, rng, *shape)
                              for shape in SCAN_SHAPES]
    errs['consume_scan'] = 0.0
    shapes['radius_graph'] = [check_radius_graph(kernels, rng, *shape)
                              for shape in GRAPH_SHAPES]
    errs['radius_graph'] = max(res[0] for res in shapes['radius_graph'])
    registers = {name: regs for name, regs, _ in
                 ptxas_summary(kernels.BUILD_LOG)}
    floor = check_launch_floor()[1]
    spec = [check_spec_kernels(kernels, rng, *shape, registers=registers)
            for shape in SPEC_SHAPES]
    for i, name in enumerate(WALK_KERNELS['spec']):
        shapes[name] = [res[i] for res in spec]
    shapes['sync_update'] = [check_sync_kernels(kernels, rng, *shape,
                                                registers=registers,
                                                floor=floor)
                             for shape in SYNC_SHAPES]
    shapes['rwalk_accept'] = [check_rwalk_kernel(kernels, rng, *shape,
                                                 registers=registers,
                                                 floor=floor)
                              for shape in RWALK_SHAPES]
    for name in kernels.POPULATION_KERNELS:
        errs[name] = 0.0
        launches[name] = 0
    torch.cuda.synchronize()

    rows, launches['radius_member_t'] = check_membership_shootout(kernels)
    errs['radius_member_t'] = 0.0
    shapes['radius_member_t'] = [(0.0, rows[0]['k1t_ms'], rows[0]['plain_ms'],
                                  rows[0]['bound_ms'], rows[0]['bound_by'])]
    print('membership shootout kernel launches: %d of K1t'
          % launches['radius_member_t'])

    # every path's K1, K2 and K3 calls are kept (KernelCapture) and
    # replayed after the runs: the kernels on real traffic; every spec
    # sampler's depth decision is printed and kept (DepthProbes)
    traffic, path_launches = {}, {}
    probes = DepthProbes().__enter__()
    eggbox_sampler = []
    with KernelCapture(kernels) as cap:
        run = run_eggbox(keep=eggbox_sampler)
    traffic['eggbox'] = cap.calls
    print('eggbox: logZ %.4f +- %.4f (quadrature %.3f), wall %.3f s, '
          'ncall %d, %.0f evals/s, niter %d' % (
              run['logz'], run['logzerr'], EGGBOX_LOGZ, run['wall_s'],
              run['ncall'], run['evals_per_s'], run['niter']))
    print('eggbox phases (s):', json.dumps(run['phases_s']))
    print('eggbox segment exits:', json.dumps(run['segment_exits']))
    print('eggbox kernel launches:', json.dumps(run['launches']))
    graphs = sum(v for k, v in run['phases_s'].items()
                 if k.endswith('/graph#'))
    assert graphs == run['launches'].get('radius_graph', 0) > 0 and not any(
        k.endswith('/graph_host#') for k in run['phases_s']), \
        ('eggbox rebuilds not all through K8', graphs)
    print('eggbox K8: %d launches, one a transform layer (%.4f s under '
          '*/layer/graph)' % (graphs, sum(
              v for k, v in run['phases_s'].items()
              if k.endswith('/graph'))))
    path_launches['eggbox'] = run['launches']
    for name in kernels.REGION_KERNELS + ('radius_graph',):
        launches[name] = run['launches'][name]

    eggbox_region = eggbox_sampler[0].region
    plots = check_plots(eggbox_sampler.pop())
    print('eggbox sampler.plot(): ' + (
        'matplotlib is not installed here, the plots were not drawn'
        if plots is None else 'wrote ' + ', '.join(
            '%s.pdf (%d bytes)' % kv for kv in plots.items())))

    launch_s, rounds, spec_kept = 0.0, 0, {}
    spec_problems = ('asymgauss50', 'rosenbrock8', 'multishell8',
                     'loggamma30', 'gauss100')
    for name in spec_problems:
        # a dispatch of asymgauss50 and of gauss100 is kept, to be run
        # again from the host loop and as graphs (check_walk_traffic)
        probes.path = name
        with KernelCapture(kernels) as cap, Walks() as walks, \
                DispatchKeeper(5) as keeper:
            run = run_population_problem(name)
        traffic[name] = cap.calls
        path_launches[name] = run['launches']
        print_population_run(run)
        check_walk_path(name, walks.summary(), run['launches'], ('spec',))
        if name in ('asymgauss50', 'gauss100'):
            spec_kept[name] = keeper.kept
        launch_s += run['phases_s']['launch']
        rounds += run['rounds']
        for k in kernels.POPULATION_KERNELS:
            launches[k] += run['launches'].get(k, 0)
        if name == 'rosenbrock8':
            print('rosenbrock8: the JAX package on a TPU gave logZ -42.915 '
                  '+- 0.483 (BENCH_r05.json), an algorithmic yardstick')
        if name == 'gauss100':
            assert run['nsteps_final'] > 100, 'the governor never grew nsteps'
        # K3 runs on every path from here on: its count is the sum
        launches['consume_scan'] += run['launches']['consume_scan']
        if run['spec_depth'] < 8:
            # a lowered depth must not cost time: the same run at depth 8
            probes.path = name + ' at depth 8'
            fixed = run_population_problem(name, spec_depth=8,
                                           spec_depth_auto=False)
            print('%s: the probe chose depth %d: wall %.3f s, ncall %d, logZ '
                  '%.4f; at depth 8: wall %.3f s, ncall %d, logZ %.4f' % (
                      name, run['spec_depth'], run['wall_s'], run['ncall'],
                      run['logz'], fixed['wall_s'], fixed['ncall'],
                      fixed['logz']))
    print('spec-walk launch phase over the five problems: %.3f s over %d '
          'rounds, %.4f ms per round' % (launch_s, rounds,
                                         1e3 * launch_s / rounds))
    measure_round_overheads(spec_problems)
    for name, kept in spec_kept.items():
        assert kept is not None, ('no dispatch kept', name)
        check_walk_traffic(kernels, name, kept)
    del spec_kept
    # the slowest bench problem, at the bench's configuration
    probes.path = 'gauss100_hard'
    with KernelCapture(kernels) as cap, Walks() as walks:
        run = run_population_problem('gauss100_hard')
    traffic['gauss100_hard'] = cap.calls
    path_launches['gauss100_hard'] = run['launches']
    print_population_run(run)
    check_walk_path('gauss100_hard', walks.summary(), run['launches'],
                    ('spec',))
    for k in path_kernels:
        launches[k] += run['launches'].get(k, 0)

    engines, engine_kept = {}, {}
    for name in ('sync', 'async', 'sync8', 'rwalk', 'async_classic'):
        # a dispatch of each sync and random-walk run is kept, to be run
        # again from the host loop and as graphs (check_engine_traffic)
        with KernelCapture(kernels) as cap, Walks() as walks, \
                DispatchKeeper(5, rwalk=name == 'rwalk') as keeper:
            run = engines[name] = run_engine(name)
        if ENGINE_WALKS[name] != ('spec',):
            engine_kept[name] = keeper.kept
        traffic[name] = cap.calls
        path_launches[name] = run['launches']
        check_walk_path('engine ' + name, walks.summary(), run['launches'],
                        ENGINE_WALKS[name])
        print('engine %s: logZ %.4f +- %.4f, wall %.3f s, ncall %d, niter '
              '%d, ncall/niter %.3f, %d dispatches, %d rounds, %d host '
              'reads, %d replays, %d captures, %.4f ms a round (wall over '
              'rounds), scale %.4g' % (
                  name, run['logz'], run['logzerr'], run['wall_s'],
                  run['ncall'], run['niter'], run['ncall_per_iter'],
                  run['dispatches'], run['rounds'], run['reads'],
                  run['replays'], run['captures'], run['ms_per_round'],
                  run['scale']))
        print('engine %s segment exits:' % name,
              json.dumps(run['segment_exits']))
        print('engine %s kernel launches:' % name,
              json.dumps(run['launches']))
        for k in path_kernels:
            launches[k] += run['launches'].get(k, 0)
    ratio = engines['async']['ncall_per_iter'] / \
        engines['sync8']['ncall_per_iter']
    print('async vs sync on asymgauss8: ncall/niter %.3f vs %.3f, ratio %.3f '
          '(the JAX package asserts < 0.7)' % (
              engines['async']['ncall_per_iter'],
              engines['sync8']['ncall_per_iter'], ratio))
    assert ratio < 0.7, ('async not cheaper than sync', ratio)
    for name, kept in engine_kept.items():
        assert kept is not None, ('no dispatch kept', name)
        check_engine_traffic(kernels, 'engine ' + name, kept)
    del engine_kept

    # the host tier on the card: the classic sampler and a host step
    # sampler, their regions built (K2) on the device
    with KernelCapture(kernels) as cap:
        run = run_classic_sampler()
    traffic['classic'] = cap.calls
    path_launches['classic'] = run['launches']
    print('classic NestedSampler: logZ %.4f +- %.4f (analytic %.4f, gate '
          '1.0), wall %.3f s, ncall %d, niter %d, %d region rebuilds, kernel '
          'launches %s, plain calls %s' % (
              run['logz'], run['logzerr'], run['logz_expected'],
              run['wall_s'], run['ncall'], run['niter'], run['rebuilds'],
              json.dumps(run['launches']), json.dumps(run['plain_calls'])))
    launches['bootstrap_radius'] += run['launches']['bootstrap_radius']
    with KernelCapture(kernels) as cap:
        run = run_host_slice_sampler()
    traffic['host_slice'] = cap.calls
    path_launches['host_slice'] = run['launches']
    print('host SliceSampler (mixture directions) on gauss d %d: logZ %.4f '
          '+- %.4f (analytic %.4f, gate 2.0), wall %.3f s, ncall %d, niter '
          '%d, nsteps %d, %d chains, rejection rate %.3f, far enough %.3f, '
          'kernel launches %s, plain calls %s' % (
              run['ndim'], run['logz'], run['logzerr'], run['logz_expected'],
              run['wall_s'], run['ncall'], run['niter'], run['nsteps'],
              run['chains'], run['rejection_rate'], run['frac_far_enough'],
              json.dumps(run['launches']), json.dumps(run['plain_calls'])))
    launches['bootstrap_radius'] += run['launches']['bootstrap_radius']

    # the stored runs, warm starts, calibrator, dispatch watchdog and
    # trajectory samplers
    check_label_propagation(eggbox_region)
    check_deadline_spin()

    def path(name, run_fn, *args):
        """Runs one path under KernelCapture and books its traffic and
        launches (*run_fn* returns a summary with its ``launches``); its
        spec walks must run as CUDA graphs (and some must, on the paths
        of :data:`SPEC_PATHS`)."""
        probes.path = name
        with KernelCapture(kernels) as cap, Walks() as walks:
            out = run_fn(*args)
        traffic[name] = cap.calls
        path_launches[name] = out['launches']
        for k in path_kernels:
            launches[k] += out['launches'].get(k, 0)
        check_walk_path(name, walks.summary(), out['launches'],
                        ('spec',) if name in SPEC_PATHS else ())
        return out

    for kind in ('rejection', 'population'):
        path('watchdog_' + kind, run_watchdog, kind)
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        for kind in ('eggbox', 'gauss'):
            warm = path('warm_start_' + kind, run_warm_start, kind, tmp)
            print('warm start %s: niter %d cold, %d warm; ncall %d cold, %d '
                  'warm; wall %.3f s cold, %.3f s warm' % (
                      kind, warm['cold']['niter'], warm['warm']['niter'],
                      warm['cold']['ncall'], warm['warm']['ncall'],
                      warm['cold']['wall_s'], warm['warm']['wall_s']))
        stored = run_stored_runs(tmp)
    if stored is None:
        print('read_file and resume-similar: h5py is not installed here, '
              'they were skipped (both read HDF5 point stores)')
    check_reuse_samples()
    path('calibrator', run_calibrator)
    path('trajectory', run_trajectory)

    # the mesh phase: the collectives on a one-rank NCCL group, then two
    # ranks on the card over gloo; their K1, K2 and K3 calls are kept
    # and replayed as every other path's
    check_nccl_collectives()
    ranks, mesh_traffic, mesh_wall = run_mesh_phase()
    for r, calls in zip(ranks, mesh_traffic):
        print('mesh rank %d of %d (%s): sharded radius %.9g (K2 launches %d) '
              'bit-equal to K2 on all 30 rounds, %.3f s' % (
                  r['rank'], r['nshards'], r['backend'], r['radius'],
                  r['radius_launches'], r['radius_wall_s']))
        for run in ('eggbox', 'asymgauss50'):
            m = r[run]
            print('mesh rank %d %s: logZ %.4f +- %.4f, wall %.3f s, ncall %d '
                  '(billed %d + 400 root points), niter %d, kernel launches '
                  '%s' % (r['rank'], run, m['logz'], m['logzerr'],
                          m['wall_s'], m['ncall'], m['billed'], m['niter'],
                          json.dumps(m['launches'])))
            name = 'mesh_%s_rank%d' % (run, r['rank'])
            traffic[name] = calls[run]
            path_launches[name] = m['launches']
            for k in path_kernels:
                launches[k] += m['launches'].get(k, 0)
            check_walk_path(name, m['spec_walks'], m['launches'],
                            ('spec',) if run == 'asymgauss50' else ())
    print('mesh phase: %d ranks on one card, identical logZ, ncall and niter '
          'on every rank, %.1f s' % (len(ranks), mesh_wall))

    # the files outside the package, each through its own entry point:
    # the examples, the fuzzer, the language runners and the evaluation
    # tools (every path booked as the ones above)
    import os
    import shutil
    t_phase = time.time()
    for name, fn, how in EXAMPLES:
        path('example_' + name, run_example, name, fn, how)
    print('examples phase: %.1f s' % (time.time() - t_phase))
    t_phase = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        fuzz = [path('fuzz_%d' % seed, run_fuzz_seed, seed,
                     os.path.join(tmp, str(seed))) for seed in FUZZ_SEEDS]
    print('fuzz phase: seeds %d-%d, %d configurations ran, %d skipped by the '
          'fuzzer itself, every check passed, %.1f s' % (
              FUZZ_SEEDS[0], FUZZ_SEEDS[-1], sum(f['ran'] for f in fuzz),
              sum(not f['ran'] for f in fuzz), time.time() - t_phase))
    t_phase = time.time()
    libs = build_language_libraries()
    print('languages: built %s in %.2f s' % (
        ', '.join('%s %s' % kv for kv in sorted(libs.items())),
        time.time() - t_phase))
    if 'fortran' not in libs:
        print('fortran: not run (no gfortran)')
    assert shutil.which('gcc') and shutil.which('g++')

    def language(lang, script, truth):
        res, wall, launched = run_language(lang, script)
        print('language %s (%s): logZ %.4f +- %.4f (analytic %.4f), ncall %d, '
              'niter %d, wall %.3f s, kernel launches %s' % (
                  lang, script.rsplit('/', 1)[-1], res['logz'],
                  res['logzerr'], truth, res['ncall'], res['niter'], wall,
                  json.dumps(launched)))
        assert in_gate(res['logz'], res['logzerr'], truth, 1.0), \
            ('%s runner outside the gate' % lang, res['logz'])
        return dict(launches=launched)

    for lang, script, truth in LANGUAGE_RUNS:
        if lang in libs:
            path('language_' + lang, language, lang, script, truth)
    print('languages phase: %.1f s' % (time.time() - t_phase))
    t_phase = time.time()
    path('bias_audit_shell8', run_audit_seeds)
    for problem in ('asymgauss50', 'eggbox'):
        path('profile_run_' + problem, run_profile, problem)
    print('evaluate phase: %.1f s' % (time.time() - t_phase))

    checks = {'consume_scan': check_scan_traffic,
              'radius_member': check_member_traffic,
              'bootstrap_radius': check_bootstrap_traffic}
    real = {k: {name: check(kernels, name, calls[k])
                for name, calls in traffic.items() if calls[k]}
            for k, check in checks.items()}
    for k, paths in real.items():
        for name, counts in path_launches.items():
            assert paths.get(name, {'calls': 0})['calls'] == \
                counts.get(k, 0), ('calls kept and launched differ', k, name)
    if save_traffic:
        torch.save(traffic_on_host(traffic), save_traffic)
    spec = walk_gaps(kernels, WALK_LAUNCHES, SYNC_BOUNDARIES)
    for k in kernels.POPULATION_KERNELS:
        by_shape = sum(sum(v.get(k, {}).values())
                       for v in WALK_LAUNCHES.values())
        print('%s launches on the paths: %d by shape, %d counted'
              % (k, by_shape, launches[k]))
        assert by_shape == launches[k], \
            ('the launches by shape miss some of %s' % k)

    print_ranking(real, spec)
    print('spec depths chosen by the probe (path, popsize, d, depth): %s' % (
        json.dumps([(r['path'], r['popsize'], r['x_dim'], r['depth'])
                    for r in probes.rows])))
    print('chip_smoke: every phase passed in %.1f s' % (time.time() - t_start))

    # no single PyTorch call computes any of the nine functions, so none
    # has a library yardstick (library_ms null); K7's launches are its
    # steps' and its prologues'
    print(json.dumps({'kernels': [
        dict(name=name, route='cuda', source=KERNEL_NOTES[name][0],
             replaces=KERNEL_NOTES[name][1], launches=launches[name],
             max_abs_err=errs[name], ms=shapes[name][0][1],
             plain_ms=shapes[name][0][2], bound_ms=shapes[name][0][3],
             bound_by=shapes[name][0][4], library_ms=None)
        for name in kernels.KERNELS]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
