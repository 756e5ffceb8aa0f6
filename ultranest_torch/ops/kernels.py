# noqa: D400 D205
"""
Hand-written CUDA kernels of the region-rejection path
------------------------------------------------------

Nine kernels, sources in ``ultranest_torch/csrc/``:

* K1 :func:`radius_member` (``csrc/radius_member.cu``) replaces the
  Pallas ``_member_kernel`` (``ultranest_tpu/ops/pallas_kernels.py``);
* K1t :func:`radius_member_t` (``csrc/radius_member_t.cu``) replaces the
  Pallas ``_member_kernel_t`` of the membership shootout
  (``evaluate/bench_pallas_membership.py``), K1 on transposed operands;
* K2 :func:`bootstrap_radius` (``csrc/bootstrap_radius.cu``) replaces
  the Pallas ``_bootstrap_kernel`` (same file);
* K3 :func:`consume_scan` (``csrc/consume_scan.cu``) replaces the XLA
  scan of ``ultranest_tpu/segmentops.py:78-134``;
* K4 :func:`spec_propose` (``csrc/spec_propose.cu``) and K5
  :func:`spec_update` (``csrc/spec_update.cu``) are the two halves of a
  round of the spec walk around the user's likelihood: the body of the
  JAX package's ``lax.while_loop`` (``ultranest_tpu/popfused.py:575-585``
  and ``:587-640``); K4 at D = 1 is also the propose half of a shrink
  iteration of the sync walk;
* K6 :func:`sync_update` (``csrc/sync_update.cu``) is the update half
  of that iteration and the step boundary around it, one kernel launch
  a round: the body and step of the JAX package's sync engine
  (``ultranest_tpu/popfused.py:849-870``);
* K7 :func:`rwalk_accept` (``csrc/rwalk_accept.cu``) is a random-walk
  step after the likelihood, its acceptance and the next step's
  proposal (``:1612-1621``); with no likelihoods it is the walk's
  prologue, step 0's proposal;
* K8 :func:`radius_graph` (``csrc/radius_graph.cu``) is the transform
  layer's two radius graphs of a region rebuild, the clustering and the
  local centring, which the JAX package builds with XLA and on the host
  (``ultranest_tpu/ops/cluster.py:37-118``,
  ``ultranest_tpu/ops/pairwise.py:243``).

Each source file says what bounds its kernel on an H100 and what its
design does about it. K1, K1t and K2 share ``csrc/member_core.cuh``: the
point in registers, the separately rounded distance, the compacted
axis-major tile of live points and the group vote. K1 and K1t are one
kernel body, ``csrc/member_kernel.cuh``, instantiated per layout. K5
and K6 share the cube chord, ``csrc/chord.cuh``.

Build: on first use, one ``nvcc -gencode arch=compute_90a,code=sm_90a``
per source compiles the sources in parallel, and one more links the
objects into a shared library with a plain C interface, under
``ultranest_torch/_build/`` (or, where the package directory cannot be
written, under the user's cache directory: :func:`build_dir`), named by
a hash of the sources and flags.
It is loaded with ctypes: pointers and the stream go as ``c_void_p``.

Routing: each wrapper runs its plain torch version (``*_plain``) when
the tensors it is given lie on the CPU, and only then. On a CUDA tensor
it checks device, dtype, shape and contiguity, launches the kernel on
``torch.cuda.current_stream()`` and raises if the launch reports an
error; there is no fallback. ``LAUNCHES`` counts kernel launches, and
nothing else; ``PLAIN_CALLS`` counts wrapper calls the plain version
served on the CPU. A launch made while the current stream is being
captured into a CUDA graph runs nothing yet: it counts in ``CAPTURED``,
and each replay of the graph adds the graph's launches to ``LAUNCHES``
(:class:`ultranest_torch.popfused.SpecGraphs`, which holds the spec,
async, sync and random walks' graphs).
"""

import collections
import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import threading

import torch

from ..native import build_dir

__all__ = ['radius_member', 'radius_member_t', 'bootstrap_radius',
           'consume_scan', 'spec_propose', 'spec_update', 'sync_update',
           'rwalk_accept', 'radius_graph',
           'radius_graph_plain', 'radius_graph_parts', 'radius_graph_fits',
           'radius_member_plain',
           'radius_member_t_plain',
           'bootstrap_radius_plain', 'consume_scan_plain',
           'spec_propose_plain', 'spec_update_plain', 'sync_update_plain',
           'rwalk_accept_plain', 'cube_intersection',
           'SPEC_STATE',
           'SYNC_STATE', 'RWALK_STATE', 'build', 'LAUNCHES', 'PLAIN_CALLS',
           'CAPTURED',
           'reset_counts', 'KERNELS', 'REGION_KERNELS', 'POPULATION_KERNELS',
           'member_group_size', 'build_dir']

KERNELS = ('radius_member', 'radius_member_t', 'bootstrap_radius',
           'consume_scan', 'spec_propose', 'spec_update', 'sync_update',
           'rwalk_accept', 'radius_graph')
# the kernels the region-rejection path launches, whose plain versions
# serve it on the CPU (K1t runs only in the membership shootout,
# ultranest_torch.evaluate.bench_membership; K8, which the region
# rebuilds launch on a card, leaves the CPU to the host path:
# ops.cluster.radius_graphs)
REGION_KERNELS = ('radius_member', 'bootstrap_radius', 'consume_scan')
# the rounds of the population walks: K4 and K5 of the spec and async
# walks (popfused.spec_walk), K4 and K6 of the sync walk
# (popfused.sync_walk), K7 of the random walk, its prologue included
# (popfused.rwalk_walk)
POPULATION_KERNELS = ('spec_propose', 'spec_update', 'sync_update',
                      'rwalk_accept')
SOURCES = ('radius_member.cu', 'radius_member_t.cu', 'bootstrap_radius.cu',
           'consume_scan.cu', 'spec_propose.cu', 'spec_update.cu',
           'sync_update.cu', 'rwalk_accept.cu', 'radius_graph.cu')
# headers the sources include: hashed with them, so that an edit rebuilds
HEADERS = ('member_core.cuh', 'member_kernel.cuh', 'chord.cuh')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v']
# largest live set K3 takes: one 1024-thread CTA keeps live sets above
# 1024 in shared memory (128 KB of the 227 KB)
MAX_SCAN_NPAD = 32768
# largest dimension K1 and K1t take: above d 32 a block stages its
# candidates in shared memory, at most 128 KB of them (8 candidates at
# this d)
MAX_MEMBER_DIM = 4096
_MEMBER_THREADS = 256
_MEMBER_CAND_BYTES = 128 * 1024
# the largest live set K8 takes: every block stages both point sets,
# 8 N d bytes, in shared memory (96 KB at the cap), and a row's
# coordinates and sums sit in registers up to d 32, the largest
# instantiation of csrc/radius_graph.cu (its kMaxDim)
MAX_GRAPH_ELEMS = 12288
MAX_GRAPH_DIM = 32
# threads a K1 or K1t launch aims for (a quarter of what the card holds at once:
# timed on an H100 at M 4096 to 131072, each lane testing 8 rows at a time)
_MEMBER_TARGET_THREADS = 1 << 16

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, 'csrc')
# where the library is built: here or, if the package directory cannot
# be written, in the user's cache directory (build_dir; it raises when
# neither can)
BUILD_DIR = os.path.join(_PKG, '_build')

LAUNCHES = collections.Counter()
PLAIN_CALLS = collections.Counter()
CAPTURED = collections.Counter()

_LIB = None
_LOCK = threading.Lock()
BUILD_LOG = ''


def reset_counts():
    """Set every launch and plain-call count to 0."""
    LAUNCHES.clear()
    PLAIN_CALLS.clear()


def _nvcc():
    for cand in (os.environ.get('NVCC'),
                 os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                              'bin', 'nvcc'),
                 shutil.which('nvcc')):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found: set NVCC or CUDA_HOME')


def build():
    """Compile the CUDA sources (once per source hash); returns the path.

    :data:`BUILD_LOG` holds the compilers' output (``-Xptxas -v``: each
    kernel's registers and spills), also where the library was built
    before (kept beside it).
    """
    global BUILD_LOG
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    srcs = [os.path.join(_CSRC, s) for s in SOURCES]
    for s in srcs + [os.path.join(_CSRC, s) for s in HEADERS]:
        with open(s, 'rb') as f:
            h.update(f.read())
    out_dir = build_dir(BUILD_DIR)
    so = os.path.join(out_dir, 'libultranest_kernels-%s.so'
                      % h.hexdigest()[:16])
    if os.path.exists(so):
        # the compilers' report (registers, spills) of the build that made it
        if os.path.exists(so + '.log'):
            with open(so + '.log') as f:
                BUILD_LOG = f.read()
        return so
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmpdir:
        objs = [os.path.join(tmpdir, os.path.basename(s) + '.o')
                for s in srcs]
        # one compiler per source, all started together
        procs = [subprocess.Popen(
            [nvcc] + NVCC_FLAGS + ['-c', s, '-o', o],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(srcs, objs)]
        logs = [p.communicate(timeout=600)[0] for p in procs]
        BUILD_LOG = ''.join(logs)
        if any(p.returncode != 0 for p in procs):
            raise RuntimeError('nvcc failed:\n' + BUILD_LOG)
        tmp = os.path.join(tmpdir, 'lib.so')
        proc = subprocess.run([nvcc, '-shared', '-o', tmp] + objs,
                              capture_output=True, text=True, timeout=600)
        BUILD_LOG += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError('nvcc link failed:\n' + BUILD_LOG)
        with open(tmp + '.log', 'w') as f:
            f.write(BUILD_LOG)
        os.replace(tmp + '.log', so + '.log')
        os.replace(tmp, so)
    return so


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.un_radius_member.argtypes = [vp, vp, ci, vp, ci, ci, cf, ci,
                                             vp, vp]
            lib.un_radius_member_t.argtypes = [vp, vp, ci, vp, ci, ci, cf,
                                               ci, vp, vp]
            lib.un_bootstrap_radius.argtypes = [vp, vp, vp, ci, ci, ci, vp,
                                                vp, vp]
            lib.un_consume_scan.argtypes = [vp, ci, vp, vp, ci, vp, vp, vp]
            lib.un_spec_propose.argtypes = [vp] * 6 + [ci] * 5 + [vp] * 5
            lib.un_spec_update.argtypes = [vp] * 7 + [ci] * 4 + [vp] * 13
            lib.un_sync_update.argtypes = [vp] * 7 + [ci] * 5 + [vp] * 16
            lib.un_rwalk_accept.argtypes = [vp] * 6 + [ci] * 2 + [vp] * 5
            lib.un_radius_graph.argtypes = [vp, vp, ci, ci, cf, vp, vp, vp]
            for fn in (lib.un_radius_member, lib.un_radius_member_t,
                       lib.un_bootstrap_radius, lib.un_consume_scan,
                       lib.un_spec_propose, lib.un_spec_update,
                       lib.un_sync_update, lib.un_rwalk_accept,
                       lib.un_radius_graph):
                fn.restype = ci
            _LIB = lib
    return _LIB


def _on_cpu(*tensors):
    """True for CPU tensors, False for CUDA ones; raises on a mix."""
    kinds = {t.device.type for t in tensors}
    if kinds == {'cpu'}:
        return True
    if kinds == {'cuda'} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError('kernel inputs must all lie on the CPU or all on one '
                     'CUDA device, got %s' % sorted(map(str, kinds)))


def _check(t, name, dtype, ndim):
    if t.dtype != dtype:
        raise TypeError('%s must be %s, got %s' % (name, dtype, t.dtype))
    if t.dim() != ndim:
        raise ValueError('%s must have %d dims, got shape %s'
                         % (name, ndim, tuple(t.shape)))
    if not t.is_contiguous():
        raise ValueError('%s must be contiguous' % name)


def _launch(name, fn, *args):
    rc = fn(*args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError('%s kernel launch failed: cudaError_t %d'
                           % (name, rc))
    if torch.cuda.is_current_stream_capturing():
        CAPTURED[name] += 1
    else:
        LAUNCHES[name] += 1


def _check_shape(t, name, dtype, shape):
    """Dtype, exact shape and contiguity of one kernel operand."""
    _check(t, name, dtype, len(shape))
    if tuple(t.shape) != tuple(shape):
        raise ValueError('%s must have shape %s, got %s'
                         % (name, tuple(shape), tuple(t.shape)))


# ---------------------------------------------------------------- K1 -----

def radius_member_plain(tpoints, tmask, cands, r2, chunk=16384):
    """Plain torch K1: int32 (M,), 1 where a valid point is within r2.

    Squared distances summed axis by axis from direct differences, in
    candidate chunks to bound the (N, chunk) temporaries.
    """
    r2 = torch.tensor(r2, dtype=torch.float32).item()
    valid = (tmask != 0)[:, None]
    out = []
    for c0 in range(0, cands.shape[0], chunk):
        c = cands[c0:c0 + chunk]
        d2 = torch.zeros((tpoints.shape[0], c.shape[0]),
                         dtype=torch.float32, device=c.device)
        for k in range(tpoints.shape[1]):
            diff = tpoints[:, k, None] - c[None, :, k]
            d2 = d2 + diff * diff
        out.append(((d2 <= r2) & valid).any(dim=0).to(torch.int32))
    if not out:
        return torch.zeros(0, dtype=torch.int32, device=cands.device)
    return torch.cat(out)


def member_group_size(m, npts, d):
    """Lanes that share one candidate in K1 and K1t: a power of two from
    1 to 32.

    Chosen so that *m* candidates put about 65536 threads on the card
    (16 lanes at m 4096, 2 at 32768, 1 from 65536 on), which timing on
    an H100 found fastest or within 3% of it; never more lanes than a
    quarter of the *npts* live rows. Above d 32, where the candidates
    are read from shared memory, half as many lanes, but enough to keep
    a block's staged candidates within their shared memory.
    Non-increasing in *m*.
    """
    g = 32
    while g > 1 and (g * m > _MEMBER_TARGET_THREADS or 4 * g > npts):
        g //= 2
    if d > 32:
        g = max(1, g // 2)
        while g < 32 and (_MEMBER_THREADS // g) * d * 4 > _MEMBER_CAND_BYTES:
            g *= 2
    return g


def _radius_member_cuda(tpoints, tmask, cands, r2, group):
    """Launch K1 on checked CUDA tensors with *group* lanes a candidate."""
    out = torch.empty(cands.shape[0], dtype=torch.int32, device=cands.device)
    _launch('radius_member', _lib().un_radius_member,
            tpoints.data_ptr(), tmask.data_ptr(), tpoints.shape[0],
            cands.data_ptr(), cands.shape[0], tpoints.shape[1],
            ctypes.c_float(r2), group, out.data_ptr())
    return out


def radius_member(tpoints, tmask, cands, r2):
    """K1: MLFriends radius membership of *cands*.

    Parameters
    ----------
    tpoints: (N, d) float32
        live points in whitened space (padded rows allowed)
    tmask: (N,) int32
        1 for valid rows of *tpoints*
    cands: (M, d) float32
        candidates in whitened space
    r2: float
        squared radius, compared in float32

    Returns
    -------
    (M,) int32, 1 where some valid live point lies within r2
    """
    if _on_cpu(tpoints, tmask, cands):
        PLAIN_CALLS['radius_member'] += 1
        return radius_member_plain(tpoints, tmask, cands, r2)
    _check(tpoints, 'tpoints', torch.float32, 2)
    _check(tmask, 'tmask', torch.int32, 1)
    _check(cands, 'cands', torch.float32, 2)
    n, d = tpoints.shape
    m = cands.shape[0]
    if cands.shape[1] != d or tmask.shape[0] != n:
        raise ValueError('shape mismatch: tpoints %s, tmask %s, cands %s'
                         % (tuple(tpoints.shape), tuple(tmask.shape),
                            tuple(cands.shape)))
    if not 1 <= d <= MAX_MEMBER_DIM:
        raise ValueError('radius_member takes 1 <= d <= %d, got %d'
                         % (MAX_MEMBER_DIM, d))
    return _radius_member_cuda(tpoints, tmask, cands, r2,
                               member_group_size(m, n, d))


# --------------------------------------------------------------- K1t -----

def radius_member_t_plain(tp_t, tm, cd_t, r2, chunk=16384):
    """Plain torch K1t: int32 (M,), 1 where a valid point is within r2.

    The arithmetic of :func:`radius_member_plain` on transposed operands:
    squared distances summed axis by axis from direct differences.
    """
    r2 = torch.tensor(r2, dtype=torch.float32).item()
    valid = (tm > 0)[:, None]
    out = []
    for c0 in range(0, cd_t.shape[1], chunk):
        c = cd_t[:, c0:c0 + chunk]
        d2 = torch.zeros((tp_t.shape[1], c.shape[1]), dtype=torch.float32,
                         device=c.device)
        for k in range(tp_t.shape[0]):
            diff = c[k, None, :] - tp_t[k, :, None]
            d2 = d2 + diff * diff
        out.append(((d2 <= r2) & valid).any(dim=0).to(torch.int32))
    if not out:
        return torch.zeros(0, dtype=torch.int32, device=cd_t.device)
    return torch.cat(out)


def _radius_member_t_cuda(tp_t, tm, cd_t, r2, group):
    """Launch K1t on checked CUDA tensors with *group* lanes a candidate."""
    out = torch.empty(cd_t.shape[1], dtype=torch.int32, device=cd_t.device)
    _launch('radius_member_t', _lib().un_radius_member_t,
            tp_t.data_ptr(), tm.data_ptr(), tp_t.shape[1], cd_t.data_ptr(),
            cd_t.shape[1], tp_t.shape[0], ctypes.c_float(r2), group,
            out.data_ptr())
    return out


def radius_member_t(tp_t, tm, cd_t, r2):
    """K1t: radius membership with axis-major (transposed) operands.

    Parameters
    ----------
    tp_t: (d, N) float32
        live points in whitened space, one row per axis
    tm: (N,) int32
        > 0 for valid columns of *tp_t*
    cd_t: (d, M) float32
        candidates in whitened space, one row per axis
    r2: float
        squared radius, compared in float32

    Returns
    -------
    (M,) int32, 1 where some valid live point lies within r2
    """
    if _on_cpu(tp_t, tm, cd_t):
        PLAIN_CALLS['radius_member_t'] += 1
        return radius_member_t_plain(tp_t, tm, cd_t, r2)
    _check(tp_t, 'tp_t', torch.float32, 2)
    _check(tm, 'tm', torch.int32, 1)
    _check(cd_t, 'cd_t', torch.float32, 2)
    d, n = tp_t.shape
    m = cd_t.shape[1]
    if cd_t.shape[0] != d or tm.shape[0] != n:
        raise ValueError('shape mismatch: tp_t %s, tm %s, cd_t %s'
                         % (tuple(tp_t.shape), tuple(tm.shape),
                            tuple(cd_t.shape)))
    if not 1 <= d <= MAX_MEMBER_DIM:
        raise ValueError('radius_member_t takes 1 <= d <= %d, got %d'
                         % (MAX_MEMBER_DIM, d))
    return _radius_member_t_cuda(tp_t, tm, cd_t, r2,
                                 member_group_size(m, n, d))


# ---------------------------------------------------------------- K2 -----

def bootstrap_radius_plain(tpoints, valid, masks):
    """Plain torch K2: 0-d float32 tensor, the bootstrapped radius.

    max over rounds of (max over valid unselected columns of the min
    over selected rows of the squared distance), starting from 0.0.
    """
    n = tpoints.shape[0]
    d2 = torch.zeros((n, n), dtype=torch.float32, device=tpoints.device)
    for k in range(tpoints.shape[1]):
        diff = tpoints[:, k, None] - tpoints[None, :, k]
        d2 = d2 + diff * diff
    big = torch.tensor(1e30, dtype=torch.float32, device=tpoints.device)
    best = torch.zeros((), dtype=torch.float32, device=tpoints.device)
    valid = valid != 0
    for b in range(masks.shape[0]):
        sel = masks[b] != 0
        mind = torch.where(sel[:, None], d2, big).amin(dim=0)
        outside = valid & ~sel
        best = torch.maximum(best, torch.where(outside, mind, -big).max())
    return best


def bootstrap_radius(tpoints, valid, masks):
    """K2: bootstrapped MLFriends squared radius.

    Parameters
    ----------
    tpoints: (Npad, d) float32
        whitened live points, padded
    valid: (Npad,) uint8
        1 for real rows
    masks: (B, Npad) uint8
        1 where a round selected the row (0 on padding)

    Returns
    -------
    0-d float32 tensor on the input device

    On the card this is two kernels on the current stream (the rounds
    packed into bits, then the radius; ``csrc/bootstrap_radius.cu`` says
    how). One call counts one launch.
    """
    if _on_cpu(tpoints, valid, masks):
        PLAIN_CALLS['bootstrap_radius'] += 1
        return bootstrap_radius_plain(tpoints, valid, masks)
    _check(tpoints, 'tpoints', torch.float32, 2)
    _check(valid, 'valid', torch.uint8, 1)
    _check(masks, 'masks', torch.uint8, 2)
    npad, d = tpoints.shape
    if valid.shape[0] != npad or masks.shape[1] != npad:
        raise ValueError('shape mismatch: tpoints %s, valid %s, masks %s'
                         % (tuple(tpoints.shape), tuple(valid.shape),
                            tuple(masks.shape)))
    nrounds = masks.shape[0]
    out = torch.empty((), dtype=torch.float32, device=tpoints.device)
    # the rounds as bits: one 32-bit word per row and 32 rounds, written
    # by the first of the call's two kernels
    selbits = torch.empty(-(-nrounds // 32) * npad, dtype=torch.int32,
                          device=tpoints.device)
    _launch('bootstrap_radius', _lib().un_bootstrap_radius,
            tpoints.data_ptr(), valid.data_ptr(), masks.data_ptr(), npad,
            nrounds, d, selbits.data_ptr(), out.data_ptr())
    return out


# ---------------------------------------------------------------- K3 -----

def _scan_records(lL, L, accept):
    """Records of rows *L* (any shape) against the fixed live set *lL*."""
    worst = torch.argmin(lL)
    Lmin = lL[worst]
    rank = (lL < L[..., None]).sum(dim=-1)
    plateau = (lL == Lmin).sum() > 1
    dup = (lL == L[..., None]).any(dim=-1)
    return torch.stack(torch.broadcast_tensors(
        accept.float(), worst.float(), Lmin, rank.float(),
        plateau.float() * 2 + dup.float()), dim=-1)


def consume_scan_plain(live_L, rows_L, rows_valid):
    """Plain torch K3: (live_L2, recs (P, 5) float32).

    Rows run one by one up to the last valid row; the rows after it
    cannot change the live set, so their records come in one batch
    against the final state (as in the kernel). Finding that row reads
    one value back to the host.
    """
    lL = live_L.clone()
    idx = torch.arange(lL.shape[0], device=lL.device)
    valid = rows_valid > 0.5
    rownum = torch.arange(1, valid.shape[0] + 1, device=valid.device)
    nseq = int(torch.where(valid, rownum, 0).max()) if len(valid) else 0
    recs = []
    for p in range(nseq):
        L = rows_L[p]
        rec = _scan_records(lL, L, valid[p] & (L > lL.min()))
        accept, worst = rec[0] > 0.5, rec[1].long()
        lL = torch.where(accept & (idx == worst), L, lL)
        recs.append(rec[None])
    tail = rows_L[nseq:]
    recs.append(_scan_records(lL, tail, torch.zeros_like(tail,
                                                         dtype=torch.bool)))
    return lL, torch.cat(recs)


def consume_scan(live_L, rows_L, rows_valid):
    """K3: consume candidate rows into the live likelihoods.

    Parameters
    ----------
    live_L: (npad,) float32
        live log-likelihoods, padded with +inf
    rows_L: (P,) float32
        candidate log-likelihoods, in order
    rows_valid: (P,) float32
        1.0 where the row may be accepted

    Returns
    -------
    live_L2: (npad,) float32
        the live likelihoods after all rows
    recs: (P, 5) float32
        [accept, worst slot, Lmin, rank, 2*plateau + dup] per row

    *live_L* must hold no NaN. On the card this is two kernels on the
    current stream: the chain (the live set in one warp's registers for
    npad <= 1024, in one CTA's shared memory above it) writes accept,
    worst slot and Lmin, then the counts write rank and the flags
    (``csrc/consume_scan.cu`` says how). One call counts one launch.
    """
    if _on_cpu(live_L, rows_L, rows_valid):
        PLAIN_CALLS['consume_scan'] += 1
        return consume_scan_plain(live_L, rows_L, rows_valid)
    for t, name in ((live_L, 'live_L'), (rows_L, 'rows_L'),
                    (rows_valid, 'rows_valid')):
        _check(t, name, torch.float32, 1)
    npad, P = live_L.shape[0], rows_L.shape[0]
    if rows_valid.shape[0] != P:
        raise ValueError('rows_L and rows_valid differ in length')
    if not 0 < npad <= MAX_SCAN_NPAD:
        raise ValueError('consume_scan takes 1 <= npad <= %d, got %d'
                         % (MAX_SCAN_NPAD, npad))
    live_L2 = torch.empty_like(live_L)
    recs = torch.empty((P, 5), dtype=torch.float32, device=live_L.device)
    _launch('consume_scan', _lib().un_consume_scan,
            live_L.data_ptr(), npad, rows_L.data_ptr(),
            rows_valid.data_ptr(), P, live_L2.data_ptr(), recs.data_ptr())
    return live_L2, recs


# ------------------------------------------------------------ K4, K5 -----

# the state of the spec walk that K5 updates in place, one row a walker
# (u, v: (P, d); L, tl, tr, wbuf: (P,) float32; step (P,) int64; done
# (P,) bool) and the counters (0-d int64: billed rows, useful rows,
# accepted steps, the round)
SPEC_STATE = ('u', 'L', 'v', 'tl', 'tr', 'step', 'done', 'wbuf', 'ncr',
              'nur', 'nw', 'it')


def cube_intersection(u, v):
    """Line coordinates where rays u + t*v cross the unit cube faces.

    Where ``v == 0`` the divisions give inf or nan; both are masked to
    -inf / +inf before the reductions, so none reaches ``max``/``min``.
    """
    nz = v != 0
    a = torch.where(nz, (0.0 - u) / v, -math.inf)
    b = torch.where(nz, (1.0 - u) / v, math.inf)
    return torch.minimum(a, b).amax(dim=1), torch.maximum(a, b).amin(dim=1)


def spec_propose_plain(u, v, tl, tr, xibank, it):
    """Plain torch K4: ``(ts (P, D), tlc (P,), trc (P,), up (P*D, d))``.

    Candidate j of each walker's shrink chain is drawn from the round's
    row ``xibank[it]`` as if all earlier ones were rejected; ``tlc``,
    ``trc`` are the bracket shrunk by all D; ``up`` the candidates'
    rows ``u + ts * v``.
    """
    xi = xibank.index_select(0, it.reshape(1))[0]        # (P, D)
    P, D = xi.shape
    tlc, trc = tl, tr
    ts = []
    for j in range(D):
        t = tlc + xi[:, j] * (trc - tlc)
        ts.append(t)
        tlc = torch.where(t < 0, t, tlc)
        trc = torch.where(t >= 0, t, trc)
    ts = torch.stack(ts, dim=1)
    up = u[:, None, :] + ts[..., None] * v[:, None, :]
    return ts, tlc, trc, up.reshape(P * D, -1)


def spec_propose(u, v, tl, tr, xibank, it):
    """K4: propose one round of the spec walk (:func:`spec_propose_plain`).

    Parameters
    ----------
    u, v: (P, d) float32
        walkers' points and directions
    tl, tr: (P,) float32
        their brackets on the line ``u + t v``
    xibank: (max_rounds, P, D) float32
        uniforms of every round; the kernel reads row *it*
    it: 0-d int64
        the round counter, on the device

    Returns ``ts (P, D), tlc (P,), trc (P,), up (P*D, d)``, float32.
    """
    if _on_cpu(u, v, tl, tr, xibank, it):
        PLAIN_CALLS['spec_propose'] += 1
        return spec_propose_plain(u, v, tl, tr, xibank, it)
    P, d = u.shape
    R, _, D = xibank.shape
    _check_shape(u, 'u', torch.float32, (P, d))
    _check_shape(v, 'v', torch.float32, (P, d))
    for t, name in ((tl, 'tl'), (tr, 'tr')):
        _check_shape(t, name, torch.float32, (P,))
    _check_shape(xibank, 'xibank', torch.float32, (R, P, D))
    _check_shape(it, 'it', torch.int64, ())
    if R < 1 or D < 1 or d < 1:
        raise ValueError('spec_propose needs a round, a candidate and a '
                         'coordinate, got xibank %s and u %s'
                         % (tuple(xibank.shape), tuple(u.shape)))
    if P * D * d >= 2**31:
        raise ValueError('spec_propose takes fewer than 2**31 row values, '
                         'got P %d, D %d, d %d' % (P, D, d))
    ts = torch.empty((P, D), dtype=torch.float32, device=u.device)
    tlc = torch.empty(P, dtype=torch.float32, device=u.device)
    trc = torch.empty(P, dtype=torch.float32, device=u.device)
    up = torch.empty((P * D, d), dtype=torch.float32, device=u.device)
    _launch('spec_propose', _lib().un_spec_propose, u.data_ptr(),
            v.data_ptr(), tl.data_ptr(), tr.data_ptr(), xibank.data_ptr(),
            it.data_ptr(), R, P, D, d, propose_vector_width(d, u, v, up),
            ts.data_ptr(), tlc.data_ptr(), trc.data_ptr(), up.data_ptr())
    return ts, tlc, trc, up


def propose_vector_width(d, *tensors):
    """Floats a K4 thread reads or writes in one access: 4 or 2 where *d* is
    a multiple of it and every tensor's data is aligned to its bytes
    (16 or 8), else 1."""
    for vec in (4, 2):
        if d % vec == 0 and all(t.data_ptr() % (4 * vec) == 0
                                for t in tensors):
            return vec
    return 1


def spec_update_plain(Lp, tin, ts, tlc, trc, Lmin, dirbank, state):
    """Plain torch K5: update the walk *state* in place after the round's
    likelihoods *Lp* (:data:`SPEC_STATE`; ``csrc/spec_update.cu`` states
    the update). Returns None."""
    st = state
    u, L, v, tl, tr, step, done = (st[k] for k in SPEC_STATE[:7])
    P, D = ts.shape
    nsteps = dirbank.shape[0]
    arD = torch.arange(D, device=ts.device)
    arP = torch.arange(P, device=ts.device)
    Lp = Lp.reshape(P, D)
    active = ~done
    # billing: the walkers still working this round, rows the p-space
    # filter let through
    billed = active[:, None].expand(P, D) if tin is None \
        else tin.reshape(P, D) & active[:, None]
    st['ncr'].add_(billed.sum())
    hit = Lp > Lmin
    anyhit0 = hit.any(dim=1)
    anyhit = anyhit0 & active
    # first hit in chain order (D where there is none, then clamped;
    # rows without a hit do not use it)
    jstar = torch.where(hit, arD, D).amin(dim=1).clamp(max=D - 1)
    # useful work: a sequential sampler evaluates candidates 0..jstar,
    # or all D on a round without a hit
    kneed = torch.where(anyhit0, jstar + 1, D)
    st['nur'].add_(((arD[None, :] < kneed[:, None]) & billed).sum())
    tstar = ts.gather(1, jstar[:, None])[:, 0]
    Lstar = Lp.gather(1, jstar[:, None])[:, 0]
    u_new = torch.where(anyhit[:, None], u + tstar[:, None] * v, u)
    step_new = step + anyhit
    st['wbuf'].copy_(torch.where(anyhit, tr - tl, 0.0))
    st['nw'].add_(anyhit.sum())
    done_new = done | (anyhit & (step_new >= nsteps))
    # no acceptance: keep the fully shrunk bracket
    rej = ~anyhit & ~done_new
    tl_new = torch.where(rej, tlc, tl)
    tr_new = torch.where(rej, trc, tr)
    # accepted and not done: the next pre-drawn direction and a fresh
    # full chord
    renew = anyhit & ~done_new
    vn = dirbank[step_new.clamp(0, nsteps - 1), arP]
    v_new = torch.where(renew[:, None], vn, v)
    tln, trn = cube_intersection(u_new, v_new)
    L.copy_(torch.where(anyhit, Lstar, L))
    u.copy_(u_new)
    v.copy_(v_new)
    tl.copy_(torch.where(renew, tln, tl_new))
    tr.copy_(torch.where(renew, trn, tr_new))
    step.copy_(step_new)
    done.copy_(done_new)
    st['it'].add_(1)


def spec_update(Lp, tin, ts, tlc, trc, Lmin, dirbank, state):
    """K5: update the spec walk's *state* in place after one round.

    Parameters
    ----------
    Lp: (P*D,) float32
        likelihoods of the rows :func:`spec_propose` gave
    tin: (P*D,) bool or None
        rows the p-space filter let through (None: every row billed)
    ts, tlc, trc: the chain and the shrunk bracket from :func:`spec_propose`
    Lmin: 0-d float32
        the likelihood threshold
    dirbank: (nsteps, P, d) float32
        each walker's direction of each step
    state: dict
        :data:`SPEC_STATE`'s tensors, updated in place; ``wbuf`` receives
        each walker's accepted bracket width (0 where none), for the
        caller's float sum

    On the card one launch; the int64 counters are summed in it.
    """
    st = state
    if _on_cpu(Lp, ts, tlc, trc, Lmin, dirbank, *(st[k] for k in SPEC_STATE)):
        PLAIN_CALLS['spec_update'] += 1
        return spec_update_plain(Lp, tin, ts, tlc, trc, Lmin, dirbank, st)
    P, D = ts.shape
    nsteps, _, d = dirbank.shape
    _check_shape(Lp, 'Lp', torch.float32, (P * D,))
    if tin is not None:
        _on_cpu(Lp, tin)
        _check_shape(tin, 'tin', torch.bool, (P * D,))
    _check_shape(ts, 'ts', torch.float32, (P, D))
    _check_shape(Lmin, 'Lmin', torch.float32, ())
    _check_shape(dirbank, 'dirbank', torch.float32, (nsteps, P, d))
    if nsteps < 1:
        raise ValueError('dirbank needs a step')
    want = dict(u=(torch.float32, (P, d)), v=(torch.float32, (P, d)),
                L=(torch.float32, (P,)), tl=(torch.float32, (P,)),
                tr=(torch.float32, (P,)), wbuf=(torch.float32, (P,)),
                step=(torch.int64, (P,)), done=(torch.bool, (P,)))
    for name in SPEC_STATE:
        dtype, shape = want.get(name, (torch.int64, ()))
        _check_shape(st[name], name, dtype, shape)
    for t, name in ((tlc, 'tlc'), (trc, 'trc')):
        _check_shape(t, name, torch.float32, (P,))
    _launch('spec_update', _lib().un_spec_update, Lp.data_ptr(),
            None if tin is None else tin.data_ptr(), ts.data_ptr(),
            tlc.data_ptr(), trc.data_ptr(), Lmin.data_ptr(),
            dirbank.data_ptr(), nsteps, P, D, d,
            *(st[k].data_ptr() for k in SPEC_STATE))


# ---------------------------------------------------------------- K6 -----

# the state of the sync walk that K6 updates in place: each walker's step
# start u and direction v (P, d), its bracket tl, tr (P,) float32, its
# point un (P, d) and likelihood Ln (P,) float32 so far, done (P,) bool;
# the counters (0-d int64: billed rows, the step, the iteration in it,
# the bank row K4 reads), the flag "every step ran" (0-d bool), each
# step's accepting fraction and median final bracket (nsteps,) float32,
# and tick (2,) int64, the kernel's own counters between its blocks, 0
# between calls (the plain version leaves it alone)
SYNC_STATE = ('u', 'v', 'tl', 'tr', 'un', 'Ln', 'done', 'nc', 's', 'it',
              'row', 'flag', 'accs', 'widths', 'tick')
# K6's forms (un_sync_update's form bits): one block or a grid whose
# last block ends the round; the median by rank counting or by radix
# selection (rank counting takes P <= SYNC_RANK_KEYS)
SYNC_FORM_GRID = 1
SYNC_FORM_RADIX = 2
SYNC_RANK_KEYS = 1024


def _median(x):
    """``jnp.median`` of a 1-d tensor: the midpoint of the middle pair of
    its sorted values (NaN last)."""
    s = torch.sort(x).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def sync_update_plain(Lp, tin, ts, tlc, trc, Lmin, dirbank, max_it, state):
    """Plain torch K6: one shrink iteration's update of the sync walk's
    *state* (:data:`SYNC_STATE`) after its likelihoods *Lp*, and the step
    boundary where the step ends (``csrc/sync_update.cu`` states both).
    Reads the step and iteration to the host. Returns None."""
    st = state
    nsteps, P, _ = dirbank.shape
    s = int(st['s'])
    if s >= nsteps:
        return
    done = st['done']
    acc = (Lp > Lmin) & ~done
    up = st['u'] + ts.reshape(P)[:, None] * st['v']
    st['un'].copy_(torch.where(acc[:, None], up, st['un']))
    st['Ln'].copy_(torch.where(acc, Lp, st['Ln']))
    done |= acc
    rej = ~done
    st['tl'].copy_(torch.where(rej, tlc, st['tl']))
    st['tr'].copy_(torch.where(rej, trc, st['tr']))
    st['nc'].add_(P if tin is None else tin.sum())
    it = int(st['it']) + 1
    if it < max_it and not bool(done.all()):
        st['it'].fill_(it)
        st['row'].fill_(s * max_it + it)
        return
    # a true division on either device: torch multiplies a CUDA tensor by
    # the reciprocal of a Python number it is divided by
    st['accs'][s] = done.sum().to(torch.float32) / torch.full(
        (), P, dtype=torch.float32, device=done.device)
    st['widths'][s] = _median(st['tr'] - st['tl'])
    s += 1
    if s < nsteps:
        st['u'].copy_(st['un'])
        st['v'].copy_(dirbank[s])
        tl, tr = cube_intersection(st['u'], st['v'])
        st['tl'].copy_(tl)
        st['tr'].copy_(tr)
        done.zero_()
    st['s'].fill_(s)
    st['it'].zero_()
    st['row'].fill_(s * max_it if s < nsteps else nsteps * max_it - 1)
    st['flag'].fill_(s >= nsteps)


def _sync_update_cuda(Lp, tin, ts, tlc, trc, Lmin, dirbank, max_it, state,
                      form):
    """K6 on the card in *form* (-1: chosen from P and d in C; else
    :data:`SYNC_FORM_GRID` | :data:`SYNC_FORM_RADIX` bits)."""
    st = state
    nsteps, P, d = dirbank.shape
    if min(nsteps, P, d, max_it) < 1 or P >= 2**24 or P * d >= 2**31:
        raise ValueError('sync_update needs 1 <= P < 2**24 walkers, a step, '
                         'a coordinate, an iteration and P * d < 2**31, got '
                         'dirbank %s, max_it %d'
                         % (tuple(dirbank.shape), max_it))
    if form >= 0 and not form & SYNC_FORM_RADIX and P > SYNC_RANK_KEYS:
        raise ValueError('rank counting takes at most %d walkers, got %d'
                         % (SYNC_RANK_KEYS, P))
    _check_shape(Lp, 'Lp', torch.float32, (P,))
    if tin is not None:
        _on_cpu(Lp, tin)
        _check_shape(tin, 'tin', torch.bool, (P,))
    _check_shape(ts, 'ts', torch.float32, (P, 1))
    for t, name in ((tlc, 'tlc'), (trc, 'trc')):
        _check_shape(t, name, torch.float32, (P,))
    _check_shape(Lmin, 'Lmin', torch.float32, ())
    _check_shape(dirbank, 'dirbank', torch.float32, (nsteps, P, d))
    want = dict(u=(torch.float32, (P, d)), v=(torch.float32, (P, d)),
                un=(torch.float32, (P, d)), tl=(torch.float32, (P,)),
                tr=(torch.float32, (P,)), Ln=(torch.float32, (P,)),
                done=(torch.bool, (P,)), flag=(torch.bool, ()),
                accs=(torch.float32, (nsteps,)),
                widths=(torch.float32, (nsteps,)),
                tick=(torch.int64, (2,)))
    for name in SYNC_STATE:
        dtype, shape = want.get(name, (torch.int64, ()))
        _check_shape(st[name], name, dtype, shape)
    _launch('sync_update', _lib().un_sync_update, Lp.data_ptr(),
            None if tin is None else tin.data_ptr(), ts.data_ptr(),
            tlc.data_ptr(), trc.data_ptr(), Lmin.data_ptr(),
            dirbank.data_ptr(), nsteps, max_it, P, d, form,
            *(st[k].data_ptr() for k in SYNC_STATE))


def sync_update(Lp, tin, ts, tlc, trc, Lmin, dirbank, max_it, state):
    """K6: update the sync walk's *state* in place after one shrink
    iteration of every walker, and end the step where every walker is
    done or *max_it* iterations ran (:func:`sync_update_plain`).

    Parameters
    ----------
    Lp: (P,) float32
        likelihoods of the rows :func:`spec_propose` gave at D = 1
    tin: (P,) bool or None
        rows the p-space filter let through (None: every row billed)
    ts, tlc, trc: (P, 1), (P,), (P,) float32
        K4's slice position and shrunk bracket
    Lmin: 0-d float32
        the likelihood threshold
    dirbank: (nsteps, P, d) float32
        each walker's direction of each step
    max_it: int
        shrink iterations a step may run
    state: dict
        :data:`SYNC_STATE`'s tensors, updated in place; once every step
        ran, a call changes nothing

    On the card one kernel launch: one block, or a grid whose last block
    counts the round and ends the step (``csrc/sync_update.cu``).
    """
    st = state
    if _on_cpu(Lp, ts, tlc, trc, Lmin, dirbank,
               *(st[k] for k in SYNC_STATE)):
        PLAIN_CALLS['sync_update'] += 1
        return sync_update_plain(Lp, tin, ts, tlc, trc, Lmin, dirbank,
                                 max_it, st)
    _sync_update_cuda(Lp, tin, ts, tlc, trc, Lmin, dirbank, max_it, st, -1)


# ---------------------------------------------------------------- K7 -----

# the state of the random walk that K7 updates in place: each walker's
# point u (P, d) and likelihood L (P,) float32; the accepted and billed
# counts (0-d int64)
RWALK_STATE = ('u', 'L', 'nacc', 'nc')


def rwalk_accept_plain(Lev, tin, up, Lmin, state, m=None, scale=None):
    """Plain torch K7: accept each walker's proposal *up* that lies inside
    the unit cube above *Lmin* (nothing where *Lev* is None: K7's
    prologue), then, given the next step's products *m*, write the next
    proposal ``u + scale * m`` into *up*, a multiply and an add as torch
    rounds them (``csrc/rwalk_accept.cu`` states the step). Returns
    None."""
    st = state
    if Lev is not None:
        inside = ((up > 0) & (up < 1)).all(dim=1)
        Lp = torch.where(inside, Lev, -math.inf)
        acc = inside & (Lp > Lmin)
        st['u'].copy_(torch.where(acc[:, None], up, st['u']))
        st['L'].copy_(torch.where(acc, Lp, st['L']))
        st['nacc'].add_(acc.sum())
        st['nc'].add_((inside if tin is None else inside & tin).sum())
    if m is not None:
        up.copy_(st['u'] + scale * m)


def rwalk_accept(Lev, tin, up, Lmin, state, m=None, scale=None):
    """K7: one random-walk step's acceptance, in place, and the next
    step's proposal (:func:`rwalk_accept_plain`).

    Parameters
    ----------
    Lev: (P,) float32 or None
        likelihoods of the proposed rows; None for K7's prologue, which
        accepts nothing and writes step 0's proposal (*tin* and *Lmin*
        unused, the state left alone)
    tin: (P,) bool or None
        rows the p-space filter let through (None: every inside row
        billed)
    up: (P, d) float32
        the proposed rows; given *m*, overwritten with the next step's
    Lmin: 0-d float32
        the likelihood threshold
    state: dict
        :data:`RWALK_STATE`'s tensors, updated in place
    m: (P, d) float32 or None
        the next step's products ``eps @ axes.T`` (None: the last step,
        no proposal written)
    scale: 0-d float32
        the proposal's scale, where *m* is given

    On the card one launch; the int64 counts are summed in it.
    """
    st = state
    given = [t for t in (Lev, Lmin) if t is not None]
    if _on_cpu(*given, up, *(st[k] for k in RWALK_STATE)):
        PLAIN_CALLS['rwalk_accept'] += 1
        return rwalk_accept_plain(Lev, tin, up, Lmin, st, m, scale)
    P, d = up.shape
    if d < 1 or P * d >= 2**31:
        raise ValueError('rwalk_accept takes 1 <= d and fewer than 2**31 '
                         'row values, got up %s' % (tuple(up.shape),))
    _check_shape(up, 'up', torch.float32, (P, d))
    if Lev is not None:
        _check_shape(Lev, 'Lev', torch.float32, (P,))
        _check_shape(Lmin, 'Lmin', torch.float32, ())
        if tin is not None:
            _on_cpu(Lev, tin)
            _check_shape(tin, 'tin', torch.bool, (P,))
    if m is not None:
        _on_cpu(up, m, scale)
        _check_shape(m, 'm', torch.float32, (P, d))
        _check_shape(scale, 'scale', torch.float32, ())
    _check_shape(st['u'], 'u', torch.float32, (P, d))
    _check_shape(st['L'], 'L', torch.float32, (P,))
    for k in ('nacc', 'nc'):
        _check_shape(st[k], k, torch.int64, ())

    def ptr(t):
        return None if t is None else t.data_ptr()
    _launch('rwalk_accept', _lib().un_rwalk_accept, ptr(Lev), ptr(tin),
            up.data_ptr(), ptr(Lmin), ptr(m), ptr(scale), P, d,
            *(st[k].data_ptr() for k in RWALK_STATE))


# ---------------------------------------------------------------- K8 -----

def radius_graph_fits(n, d):
    """Whether K8 takes a live set of *n* points of dimension *d*."""
    return n >= 1 and 1 <= d <= MAX_GRAPH_DIM and n * d <= MAX_GRAPH_ELEMS


def radius_graph_parts(out, n):
    """``(labels (n,), centred (n, d) float32 or None)``: views of K8's
    packed result *out*, a torch tensor or its numpy copy alike."""
    labels, rest = out[:n], out[n:]
    if len(rest) == 0:
        return labels, None
    f32 = torch.float32 if torch.is_tensor(rest) else 'float32'
    return labels, rest.view(f32).reshape(n, -1)


def radius_graph_plain(tpoints, upoints, r2):
    """Plain torch K8: int32 ``(n + n d,)``, or ``(n,)`` without
    *upoints* (:func:`radius_graph_parts` splits it).

    The labels: each point's smallest component member in the graph of
    the *tpoints* whose squared distance (summed axis by axis from direct
    differences) is <= r2 in float32, found by label propagation with
    pointer jumping. The centred points: each of *upoints* minus the
    mean of the *upoints* within r2 of it, itself included, with counts
    at least 1.
    """
    r2 = torch.tensor(r2, dtype=torch.float32).item()
    n = tpoints.shape[0]

    def within(pts):
        d2 = torch.zeros((n, n), dtype=torch.float32, device=pts.device)
        for k in range(pts.shape[1]):
            diff = pts[:, k, None] - pts[None, :, k]
            d2 = d2 + diff * diff
        return d2 <= r2

    adj = within(tpoints) | torch.eye(n, dtype=torch.bool,
                                      device=tpoints.device)
    labels = torch.arange(n, device=tpoints.device)
    while True:
        new = torch.where(adj, labels[None, :], n).amin(dim=1)
        new = torch.minimum(new, labels[new])
        if torch.equal(new, labels):
            break
        labels = new
    labels = labels.to(torch.int32)
    if upoints is None:
        return labels
    near = within(upoints).float()
    counts = near.sum(dim=1).clamp(min=1)
    centred = upoints - (near @ upoints) / counts[:, None]
    return torch.cat([labels, centred.reshape(-1).view(torch.int32)])


def radius_graph(tpoints, upoints, r2):
    """K8: the transform layer's radius graphs (:func:`radius_graph_plain`).

    Parameters
    ----------
    tpoints: (N, d) float32
        live points in whitened space: the cluster graph
    upoints: (N, d) float32 or None
        the same points in the (wrapped) unit cube, to be centred on
        their neighbourhood's mean; None for the labels alone
    r2: float
        squared radius, compared in float32

    Returns
    -------
    int32 ``(N + N d,)`` (``(N,)`` without *upoints*): the labels, the
    smallest member index of each point's component, then the centred
    points' float32 bits, row by row (:func:`radius_graph_parts`)

    On the card two kernels on the current stream (parent array, then the
    graphs; ``csrc/radius_graph.cu`` says how), for
    :func:`radius_graph_fits` sizes only. One call counts one launch.
    """
    if _on_cpu(tpoints, *([] if upoints is None else [upoints])):
        PLAIN_CALLS['radius_graph'] += 1
        return radius_graph_plain(tpoints, upoints, r2)
    _check(tpoints, 'tpoints', torch.float32, 2)
    n, d = tpoints.shape
    if upoints is not None:
        _check_shape(upoints, 'upoints', torch.float32, (n, d))
    if not radius_graph_fits(n, d):
        raise ValueError('radius_graph takes 1 <= n, 1 <= d <= %d and '
                         'n d <= %d, got n %d, d %d'
                         % (MAX_GRAPH_DIM, MAX_GRAPH_ELEMS, n, d))
    out = torch.empty(n if upoints is None else n * (1 + d),
                      dtype=torch.int32, device=tpoints.device)
    # the parent array and the blocks' tick, set by the first kernel
    scratch = torch.empty(n + 1, dtype=torch.int32, device=tpoints.device)
    _launch('radius_graph', _lib().un_radius_graph, tpoints.data_ptr(),
            None if upoints is None else upoints.data_ptr(), n, d,
            ctypes.c_float(r2), scratch.data_ptr(), out.data_ptr())
    return out
