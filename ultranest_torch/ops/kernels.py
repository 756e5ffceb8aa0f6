# noqa: D400 D205
"""
Hand-written CUDA kernels of the region-rejection path
------------------------------------------------------

Four kernels, sources in ``ultranest_torch/csrc/``:

* K1 :func:`radius_member` (``csrc/radius_member.cu``) replaces the
  Pallas ``_member_kernel`` (``ultranest_tpu/ops/pallas_kernels.py``);
* K1t :func:`radius_member_t` (``csrc/radius_member_t.cu``) replaces the
  Pallas ``_member_kernel_t`` of the membership shootout
  (``evaluate/bench_pallas_membership.py``), K1 on transposed operands;
* K2 :func:`bootstrap_radius` (``csrc/bootstrap_radius.cu``) replaces
  the Pallas ``_bootstrap_kernel`` (same file);
* K3 :func:`consume_scan` (``csrc/consume_scan.cu``) replaces the XLA
  scan of ``ultranest_tpu/segmentops.py:78-134``.

Each source file says what bounds its kernel on an H100 and what its
design does about it. K1, K1t and K2 share ``csrc/member_core.cuh``: the
point in registers, the separately rounded distance, the compacted
axis-major tile of live points and the group vote. K1 and K1t are one
kernel body, ``csrc/member_kernel.cuh``, instantiated per layout.

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
served on the CPU.
"""

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

from ..native import build_dir

__all__ = ['radius_member', 'radius_member_t', 'bootstrap_radius',
           'consume_scan', 'radius_member_plain', 'radius_member_t_plain',
           'bootstrap_radius_plain', 'consume_scan_plain', 'build',
           'LAUNCHES', 'PLAIN_CALLS', 'reset_counts', 'KERNELS',
           'REGION_KERNELS', 'member_group_size', 'build_dir']

KERNELS = ('radius_member', 'radius_member_t', 'bootstrap_radius',
           'consume_scan')
# the kernels the region-rejection path launches (K1t runs only in the
# membership shootout, ultranest_torch.evaluate.bench_membership)
REGION_KERNELS = ('radius_member', 'bootstrap_radius', 'consume_scan')
SOURCES = ('radius_member.cu', 'radius_member_t.cu', 'bootstrap_radius.cu',
           'consume_scan.cu')
# headers the sources include: hashed with them, so that an edit rebuilds
HEADERS = ('member_core.cuh', 'member_kernel.cuh')
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
    """Compile the CUDA sources (once per source hash); returns the path."""
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
            for fn in (lib.un_radius_member, lib.un_radius_member_t,
                       lib.un_bootstrap_radius, lib.un_consume_scan):
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
    LAUNCHES[name] += 1


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
