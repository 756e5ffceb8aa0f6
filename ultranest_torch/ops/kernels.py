# noqa: D400 D205
"""
Hand-written CUDA kernels of the region-rejection path
------------------------------------------------------

Three kernels, sources in ``ultranest_torch/csrc/``:

* K1 :func:`radius_member` (``csrc/radius_member.cu``) replaces the
  Pallas ``_member_kernel`` (``ultranest_tpu/ops/pallas_kernels.py``);
* K2 :func:`bootstrap_radius` (``csrc/bootstrap_radius.cu``) replaces
  the Pallas ``_bootstrap_kernel`` (same file);
* K3 :func:`consume_scan` (``csrc/consume_scan.cu``) replaces the XLA
  scan of ``ultranest_tpu/segmentops.py:78-134``.

Each source file says what bounds its kernel on an H100 and what its
design does about it.

Build: on first use, ``nvcc -gencode arch=compute_90a,code=sm_90a``
compiles all sources into one shared library with a plain C interface,
under ``ultranest_torch/_build/``, named by a hash of the sources and
flags. It is loaded with ctypes: pointers and the stream go as
``c_void_p``.

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

__all__ = ['radius_member', 'bootstrap_radius', 'consume_scan',
           'radius_member_plain', 'bootstrap_radius_plain',
           'consume_scan_plain', 'build', 'LAUNCHES', 'PLAIN_CALLS',
           'reset_counts', 'KERNELS']

KERNELS = ('radius_member', 'bootstrap_radius', 'consume_scan')
SOURCES = ('radius_member.cu', 'bootstrap_radius.cu', 'consume_scan.cu')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']
# largest live set K3 keeps in shared memory (128 KB of the 227 KB)
MAX_SCAN_NPAD = 32768

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, 'csrc')
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
    for s in srcs:
        with open(s, 'rb') as f:
            h.update(f.read())
    so = os.path.join(BUILD_DIR, 'libultranest_kernels-%s.so'
                      % h.hexdigest()[:16])
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc()] + NVCC_FLAGS + ['-o', tmp] + srcs,
                              capture_output=True, text=True, timeout=600)
        BUILD_LOG = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError('nvcc failed:\n' + BUILD_LOG)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.un_radius_member.argtypes = [vp, vp, ci, vp, ci, ci, cf, vp,
                                             vp]
            lib.un_bootstrap_radius.argtypes = [vp, vp, vp, ci, ci, ci, vp,
                                                vp]
            lib.un_consume_scan.argtypes = [vp, ci, vp, vp, ci, vp, vp, vp]
            for fn in (lib.un_radius_member, lib.un_bootstrap_radius,
                       lib.un_consume_scan):
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
    out = torch.empty(m, dtype=torch.int32, device=cands.device)
    _launch('radius_member', _lib().un_radius_member,
            tpoints.data_ptr(), tmask.data_ptr(), n, cands.data_ptr(), m, d,
            ctypes.c_float(r2), out.data_ptr())
    return out


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
        mind = torch.where(sel[:, None], d2, big).min(dim=0).values
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
    out = torch.empty((), dtype=torch.float32, device=tpoints.device)
    _launch('bootstrap_radius', _lib().un_bootstrap_radius,
            tpoints.data_ptr(), valid.data_ptr(), masks.data_ptr(), npad,
            masks.shape[0], d, out.data_ptr())
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
    if npad > MAX_SCAN_NPAD:
        raise ValueError('consume_scan keeps the live set in shared memory: '
                         'npad %d > %d' % (npad, MAX_SCAN_NPAD))
    live_L2 = torch.empty_like(live_L)
    recs = torch.empty((P, 5), dtype=torch.float32, device=live_L.device)
    _launch('consume_scan', _lib().un_consume_scan,
            live_L.data_ptr(), npad, rows_L.data_ptr(),
            rows_valid.data_ptr(), P, live_L2.data_ptr(), recs.data_ptr())
    return live_L2, recs
