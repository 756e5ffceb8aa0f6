# noqa: D400 D205
"""
Native (C) runtime kernels
--------------------------

Host-side hot loops compiled to machine code: the per-iteration
integrator update (:func:`counter_step`), the tree sweep, the
segment replay counters and the runs of an improvement pass's
counting-only node visits (:func:`node_run`). The C sources lie beside
this file: ``counters.c``, ``stepfuncs.c``, ``treesweep.c`` and
``replay.c`` are the port's own copies, byte for byte, of the reference
package's native sources, which a test holds equal; ``nodesweep.c`` is
the port's own. They are built on first use with the
system compiler into ``ultranest_torch/native/_build/`` or, where the
package directory cannot be written (an installed, read-only
site-packages), into the user's cache directory (:func:`build_dir`).
Without a working C compiler the numpy implementations serve instead;
``ULTRANEST_TORCH_NO_NATIVE=1`` forces them.
"""

import ctypes
import os
import subprocess
import tempfile

import numpy as np

__all__ = ['counter_step', 'slice_update', 'tree_sweep', 'node_run',
           'available', 'build_dir']

_HERE = os.path.dirname(os.path.abspath(__file__))
# the C sources live beside this loader
_SRC_DIR = _HERE
_LIB = None


SOURCES = ('counters.c', 'stepfuncs.c', 'treesweep.c', 'replay.c',
           'nodesweep.c')


def build_dir(preferred):
    """Directory for a built library: *preferred*, or a user cache.

    *preferred* lies inside the package; an installed site-packages may
    be read-only, and then ``$XDG_CACHE_HOME/ultranest_torch`` (or
    ``~/.cache/ultranest_torch``) serves. Raises OSError when neither
    can be written.
    """
    try:
        os.makedirs(preferred, exist_ok=True)
        if os.access(preferred, os.W_OK):
            return preferred
    except OSError:
        pass
    base = os.environ.get('XDG_CACHE_HOME') or \
        os.path.join(os.path.expanduser('~'), '.cache')
    d = os.path.join(base, 'ultranest_torch')
    os.makedirs(d, exist_ok=True)
    if not os.access(d, os.W_OK):
        raise PermissionError('no writable build directory: tried %s and %s'
                              % (preferred, d))
    return d


def _build_library():
    """Compile the C sources into a shared library (atomic, cached).

    The build product is keyed on a content hash of the sources —
    wheel-extracted files carry archive mtimes, so an mtime freshness
    check would keep a stale binary across package upgrades.
    """
    import hashlib
    srcs = [os.path.join(_SRC_DIR, s) for s in SOURCES]
    h = hashlib.sha256()
    for s in srcs:
        with open(s, 'rb') as f:
            h.update(f.read())
    out_dir = build_dir(os.path.join(_HERE, '_build'))
    so = os.path.join(out_dir, '_counters-%s.so' % h.hexdigest()[:12])
    if os.path.exists(so):
        return so
    cc = os.environ.get('CC', 'cc')
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=out_dir)
    os.close(fd)
    try:
        subprocess.run(
            [cc, '-O3', '-fPIC', '-shared', '-o', tmp] + srcs + ['-lm'],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def _load():
    """The loaded library, or None when it cannot be built (tried once)
    or ``ULTRANEST_TORCH_NO_NATIVE`` is set."""
    global _LIB
    if os.environ.get('ULTRANEST_TORCH_NO_NATIVE'):
        return None
    if _LIB is not None:
        return _LIB or None
    try:
        lib = ctypes.CDLL(_build_library())
        fn = lib.ns_counter_step
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_long, ctypes.c_double, ctypes.c_long,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_long,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        fs = lib.ns_slice_update
        fs.restype = ctypes.c_long
        fs.argtypes = [
            ctypes.c_long, ctypes.c_long, ctypes.c_long,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_double, ctypes.c_double,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        fr = lib.ns_replay_counters
        fr.restype = ctypes.c_int64
        fr.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        ft = lib.ns_tree_sweep
        ft.restype = ctypes.c_int64
        ft.argtypes = [
            ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_double,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn = lib.ns_node_run
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p] * 3
        _LIB = lib
    except Exception:
        _LIB = False
    return _LIB or None


def available():
    """Whether the native kernels built and loaded."""
    return _load() is not None


_pd = ctypes.POINTER(ctypes.c_double)
_pu8 = ctypes.POINTER(ctypes.c_uint8)
_pi64 = ctypes.POINTER(ctypes.c_int64)


def make_stepper(all_logZ, all_H, all_logVol, nlive, all_logZremain,
                 scalars_out):
    """Bind the persistent counter buffers once; returns a fast stepper.

    The returned callable takes only the per-iteration arguments
    ``(Li, nchildren, active_u8, logwidth_out, values)`` — the state
    array pointers are resolved a single time here instead of on every
    call (ctypes pointer construction dominates otherwise).
    """
    lib = _load()
    if lib is None:
        return None
    fn = lib.ns_counter_step
    nb = ctypes.c_long(len(all_logZ))
    pZ = ctypes.c_void_p(all_logZ.ctypes.data)
    pH = ctypes.c_void_p(all_H.ctypes.data)
    pV = ctypes.c_void_p(all_logVol.ctypes.data)
    pn = ctypes.c_void_p(nlive.ctypes.data)
    pzr = ctypes.c_void_p(all_logZremain.ctypes.data)
    psc = ctypes.c_void_p(scalars_out.ctypes.data)
    c_void_p = ctypes.c_void_p
    c_double = ctypes.c_double
    c_long = ctypes.c_long

    def step(Li, nchildren, active_u8, logwidth_out, values):
        fn(nb, c_double(Li), c_long(nchildren),
           c_void_p(active_u8.ctypes.data), pZ, pH, pV, pn,
           c_void_p(logwidth_out.ctypes.data),
           c_void_p(values.ctypes.data), c_long(len(values)), pzr, psc)

    return step


def counter_step(Li, nchildren, active, all_logZ, all_H, all_logVol,
                 nlive, logwidth_out, values, all_logZremain, scalars_out):
    """Advance all counters by one consumed node (C kernel).

    All array arguments must be C-contiguous with the documented dtypes
    (float64 / uint8 / int64); in/out arrays are updated in place.
    Returns False when the native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return False
    lib.ns_counter_step(
        len(all_logZ), float(Li), int(nchildren),
        active.ctypes.data,
        all_logZ.ctypes.data, all_H.ctypes.data, all_logVol.ctypes.data,
        nlive.ctypes.data, logwidth_out.ctypes.data,
        values.ctypes.data, len(values),
        all_logZremain.ctypes.data, scalars_out.ctypes.data)
    return True


def tree_sweep(values, pids, nch, first_child, nroots, threshold,
               rank_sum=0.0, rank_n=0):
    """Consume-min sweep of a flattened tree (C kernel).

    Parameters are the flattened-tree arrays (see
    ``netiter._flatten_tree``): per-node ordering values (float64),
    point-pile ids / child counts / first-child indices (int64,
    children contiguous), the number of roots, the U-test reset
    threshold in sigmas (<= 0 disables the test) and the incoming
    accumulator state.

    Returns ``(Ls, ids, nch, rootids, nact, cio, runs, rank_sum,
    rank_n, last_value)`` or None when the native library is
    unavailable or the sweep's sorted-actives invariant broke.
    """
    lib = _load()
    if lib is None:
        return None
    nnodes = len(values)
    Ls = np.empty(nnodes)
    out_ids = np.empty(nnodes, dtype=np.int64)
    out_nch = np.empty(nnodes, dtype=np.int64)
    rtid = np.empty(nnodes, dtype=np.int64)
    nact = np.empty(nnodes, dtype=np.int64)
    cio = np.empty(nnodes, dtype=np.int64)
    runs = np.empty(nnodes, dtype=np.int64)
    acc_state = np.array([float(rank_sum), float(rank_n), 0.0])
    last_value = np.empty(1)
    status = lib.ns_tree_sweep(
        nnodes, int(nroots),
        values.ctypes.data, pids.ctypes.data,
        nch.ctypes.data, first_child.ctypes.data,
        float(threshold),
        Ls.ctypes.data, out_ids.ctypes.data, out_nch.ctypes.data,
        rtid.ctypes.data, nact.ctypes.data, cio.ctypes.data,
        runs.ctypes.data, acc_state.ctypes.data, last_value.ctypes.data)
    if status != 0:
        return None
    nruns = int(acc_state[2])
    return (Ls, out_ids, out_nch, rtid, nact, cio, runs[:nruns],
            float(acc_state[0]), int(acc_state[1]), float(last_value[0]))


def node_run():
    """The C routine that consumes a run of counting-only node visits
    (``nodesweep.c``: ``ns_node_run(iv, dv, pv)``, three parameter
    vectors, see ``netiter.NodeSweep``), or None when the native library
    is unavailable."""
    lib = _load()
    return None if lib is None else lib.ns_node_run


def replay_counters(Li, nch, rootid, nact, rootmask, random_mode, u_nl,
                    nl_ord):
    """Whole-run counter replay over the consumed-node sequence (C).

    See ``replay.c`` for the argument layout.  Returns
    ``(logw, zprev, vol0prev, all_logZ, all_H, all_logVol,
    nlive_final)`` or None when the native library is unavailable or
    the live-count bookkeeping check fails (caller falls back to the
    numpy implementation).
    """
    lib = _load()
    if lib is None:
        return None
    T = len(Li)
    nb, nroots = rootmask.shape
    logw = np.empty((T, nb))
    zprev = np.empty((nb, T))
    vol0prev = np.empty(T)
    all_logZ = np.empty(nb)
    all_H = np.empty(nb)
    all_logVol = np.empty(nb)
    nlive_final = np.empty(nb, dtype=np.int64)
    if u_nl is None:
        u_nl = np.empty((0, nb))
    status = lib.ns_replay_counters(
        T, nb, nroots,
        Li.ctypes.data, nch.ctypes.data, rootid.ctypes.data,
        nact.ctypes.data, rootmask.ctypes.data,
        int(random_mode), u_nl.ctypes.data, nl_ord.ctypes.data,
        logw.ctypes.data, zprev.ctypes.data, vol0prev.ctypes.data,
        all_logZ.ctypes.data, all_H.ctypes.data, all_logVol.ctypes.data,
        nlive_final.ctypes.data)
    if status != 0:
        return None
    return (logw, zprev, vol0prev, all_logZ, all_H, all_logVol,
            nlive_final)


def slice_update(t, tleft, tright, proposed_L, proposed_u, proposed_p,
                 worker_running, status, Lthresh, shrink,
                 allu, allL, allp):
    """Shrink slices + harvest acceptances in one C pass (sequential).

    All arrays must be C-contiguous float64 / int64. Returns the number
    of discarded above-threshold proposals, or None when the native
    library is unavailable (caller falls back to numpy).
    """
    lib = _load()
    if lib is None:
        return None
    popsize = len(t)
    return int(lib.ns_slice_update(
        popsize, allu.shape[1], allp.shape[1],
        t.ctypes.data, tleft.ctypes.data, tright.ctypes.data,
        proposed_L.ctypes.data, proposed_u.ctypes.data,
        proposed_p.ctypes.data,
        worker_running.ctypes.data, status.ctypes.data,
        float(Lthresh), float(shrink),
        allu.ctypes.data, allL.ctypes.data, allp.ctypes.data))
