# noqa: D400 D205
"""
Graph-based nested sampling engine
----------------------------------

Nested sampling exploration expressed as a breadth-first search over a tree
(Buchner 2023, sec 3.4, arxiv:2101.09675): the root is the prior volume,
children split it, leaves are the integration tail. The number of parallel
arcs passing a node is the local number of live points.

Host engine of the PyTorch port, carried over unchanged from
:mod:`ultranest_tpu.netiter` (itself a rebuild of upstream
ultranest/netiter.py). Differences from upstream:

* the integrator state (``MultiCounter``) advances all ``1+nbootstraps``
  estimators as flat vectors and maintains per-estimator live-point counts
  *incrementally* (O(B) per iteration instead of O(B·nlive));
* this layer is deliberately host/numpy: per-iteration work is a handful of
  length-(B+1) vector ops, far below any useful device-offload threshold.
  The heavy work (region geometry, likelihoods) lives in
  :mod:`ultranest_torch.ops` and :mod:`ultranest_torch.fused` on the GPU.
"""

import bisect
import math
import sys

import numpy as np
from numpy import exp, log, log1p, logaddexp

from . import native as _native
from .ordertest import UniformOrderAccumulator
from .utils import resample_equal

__all__ = [
    'TreeNode', 'BreadthFirstIterator', 'PointPile', 'SingleCounter',
    'MultiCounter', 'combine_results', 'logz_sequence', 'print_tree',
    'dump_tree', 'count_tree', 'count_tree_between', 'find_nodes_before',
]


class TreeNode:
    """Tree node: an (ordering value, point-pile id, children) triple."""

    __slots__ = ('value', 'id', 'children')

    def __init__(self, value=None, id=None, children=None):
        """Initialise node.

        Parameters
        ----------
        value: float
            ordering value (log-likelihood)
        id: int
            index into the PointPile where coordinates live
        children: list of TreeNode or None
        """
        self.value = value
        self.id = id
        self.children = children if children is not None else []

    def __str__(self, indent=0):
        """Render node and children recursively."""
        return ' ' * indent + '- Node: %s\n' % self.value + '\n'.join(
            c.__str__(indent=indent + 2) for c in self.children)

    def __lt__(self, other):
        """Order by value."""
        return self.value < other.value


class BreadthFirstIterator:
    """Iterate tree nodes in increasing value order.

    The active set (live points) is kept as parallel numpy arrays plus a
    python list of node objects; ``next_node`` is an argmin over values.
    """

    def __init__(self, roots):
        """Start with initial set of nodes *roots*."""
        self.roots = roots
        self.reset()

    def reset(self):
        """(Re)start exploration from the top."""
        nodes = list(self.roots)
        self.active_nodes = nodes
        self.active_root_ids = np.arange(len(nodes))
        self.active_node_values = np.fromiter(
            (n.value for n in nodes), dtype=float, count=len(nodes))
        self.active_node_ids = np.fromiter(
            (n.id for n in nodes), dtype=np.int64, count=len(nodes))

    def next_node(self):
        """Return the next node in value order without removing it.

        Returns
        -------
        None if exhausted, else the tuple
        ``rootid, node, (active_nodes, active_root_ids, active_node_values,
        active_node_ids)``.
        """
        if not self.active_nodes:
            return None
        i = self.next_index = int(np.argmin(self.active_node_values))
        node = self.active_nodes[i]
        rootid = self.active_root_ids[i]
        return rootid, node, (
            self.active_nodes, self.active_root_ids,
            self.active_node_values, self.active_node_ids)

    def drop_next_node(self):
        """Remove the most recently returned node without expanding it."""
        self._remove_at(self.next_index)

    def _remove_at(self, i):
        self.active_nodes.pop(i)
        self.active_node_values = np.delete(self.active_node_values, i)
        self.active_root_ids = np.delete(self.active_root_ids, i)
        self.active_node_ids = np.delete(self.active_node_ids, i)

    def expand_children_of(self, rootid, node):
        """Replace *node* with its children in the active set."""
        i = self.next_index
        children = node.children
        if len(children) == 1:
            child = children[0]
            self.active_nodes[i] = child
            self.active_node_values[i] = child.value
            self.active_root_ids[i] = rootid
            self.active_node_ids[i] = child.id
        elif len(children) == 0:
            self._remove_at(i)
        else:
            self._remove_at(i)
            self.active_nodes += children
            self.active_node_values = np.concatenate(
                (self.active_node_values, [c.value for c in children]))
            self.active_root_ids = np.concatenate(
                (self.active_root_ids, [rootid] * len(children)))
            self.active_node_ids = np.concatenate(
                (self.active_node_ids, [c.id for c in children]))


def _lane_row(lanes, fill='║'):
    """Render one text row of lane markers (blank for dead lanes)."""
    return ''.join(fill if n is not None else ' ' for n in lanes)


def print_tree(roots, title='Tree:'):
    """Print a compact unicode rendering of the tree.

    Each live arc occupies a text lane; forks split a lane, leaves
    terminate one.
    """
    print()
    print(title)
    walker = BreadthFirstIterator(roots)
    lanes = list(roots)
    prev_lane = -1
    out = sys.stdout
    while True:
        visit = walker.next_node()
        if visit is None:
            return
        rootid, node, _ = visit
        lane = lanes.index(node)
        kids = node.children
        left = _lane_row(lanes[:lane])
        right = _lane_row(lanes[lane + 1:])
        if prev_lane == lane:
            out.write('%s║%s\n' % (left, right))
        label = '%s \t%s' % (right, node.value)
        if not kids:
            out.write('%sO%s\n' % (left, label))
            lanes[lane] = None
        elif len(kids) == 1:
            out.write('%s+%s\n' % (left, label))
            lanes[lane] = kids[0]
        else:
            for j in range(len(kids)):
                shifted = _lane_row(lanes[lane + 1:], fill='\\')
                if shifted:
                    out.write('%s║%s%s\n' % (left, ' ' * j, shifted))
            out.write('%s╠%s╗%s\n' % (left, '╦' * (len(kids) - 2), label))
            lanes[lane:lane + 1] = list(reversed(kids))
        walker.expand_children_of(rootid, node)
        prev_lane = lane


def _tree_edges(roots):
    """Collect (parent_id, child_id, child_value) by breadth-first sweep."""
    parent_ids, child_ids, child_values = [], [], []
    explorer = BreadthFirstIterator(roots)
    while True:
        next_node = explorer.next_node()
        if next_node is None:
            break
        rootid, node, _ = next_node
        for c in node.children:
            parent_ids.append(node.id)
            child_ids.append(c.id)
            child_values.append(c.value)
        explorer.expand_children_of(rootid, node)
    return parent_ids, child_ids, child_values


def dump_tree(filename, roots, pointpile):
    """Write a copy of the tree to an HDF5 file."""
    import h5py
    parent_ids, child_ids, child_values = _tree_edges(roots)
    with h5py.File(filename, 'w') as f:
        f.create_dataset('unit_points', data=pointpile.us[:pointpile.nrows, :],
                         compression='gzip', shuffle=True)
        f.create_dataset('points', data=pointpile.ps[:pointpile.nrows, :],
                         compression='gzip', shuffle=True)
        f.create_dataset('nodes_parent_id', data=parent_ids,
                         compression='gzip', shuffle=True)
        f.create_dataset('nodes_child_id', data=child_ids,
                         compression='gzip', shuffle=True)
        f.create_dataset('nodes_child_logl', data=child_values,
                         compression='gzip', shuffle=True)


def count_tree_between(roots, lo=-np.inf, hi=np.inf):
    """Number of nodes and widest arc count with lo <= value <= hi."""
    walker = BreadthFirstIterator(roots)
    nnodes, widest = 0, 0
    while True:
        visit = walker.next_node()
        if visit is None or visit[1].value > hi:
            return nnodes, widest
        rootid, node, (_, arc_roots, _, _) = visit
        if node.value >= lo:
            nnodes += 1
            widest = max(widest, len(arc_roots))
        walker.expand_children_of(rootid, node)


def count_tree(roots):
    """Return (number of nodes, maximum number of parallel arcs)."""
    return count_tree_between(roots)


def find_nodes_before(root, value):
    """Find all nodes whose children reach above *value*.

    Returns
    -------
    parents: list of nodes
    parent_weights: list of floats
        number of forks experienced on the path to each parent
    """
    parents, parent_weights = [], []
    forks = {n.id: 1.0 for n in root.children}
    walker = BreadthFirstIterator(root.children)
    while True:
        visit = walker.next_node()
        if visit is None:
            break
        rootid, node, _ = visit
        if node.value >= value:
            # threshold already crossed at a root child: root is the parent
            parents.append(root)
            parent_weights.append(1)
            break
        if any(child.value >= value for child in node.children):
            # this node straddles the threshold: collect, don't descend
            parents.append(node)
            parent_weights.append(forks[node.id])
            walker.drop_next_node()
        else:
            walker.expand_children_of(rootid, node)
            branch = forks[node.id] * len(node.children)
            for child in node.children:
                forks[child.id] = branch
        del forks[node.id]
    return parents, parent_weights


class PointPile:
    """Linearized store of point coordinates in u-space and p-space.

    Tree nodes store only ``(value, id)``; the pile owns the coordinates.
    Backed by amortized-doubling numpy arrays.
    """

    def __init__(self, udim, pdim, chunksize=1000):
        """Set up pile for *udim* unit-cube and *pdim* physical columns."""
        self.udim = udim
        self.pdim = pdim
        self.chunksize = chunksize
        self.nrows = 0
        self.us = np.zeros((chunksize, udim))
        self.ps = np.zeros((chunksize, pdim))

    def add(self, newpointu, newpointp):
        """Append a point; returns its index."""
        if len(newpointu) != self.udim or len(newpointp) != self.pdim:
            raise ValueError("point dimensions do not match pile layout")
        row = self.nrows
        if row == len(self.us):
            self._grow(row + 1)
        self.us[row, :] = newpointu
        self.ps[row, :] = newpointp
        self.nrows = row + 1
        return row

    def _grow(self, need):
        """Grow capacity to at least *need* rows (amortized doubling).

        Allocates uninitialized storage and copies only the ``nrows``
        live rows: ``np.vstack`` with a zeros block both zero-fills the
        growth region and copies the old buffer's unused tail, several
        times the necessary traffic on long runs.
        """
        cap = max(self.chunksize, 2 * len(self.us), need)
        us = np.empty((cap, self.udim))
        ps = np.empty((cap, self.pdim))
        n = self.nrows
        us[:n] = self.us[:n]
        ps[:n] = self.ps[:n]
        self.us = us
        self.ps = ps

    def add_many(self, newus, newps):
        """Append a batch of points; returns the first index.

        Rows ``base .. base+len(newus)-1`` hold the batch in order —
        one slice assignment instead of per-row :meth:`add` calls (the
        segment replay appends ~1k accepted rows per dispatch).
        """
        newus = np.asarray(newus)
        newps = np.asarray(newps)
        n, base = len(newus), self.nrows
        if newus.shape != (n, self.udim) or newps.shape != (n, self.pdim):
            raise ValueError("point dimensions do not match pile layout")
        need = base + n
        if need > len(self.us):
            self._grow(need)
        self.us[base:need] = newus
        self.ps[base:need] = newps
        self.nrows = need
        return base

    def getu(self, i):
        """Get unit-cube point(s) with index(es) *i*."""
        return self.us[i]

    def getp(self, i):
        """Get physical point(s) with index(es) *i*."""
        return self.ps[i]

    def make_node(self, value, u, p):
        """Store point and return a TreeNode referencing it."""
        return TreeNode(value=value, id=self.add(u, p))


class SingleCounter:
    """Evidence (logZ) and posterior-weight integrator for one estimator."""

    def __init__(self, random=False):
        """If *random*, draw volume shrinkage from Beta(1, N); else use mean."""
        self.random = random
        self.reset()

    def reset(self):
        """Reset the integration state."""
        # amortized-growth scalar buffer (cf. MultiCounter.logweights)
        self._logw_buf = np.empty(1024)
        self._logw_n = 0
        self.H = None
        self.logZ = -np.inf
        self.logZerr = np.inf
        self.logVolremaining = 0.0
        self.i = 0
        self.fraction_remaining = np.inf
        self.Lmax = -np.inf

    @property
    def logZremain(self):
        """Conservative logZ estimate of the unexplored tail."""
        return self.Lmax + self.logVolremaining

    @property
    def logweights(self):
        """Per-iteration log volume widths, shape (niter,)."""
        return self._logw_buf[:self._logw_n]

    @logweights.setter
    def logweights(self, value):
        v = np.asarray(value, dtype=np.float64).reshape(-1)
        self._logw_buf = v
        self._logw_n = len(v)

    def _logw_append(self, w):
        buf, n = self._logw_buf, self._logw_n
        if n >= len(buf):
            grown = np.empty(2 * len(buf))
            grown[:n] = buf[:n]
            self._logw_buf = buf = grown
        buf[n] = w
        self._logw_n = n + 1

    def _absorb_weight(self, Li, logwidth, nlive):
        """Fold one weighted sample into logZ and the information H."""
        wi = logwidth + Li
        if math.isinf(self.logZ):
            self.logZ = wi
            self.H = Li - wi
        else:
            Znew = logaddexp(self.logZ, wi)
            self.H = (exp(wi - Znew) * Li - Znew
                      + exp(self.logZ - Znew) * (self.H + self.logZ))
            self.logZ = Znew
        if self.H is not None and self.H >= 0:
            self.logZerr = (self.H / nlive) ** 0.5

    def passing_node(self, node, parallel_nodes):
        """Accumulate a consumed *node* passed by *parallel_nodes* arcs."""
        Li = node.value
        nlive = len(parallel_nodes)
        if len(node.children) == 0:
            # leaf: live point removed without replacement
            logwidth = self.logVolremaining - log(nlive)
            self._logw_append(logwidth)
            self.logZ = logaddexp(self.logZ, logwidth + Li)
            with np.errstate(divide='ignore'):
                self.logVolremaining += log1p(-1.0 / nlive)
            return
        # a live point is replaced: volume shrinks by exp(-1/N)
        if self.random:
            shrink = np.random.beta(1, nlive)
            logleft, logright = log(shrink), log1p(-shrink)
        else:
            logleft, logright = log1p(-exp(-1.0 / nlive)), -1.0 / nlive
        logwidth = logleft + self.logVolremaining
        self._logw_append(logwidth)
        self._absorb_weight(Li, logwidth, nlive)
        self.logVolremaining += logright


class MultiCounter:
    """Vectorized integrator advancing 1 + nbootstraps estimators at once.

    Counter 0 contains all roots (the main estimator); each bootstrap
    counter contains a random subset of roots. All per-iteration state is
    held in flat ``(1+B,)`` vectors; live-point counts per counter are
    maintained incrementally.

    **Attributes**: ``logZ``, ``logZerr``, ``logVolremaining`` (main
    estimator); ``Lmax``; ``logZ_bs``, ``logZerr_bs`` (bootstrap ensemble);
    ``logZremain``, ``remainder_fraction``; per-iteration lists
    ``logweights`` and ``istail``.
    """

    def __init__(self, nroots, nbootstraps=10, random=False,
                 check_insertion_order=False, rng=np.random):
        """Set up counter over *nroots* roots with *nbootstraps* resamples."""
        allyes = np.ones(nroots, dtype=bool)
        rootid_masks = [allyes]
        for _ in range(nbootstraps):
            mask = np.zeros(nroots, dtype=bool)
            mask[rng.randint(nroots, size=nroots)] = True
            rootid_masks.append(mask)
        self.rootids = np.array(rootid_masks)
        self.random = random
        self.rng = rng
        self.ncounters = len(self.rootids)

        self.check_insertion_order = check_insertion_order
        self.insertion_order_threshold = 4
        self.insertion_order_accumulator = UniformOrderAccumulator()

        self.reset(self.ncounters)

    def reset(self, nentries):
        """Reset integration state for *nentries* counters."""
        # amortized-growth (niter, ncounters) buffer: a python list of
        # tens of thousands of small per-iteration rows is slow to
        # np.array() in combine_results; the 2D buffer makes that a
        # cheap block copy (rows are append-only, never mutated)
        self._logw_buf = np.empty((1024, nentries))
        self._logw_n = 0
        self.istail = []
        self.Lmax = -np.inf
        self.logZ, self.logZerr = -np.inf, np.inf
        self.all_H = np.full(nentries, np.nan)
        self.all_logZ = np.full(nentries, -np.inf)
        self.all_logVolremaining = np.zeros(nentries)
        self.logVolremaining = 0.0
        self.all_logZremain = np.full(nentries, np.inf)
        self.logZremainMax = self.logZremain = np.inf
        self.remainder_ratio = self.remainder_fraction = 1.0
        # incremental per-counter live-point counts; populated lazily because
        # roots can still be added after construction
        self._nlive = None
        self.insertion_order_accumulator.reset()
        self.insertion_order_runs = []

    @property
    def logweights(self):
        """Per-iteration log volume widths, shape (niter, ncounters)."""
        return self._logw_buf[:self._logw_n]

    @logweights.setter
    def logweights(self, value):
        # replay paths (logz_sequence) assign a finished (niter, nb)
        # matrix wholesale
        v = np.asarray(value, dtype=np.float64)
        if v.size == 0:
            v = np.empty((0, self.ncounters))
        self._logw_buf = v
        self._logw_n = len(v)

    def _logw_append(self, row):
        buf, n = self._logw_buf, self._logw_n
        if n >= len(buf):
            grown = np.empty((2 * len(buf), buf.shape[1]))
            grown[:n] = buf[:n]
            self._logw_buf = buf = grown
        buf[n] = row
        self._logw_n = n + 1

    def _logw_extend(self, block):
        T = len(block)
        buf, n = self._logw_buf, self._logw_n
        if n + T > len(buf):
            grown = np.empty((max(2 * len(buf), n + T), buf.shape[1]))
            grown[:n] = buf[:n]
            self._logw_buf = buf = grown
        buf[n:n + T] = block
        self._logw_n = n + T

    def _bootstrap_ensemble(self):
        """The logZ estimates of the bootstrap counters (excludes main)."""
        return self.all_logZ[1:]

    @property
    def logZ_bs(self):
        """Bootstrap-ensemble logZ estimate."""
        return self._bootstrap_ensemble().mean()

    @property
    def logZerr_bs(self):
        """Bootstrap-ensemble logZ uncertainty."""
        return self._bootstrap_ensemble().std()

    @property
    def insertion_order_runlength(self):
        """Shortest recorded insertion-order run length (inf if none)."""
        return min(self.insertion_order_runs, default=np.inf)

    @property
    def insertion_order_converged(self):
        """Whether the U-test shows no more resets than expected for an unbiased run."""
        niter = len(self.logweights)
        expected_number = max(1, int(np.ceil(niter / 10 ** 5.5)))
        return len(self.insertion_order_runs) <= expected_number

    def passing_node(self, rootid, node, rootids, parallel_values):
        """Accumulate consumed *node* (from root *rootid*).

        *rootids* gives the root of each currently active (parallel) arc and
        *parallel_values* their log-likelihoods. Must be called exactly once
        per consumed node, before the iterator expands its children (the
        incremental live counts rely on this contract).

        Dispatches to the C kernel (:mod:`ultranest_torch.native`) in the
        deterministic-shrinkage case; the numpy body below is the
        reference implementation and the ``random=True`` path.
        """
        if not self.random and _native.available():
            return self._passing_node_native(
                rootid, node, rootids, parallel_values)
        return self._passing_node_py(rootid, node, rootids, parallel_values)

    def _passing_node_native(self, rootid, node, rootids, parallel_values):
        """One-call C update of all counters (see counters.c)."""
        nchildren = len(node.children)
        if self._nlive is None:
            self._nlive = np.ascontiguousarray(
                self.rootids[:, rootids].sum(axis=1), dtype=np.int64)
            self._rootids_u8 = np.ascontiguousarray(
                self.rootids.T, dtype=np.uint8)
            self._logZremain_buf = np.empty(self.ncounters)
            self._scalars_buf = np.empty(6)
            self._stepper = _native.make_stepper(
                self.all_logZ, self.all_H, self.all_logVolremaining,
                self._nlive, self._logZremain_buf, self._scalars_buf)
        nlive0 = int(self._nlive[0])
        logwidth = np.empty(self.ncounters)
        values = np.ascontiguousarray(parallel_values, dtype=np.float64)
        self._stepper(node.value, nchildren, self._rootids_u8[rootid],
                      logwidth, values)
        s = self._scalars_buf
        self.logZ = s[0]
        if nchildren >= 1 and not np.isnan(s[1]):
            self.logZerr = s[1]
        self.logVolremaining = self.all_logVolremaining[0]
        self.all_logZremain = self._logZremain_buf
        self.logZremain = s[2]
        self.logZremainMax = s[3]
        self.remainder_ratio = s[4]
        self.remainder_fraction = s[5]
        self._logw_append(logwidth)
        self.istail.append(nchildren == 0)
        if self.check_insertion_order and nchildren >= 1 and \
                len(np.unique(parallel_values)) == len(parallel_values):
            acc = self.insertion_order_accumulator
            for child in node.children:
                acc.add(int((parallel_values < child.value).sum()), nlive0)
                if abs(acc.zscore) > self.insertion_order_threshold:
                    self.insertion_order_runs.append(len(acc))
                    acc.reset()

    def passing_segment(self, Li_seq, rootid_seq, live_logsumexp_seq,
                        nlive0):
        """Advance all counters over a pure-replacement segment at once.

        Equivalent to ``passing_node`` called for *T* consecutive nodes
        that each receive exactly one child (so per-counter live counts
        stay constant), expressed as ``(ncounters, T)`` array math —
        the same recurrences as :func:`_replay_vectorized`, but
        incremental: carried in from and written back to the counter
        state. Only the deterministic-shrinkage mode is supported
        (``random=False``).

        Parameters
        ----------
        Li_seq: float array (T,)
            consumed node log-likelihoods, in consumption order
        rootid_seq: int array (T,)
            root id of each consumed node
        live_logsumexp_seq: float array (T,)
            logsumexp of the live log-likelihoods at each step
            (including the consumed node), for the tail estimate
        nlive0: int
            main-counter live count (constant over the segment)

        Returns
        -------
        logZ0_seq, logZremain0_seq: float arrays (T,)
            the main counter's post-update evidence and tail estimate
            per step (for termination scans)
        """
        assert not self.random, 'passing_segment requires random=False'
        Li = np.asarray(Li_seq, dtype=np.float64)
        T = len(Li)
        if self._nlive is None:
            raise ValueError('counters not initialized; call passing_node '
                             'once or seed _nlive before segment mode')
        nlive = np.asarray(self._nlive, dtype=np.float64)
        nlive_safe = np.maximum(nlive, 1.0)

        A = self.rootids[:, rootid_seq]                     # (nb, T)
        logright = (-1.0 / nlive_safe)[:, None]             # (nb, 1)
        logleft = log1p(-exp(logright))                     # (nb, 1)

        # exclusive prefix of the volume shrinkage
        ecum = np.cumsum(A, axis=1, dtype=np.float64)
        ecum -= A
        logVolprev = self.all_logVolremaining[:, None] + logright * ecum
        with np.errstate(invalid='ignore'):
            logwidth = np.where(A, logleft + logVolprev, -np.inf)
        wi = logwidth + Li[None, :]

        # logZ: logaddexp-accumulate with the carried-in state prepended
        zmat = np.concatenate([self.all_logZ[:, None], wi], axis=1)
        logZmat = np.logaddexp.accumulate(zmat, axis=1)
        logZprev, logZpost = logZmat[:, :-1], logZmat[:, 1:]

        # H via the closed-form solution of the linear recurrence
        # H_t = a_t H_(t-1) + b_t  (cf. _replay_vectorized)
        first = A & np.isneginf(logZprev)
        with np.errstate(invalid='ignore', over='ignore', under='ignore',
                         divide='ignore'):
            expw = np.where(A, np.exp(wi - logZpost), 0.0)
            alpha = np.where(A & ~first, np.exp(logZprev - logZpost), 0.0)
            alpha = np.where(~A, 1.0, alpha)                # inactive: H keeps
            beta = np.where(
                A, expw * Li[None, :] + alpha * logZprev - logZpost, 0.0)
            beta = np.where(first, -logwidth, beta)
            # H_T = (prod alpha) * H_0 + sum_t beta_t * prod_(s>t) alpha_s
            # A first-setting step has alpha=0, which zeroes the products
            # through it — carried-in H and earlier betas drop out
            # automatically (log(0) = -inf, exp(-inf) = 0).
            logalpha = np.log(alpha)
            suffix = np.cumsum(logalpha[:, ::-1], axis=1)[:, ::-1]
            # suffix[:, t] = sum_(s>=t) logalpha_s; products need s>t
            tailprod = np.exp(np.concatenate(
                [suffix[:, 1:], np.zeros((len(A), 1))], axis=1))
            H0 = np.where(np.isnan(self.all_H), 0.0, self.all_H)
            Hnew = H0 * np.exp(suffix[:, 0]) + np.sum(beta * tailprod,
                                                      axis=1)
        # IN-PLACE state writes: the native per-node stepper binds
        # ctypes pointers to these exact buffers (make_stepper), so the
        # arrays must never be replaced, only mutated
        started = ~np.isneginf(logZpost[:, -1])
        self.all_H[:] = np.where(started, Hnew, self.all_H)
        self.all_logZ[:] = logZmat[:, -1]
        self.all_logVolremaining[:] = (
            logVolprev[:, -1] + np.where(A[:, -1], logright[:, 0], 0.0))
        self.logZ = self.all_logZ[0]
        self.logVolremaining = self.all_logVolremaining[0]
        if self.all_H[0] > 0:
            self.logZerr = (self.all_H[0] / max(nlive0, 1)) ** 0.5

        self._logw_extend(logwidth.T)
        self.istail.extend([False] * T)

        # tail estimates from the final live values
        tail_final = live_logsumexp_seq[-1] - log(max(nlive0, 1))
        self.all_logZremain[:] = self.all_logVolremaining + tail_final
        self.logZremain = self.all_logZremain[0]
        self.logZremainMax = self.all_logZremain.max()
        with np.errstate(over='ignore'):
            # logZ starts at -inf: the remainder ratio is legitimately
            # infinite until the first weight lands
            self.remainder_ratio = exp(self.logZremain - self.logZ)
            self.remainder_fraction = 1.0 / (
                1.0 + exp(self.logZ - self.logZremain))

        # per-step main-counter sequences for the host's termination scan
        logZ0_seq = logZpost[0]
        logVol0_seq = logVolprev[0] + logright[0, 0]
        logZremain0_seq = (logVol0_seq + live_logsumexp_seq
                          - log(max(nlive0, 1)))
        return logZ0_seq, logZremain0_seq

    def _passing_node_py(self, rootid, node, rootids, parallel_values):
        """Numpy reference implementation of the counter update."""
        nchildren = len(node.children)
        Li = node.value
        # active: in which counters does this node's root participate
        active = self.rootids[:, rootid]
        if self._nlive is None:
            # first call (or after reset): count live arcs per counter directly
            self._nlive = self.rootids[:, rootids].sum(axis=1)
        nlive = self._nlive
        nlive0 = nlive[0]
        # counters whose roots have all died carry nlive=0; they are
        # inactive for this node, but the vector math must stay defined
        nlive_safe = np.maximum(nlive, 1)

        if nchildren >= 1:
            # arc continues: volume slice (1-exp(-1/N)) of the remainder
            if self.random:
                # inverse-CDF Beta(1,N) shrinkage: x = 1 - u^(1/N), so
                # log(1-x) = log(u)/N (main counter deterministic)
                u = self.rng.random(size=self.ncounters)
                logright = log(u) / nlive_safe
                logright[0] = -1.0 / nlive0
                logleft = log1p(-exp(logright))
            else:
                logleft = log1p(-exp(-1.0 / nlive_safe))
                logright = -1.0 / nlive_safe

            logwidth = logleft + self.all_logVolremaining
            logwidth[~active] = -np.inf
            wi = logwidth[active] + Li
            self._logw_append(logwidth)
            self.istail.append(False)

            logZ = self.all_logZ[active]
            logZnew = logaddexp(logZ, wi)
            H = exp(wi - logZnew) * Li \
                + exp(logZ - logZnew) * (self.all_H[active] + logZ) - logZnew
            first_setting = np.isnan(H)
            self.all_logZ[active] = np.where(first_setting, wi, logZnew)
            self.all_H[active] = np.where(first_setting, -logwidth[active], H)
            self.logZ = self.all_logZ[0]

            if self.all_H[0] > 0:
                self.logZerr = (self.all_H[0] / nlive0) ** 0.5

            self.all_logVolremaining[active] += logright[active]
            self.logVolremaining = self.all_logVolremaining[0]

            if self.check_insertion_order and \
                    len(np.unique(parallel_values)) == len(parallel_values):
                acc = self.insertion_order_accumulator
                for child in node.children:
                    acc.add(int((parallel_values < child.value).sum()), nlive0)
                    if abs(acc.zscore) > self.insertion_order_threshold:
                        self.insertion_order_runs.append(len(acc))
                        acc.reset()
        else:
            # leaf: tail contribution volume/N
            logwidth = -np.inf * np.ones(self.ncounters)
            logwidth[active] = self.all_logVolremaining[active] - log(nlive_safe[active])
            wi = logwidth + Li
            self._logw_append(logwidth)
            self.istail.append(True)
            self.all_logZ[active] = logaddexp(self.all_logZ[active], wi[active])
            self.logZ = self.all_logZ[0]
            with np.errstate(divide='ignore'):
                self.all_logVolremaining[active] += log1p(-1.0 / nlive_safe[active])
            self.logVolremaining = self.all_logVolremaining[0]

        # tail estimate from current live values (same values for all counters)
        Lmax = np.max(parallel_values)
        V = self.all_logVolremaining - log(nlive0)
        self.all_logZremain = V + log(np.sum(exp(parallel_values - Lmax))) + Lmax
        self.logZremainMax = self.all_logZremain.max()
        self.logZremain = self.all_logZremain[0]
        with np.errstate(over='ignore', under='ignore'):
            self.remainder_ratio = exp(self.logZremain - self.logZ)
            self.remainder_fraction = 1.0 / (1 + exp(self.logZ - self.logZremain))

        # incremental live-count update: node is replaced by its children
        self._nlive = nlive + (nchildren - 1) * active


def combine_results(saved_logl, saved_nodeids, pointpile, main_iterator,
                    mpi_comm=None):
    """Combine dead-point sequence and integrator state into a results dict.

    Parameters
    ----------
    saved_logl: list of floats
        log-likelihoods of dead points, in consumption order
    saved_nodeids: list of ints
        point-pile indices of dead points
    pointpile: PointPile
    main_iterator: MultiCounter
    mpi_comm: optional communicator for merging bootstrap weights across
        shards (gather+bcast idiom)

    Returns
    -------
    results: dict
        niter, logz(+errors), ess, H, posterior summaries, weighted and
        equally weighted samples, maximum likelihood point.
    """
    assert np.shape(main_iterator.logweights) == (
        len(saved_logl), len(main_iterator.all_logZ)), (
        np.shape(main_iterator.logweights), np.shape(saved_logl),
        np.shape(main_iterator.all_logZ))

    saved_logl = np.array(saved_logl)
    saved_ids = np.asarray(saved_nodeids, dtype=np.intp)
    saved_u = pointpile.getu(saved_ids)
    saved_v = pointpile.getp(saved_ids)
    saved_logwt = np.array(main_iterator.logweights)
    saved_logwt0 = saved_logwt[:, 0]
    saved_logwt_bs = saved_logwt[:, 1:]
    logZ_bs = main_iterator.all_logZ[1:]

    if mpi_comm is not None:
        recv = mpi_comm.gather(saved_logwt_bs, root=0)
        recv = mpi_comm.bcast(recv, root=0)
        saved_logwt_bs = np.concatenate(recv, axis=1)
        recv = mpi_comm.gather(logZ_bs, root=0)
        recv = mpi_comm.bcast(recv, root=0)
        logZ_bs = np.concatenate(recv)

    with np.errstate(over='ignore', under='ignore', invalid='ignore'):
        # in-place chain: the (niter, nbootstraps) weight block is the
        # largest allocation of the results assembly (3 temporaries
        # when computed out of place)
        saved_wt_bs = saved_logwt_bs + saved_logl.reshape((-1, 1))
        np.subtract(saved_wt_bs, logZ_bs, out=saved_wt_bs)
        np.exp(saved_wt_bs, out=saved_wt_bs)
        saved_wt0 = exp(saved_logwt0 + saved_logl - main_iterator.all_logZ[0])

    # posterior effective sample size and tail diagnostics
    w = saved_wt0 / saved_wt0.sum()
    ess = len(w) / (1.0 + ((len(w) * w - 1) ** 2).sum() / len(w))
    tail_fraction = w[np.asarray(main_iterator.istail)].sum()
    if tail_fraction != 0:
        logzerr_tail = logaddexp(
            log(tail_fraction) + main_iterator.logZ,
            main_iterator.logZ) - main_iterator.logZ
    else:
        logzerr_tail = 0

    logzerr_bs = (logZ_bs - main_iterator.logZ).max()
    logzerr_total = (logzerr_tail**2 + logzerr_bs**2) ** 0.5
    samples = resample_equal(saved_v, w)

    # prior->posterior compression per axis, in bits, from the weighted
    # unit-cube marginal histograms — all axes binned in one bincount
    # pass (per-column np.histogram calls argsort the column each)
    bins = np.linspace(0, 1, 40)
    nb = len(bins) - 1
    ndim_u = saved_u.shape[1]
    # uniform-bin fast path: u is in the unit cube by construction, so
    # the bin index is floor(u * nb) (clipped for u == 1.0); int32 +
    # in-place clip halves the index-array traffic vs intp temporaries
    bidx = (saved_u * nb).astype(np.int32)
    np.clip(bidx, 0, nb - 1, out=bidx)
    # one flat bincount over all axes (bin ids offset per axis): the
    # per-column loop re-read a strided column + the weight vector
    # per axis (same output)
    bidx += np.arange(ndim_u, dtype=np.int32)[None, :] * nb
    hists = np.bincount(
        bidx.ravel(), weights=np.repeat(saved_wt0, ndim_u),
        minlength=nb * ndim_u).reshape(-1, nb)
    hists /= saved_wt0.sum() * (bins[1] - bins[0])   # density=True
    information_gain_bits = [
        float((np.log2(1 / ((hist + 0.001) * 40)) / 40).sum())
        for hist in hists]

    # one partition pass for all three quantiles (3x fewer
    # np.percentile sweeps over the resampled chain)
    qmat = np.percentile(samples, [50, 15.8655, 84.1345], axis=0)
    posterior = dict(
        mean=samples.mean(axis=0).tolist(),
        stdev=samples.std(axis=0).tolist(),
        information_gain_bits=information_gain_bits,
        median=qmat[0].tolist(), errlo=qmat[1].tolist(),
        errup=qmat[2].tolist())

    best = saved_logl.argmax()
    results = {
        'niter': len(saved_logl),
        'logz': main_iterator.logZ,
        'logzerr': logzerr_total,
        'logz_bs': logZ_bs.mean(),
        'logz_single': main_iterator.logZ,
        'logzerr_tail': logzerr_tail,
        'logzerr_bs': logzerr_bs,
        'ess': ess,
        'H': main_iterator.all_H[0],
        'Herr': main_iterator.all_H.std(),
        'posterior': posterior,
        'weighted_samples': {
            'upoints': saved_u, 'points': saved_v, 'weights': saved_wt0,
            'logw': saved_logwt0, 'bootstrapped_weights': saved_wt_bs,
            'logl': saved_logl},
        'samples': samples,
        'maximum_likelihood': {
            'logl': saved_logl[best],
            'point': saved_v[best, :].tolist(),
            'point_untransformed': saved_u[best, :].tolist()},
    }

    if getattr(main_iterator, 'check_insertion_order', False):
        results['insertion_order_MWW_test'] = dict(
            independent_iterations=main_iterator.insertion_order_runlength,
            converged=main_iterator.insertion_order_converged,
        )
    return results


def _sweep_tree_sequence(roots):
    """Collect the node-consumption sequence of a finished tree.

    One breadth-first sweep recording, per consumed node: value, pile id,
    number of children, root id, active-arc count, whether the active
    values were unique, the first child's insertion count (for the
    ``insert_order`` sequence) and each child's rank among the active
    values (for the MWW accumulator). This is the cheap first pass of the
    vectorized replay: all integrator math happens afterwards as closed-
    form array operations over the whole sequence at once.
    """
    explorer = BreadthFirstIterator(roots)
    Ls, ids, nch, rtid, nact = [], [], [], [], []
    cio, ranks = [], []
    last_values = None
    # The sorted active values are maintained incrementally: the BFS
    # consumes nodes in value order, so each step pops the sorted
    # array's head and re-inserts the child values. A per-node np.sort
    # over ~nlive values used to dominate this sweep (~30% of the
    # results-assembly time on a 45k-iteration run). `adjdups` counts
    # adjacent equal pairs, so uniqueness is O(1) per step.
    svals = np.sort(np.fromiter((r.value for r in roots), dtype=float,
                                count=len(roots))).tolist()
    adjdups = sum(svals[i] == svals[i + 1] for i in range(len(svals) - 1))
    while True:
        nx = explorer.next_node()
        if nx is None:
            break
        rootid, node, (_, _, active_values, _) = nx
        children = node.children
        n = len(active_values)
        assert svals[0] == node.value, (svals[0], node.value)
        is_unique = bool(n == 1 or adjdups == 0)
        Ls.append(node.value)
        ids.append(node.id)
        nch.append(len(children))
        rtid.append(rootid)
        nact.append(n)
        if is_unique and children:
            # (active > child0): strict-upper count for the sequence output
            cio.append(n - bisect.bisect_right(svals, children[0].value))
            # (active < child): strict-lower rank for the U-test
            ranks.append(tuple(
                bisect.bisect_left(svals, c.value) for c in children))
        else:
            cio.append(-1)
            ranks.append(())
        last_values = active_values
        # pop the consumed minimum, then insert the children
        if len(svals) > 1 and svals[1] == svals[0]:
            adjdups -= 1
        del svals[0]
        for c in children:
            pos = bisect.bisect_left(svals, c.value)
            left_eq = pos > 0 and svals[pos - 1] == c.value
            right_eq = pos < len(svals) and svals[pos] == c.value
            was_adj = pos > 0 and pos < len(svals) \
                and svals[pos - 1] == svals[pos]
            adjdups += int(left_eq) + int(right_eq) - int(was_adj)
            svals.insert(pos, c.value)
        explorer.expand_children_of(rootid, node)
    return (np.asarray(Ls), np.asarray(ids, dtype=np.int64),
            np.asarray(nch, dtype=np.int64), np.asarray(rtid, dtype=np.int64),
            np.asarray(nact, dtype=np.int64), np.asarray(cio, dtype=np.int64),
            ranks, last_values)


def _flatten_tree(roots):
    """Flatten the tree to parallel arrays, children contiguous.

    Nodes are numbered in processing order (roots first); the children
    of node *i* occupy indices ``first[i] .. first[i]+nch[i]-1``.  This
    is the one remaining python pass over the node objects before the
    native sweep takes over.
    """
    nodes = list(roots)
    values, pids, ncs, first = [], [], [], []
    i = 0
    while i < len(nodes):
        node = nodes[i]
        values.append(node.value)
        pids.append(node.id)
        children = node.children
        ncs.append(len(children))
        first.append(len(nodes))
        nodes.extend(children)
        i += 1
    return (np.asarray(values, dtype=float),
            np.asarray(pids, dtype=np.int64),
            np.asarray(ncs, dtype=np.int64),
            np.asarray(first, dtype=np.int64))


def _sweep_tree_native(roots, main_iterator):
    """Run the consume-min sweep in C, folding in the U-test.

    Returns the :func:`_sweep_tree_sequence` tuple with ``ranks=None``
    (the insertion-order accumulation already applied to
    *main_iterator*), or None when the native kernel is unavailable —
    the caller falls back to the python sweep.
    """
    from . import native
    if not native.available():
        return None
    mi = main_iterator
    if mi.check_insertion_order:
        acc = mi.insertion_order_accumulator
        thr = mi.insertion_order_threshold
        state = (acc.U, acc.N)
    else:
        acc, thr, state = None, 0.0, (0.0, 0)
    values, pids, ncs, first = _flatten_tree(roots)
    res = native.tree_sweep(values, pids, ncs, first, len(roots), thr,
                            rank_sum=state[0], rank_n=state[1])
    if res is None:
        return None
    (Ls, out_ids, out_nch, rtid, nact, cio, runs, rank_sum, rank_n,
     last_value) = res
    if acc is not None:
        mi.insertion_order_runs.extend(int(r) for r in runs)
        acc._rank_sum = rank_sum
        acc._n = rank_n
    return (Ls, out_ids, out_nch, rtid, nact, cio, None,
            np.array([last_value]))


def _accumulate_insertion_ranks(mi, ranks, nact):
    """Stream per-child insertion ranks through *mi*'s U-test."""
    acc = mi.insertion_order_accumulator
    thr = mi.insertion_order_threshold
    runs = mi.insertion_order_runs
    for rlist, n in zip(ranks, nact):
        for r in rlist:
            acc.add(r, n)
            if abs(acc.zscore) > thr:
                runs.append(len(acc))
                acc.reset()


def _replay_counters_native(Li, nchildren, rootid_seq, nact, rootmasks,
                            random, u_nl_mat, nonleaf_seq):
    """Run the whole-run counter recurrences in C (replay.c).

    Returns the native output tuple or None (library unavailable or
    bookkeeping check failed) — the caller falls back to the numpy
    matrix math.
    """
    from . import native
    if not native.available():
        return None
    nl_ord = np.cumsum(nonleaf_seq, dtype=np.int64) - 1
    u = None if u_nl_mat is None else np.ascontiguousarray(u_nl_mat)
    return native.replay_counters(
        np.ascontiguousarray(Li, dtype=float),
        np.ascontiguousarray(nchildren, dtype=np.int64),
        np.ascontiguousarray(rootid_seq, dtype=np.int64),
        np.ascontiguousarray(nact, dtype=np.int64),
        np.ascontiguousarray(rootmasks, dtype=np.uint8),
        int(bool(random)), u, nl_ord)


def _install_replay(mi, native_out, Li, node_ids, nchildren, nact, cio,
                    nonleaf_seq, last_values):
    """Install native replay results on *mi*; build the sequence tuple.

    Mirrors the state-installation tail of the numpy path in
    :func:`_replay_vectorized` exactly (same fields, same tail
    estimate from the final active values).
    """
    (logw, zprev, vol0prev, all_logZ, all_H, all_logVol,
     nlive_final) = native_out
    mi.logweights = logw
    mi.istail = ~nonleaf_seq
    mi.all_logZ = all_logZ
    mi.logZ = all_logZ[0]
    mi.all_H = all_H
    mi.all_logVolremaining = all_logVol
    mi.logVolremaining = all_logVol[0]
    if mi.all_H[0] > 0:
        mi.logZerr = (mi.all_H[0] / nact[-1]) ** 0.5
    mi._nlive = nlive_final
    if last_values is not None and len(last_values):
        Lmax = np.max(last_values)
        V = mi.all_logVolremaining - log(nact[-1])
        mi.all_logZremain = V + log(np.sum(exp(last_values - Lmax))) + Lmax
        mi.logZremainMax = mi.all_logZremain.max()
        mi.logZremain = mi.all_logZremain[0]
        with np.errstate(over='ignore', under='ignore'):
            mi.remainder_ratio = exp(mi.logZremain - mi.logZ)
            mi.remainder_fraction = 1.0 / (1 + exp(mi.logZ - mi.logZremain))
    logz_out = zprev[0]
    with np.errstate(invalid='ignore'):
        logzerr_out = np.std(zprev[1:], axis=0)
    insert_order = np.where(cio >= 0, 2 * (cio + 1.0) / nact, np.nan)
    return (Li, node_ids, logz_out, logzerr_out, vol0prev,
            nact.astype(np.int64), insert_order)


def _replay_vectorized(roots, main_iterator, rng=np.random):
    """Advance *main_iterator* over the whole finished tree in one shot.

    Equivalent to calling ``passing_node`` once per consumed node, but
    expressed as array math over the full iteration sequence:

    * per-counter live counts: cumulative sum of ``(nchildren-1)`` over
      the counter's active steps;
    * remaining log-volume: cumulative sum of the per-step shrinkage;
    * logZ: ``np.logaddexp.accumulate`` over the weighted likelihoods;
    * information H: the update is the linear recurrence
      ``H_t = a_t H_(t-1) + b_t`` with ``a_t = exp(logZ_(t-1) - logZ_t)``,
      solved in closed form as ``H_T = sum_t b_t * prod_(s>t) a_s`` with
      the product evaluated stably in log space.

    Returns the per-iteration sequence arrays
    ``(saved_logl, saved_nodeids, logz, logzerr, logvol, nlive,
    insert_order)`` (pre-update states, like the sequential replay).
    """
    swept = _sweep_tree_native(roots, main_iterator)
    if swept is None:
        swept = _sweep_tree_sequence(roots)
    (Li, node_ids, nchildren, rootid_seq, nact, cio, ranks,
     last_values) = swept
    T = len(Li)
    rootmasks = main_iterator.rootids
    nb1 = rootmasks.shape[0]
    nonleaf_seq = nchildren >= 1

    # randomized-shrinkage uniforms: one row per non-leaf step, drawn
    # up front so the native and numpy paths share the RNG stream
    if main_iterator.random:
        u_nl_mat = rng.random((int(nonleaf_seq.sum()), nb1))
    else:
        u_nl_mat = None

    native_out = _replay_counters_native(
        Li, nchildren, rootid_seq, nact, rootmasks,
        main_iterator.random, u_nl_mat, nonleaf_seq)
    if native_out is not None:
        if main_iterator.check_insertion_order and ranks is not None:
            # python sweep + native replay: the U-test accumulation
            # was not folded into the sweep, apply it here
            _accumulate_insertion_ranks(main_iterator, ranks, nact)
        return _install_replay(main_iterator, native_out, Li, node_ids,
                               nchildren, nact, cio, nonleaf_seq,
                               last_values)

    # layout: (counters, iterations) — cumulative ops run contiguous
    A = rootmasks[:, rootid_seq]                        # (nb1, T) active
    nonleaf = nonleaf_seq                               # (T,)
    dn = A * (nchildren - 1)
    nlive = np.cumsum(dn, axis=1)
    nlive += (rootmasks.sum(axis=1)[:, None] - dn)      # count BEFORE step
    nlive0 = nlive[0]
    assert np.array_equal(nlive0, nact), 'live-count bookkeeping diverged'
    nlive_safe = np.maximum(nlive, 1)
    inv_n = 1.0 / nlive_safe

    if main_iterator.random:
        # same stream as the sequential path: one uniform row per
        # non-leaf step (inverse-CDF Beta(1,N): x = 1 - u^(1/N), so
        # log(1-x) = log(u)/N), main-counter column deterministic
        lr_nl = np.log(u_nl_mat) / nlive_safe.T[nonleaf]
        lr_nl[:, 0] = -inv_n[0, nonleaf]
        logright = np.zeros((nb1, T))
        logright.T[nonleaf] = lr_nl
    else:
        logright = -inv_n
    with np.errstate(divide='ignore'):
        logleft = log1p(-exp(logright))

    mask_h = A & nonleaf[None, :]
    dvol = np.where(mask_h, logright, 0.0)
    leaf_idx = np.flatnonzero(~nonleaf)
    if len(leaf_idx):
        with np.errstate(divide='ignore'):
            dvol[:, leaf_idx] = np.where(
                A[:, leaf_idx], log1p(-inv_n[:, leaf_idx]), 0.0)
    logVol = np.cumsum(dvol, axis=1)
    # exclusive cumsum (state BEFORE each step); never undo dvol by
    # subtraction — a dying counter's last leaf contributes -inf
    logVolprev = np.empty_like(logVol)
    logVolprev[:, 0] = 0.0
    logVolprev[:, 1:] = logVol[:, :-1]

    with np.errstate(divide='ignore'):
        logwidth = np.where(
            mask_h, logleft + logVolprev,
            np.where(A, logVolprev - log(nlive_safe), -np.inf))
    wi = logwidth + Li[None, :]
    logZmat = np.logaddexp.accumulate(wi, axis=1)
    logZprev = np.empty_like(logZmat)
    logZprev[:, 0] = -np.inf
    logZprev[:, 1:] = logZmat[:, :-1]

    # --- H via the closed-form linear recurrence ---
    first = mask_h & np.isneginf(logZprev)
    with np.errstate(invalid='ignore', over='ignore', under='ignore'):
        expw = np.where(mask_h, np.exp(wi - logZmat), 0.0)
        alpha = np.where(mask_h & ~first,
                         np.exp(logZprev - logZmat), 0.0)
        beta = np.where(
            mask_h,
            expw * Li[None, :] + alpha * np.where(first, 0.0, logZprev)
            - logZmat, 0.0)
        logalpha = np.where(mask_h & ~first, logZprev - logZmat, 0.0)
        cum = np.cumsum(logalpha, axis=1)
        w = np.exp(cum[:, -1][:, None] - cum)
        started = np.cumsum(first, axis=1) >= 1
        all_H = np.sum(beta * np.where(started, w, 0.0), axis=1)
    all_H[~started[:, -1]] = np.nan

    # --- install final state on the iterator ---
    mi = main_iterator
    mi.logweights = np.ascontiguousarray(logwidth.T)
    mi.istail = ~nonleaf
    mi.all_logZ = logZmat[:, -1].copy()
    mi.logZ = mi.all_logZ[0]
    mi.all_H = all_H
    mi.all_logVolremaining = logVol[:, -1].copy()
    mi.logVolremaining = mi.all_logVolremaining[0]
    if mi.all_H[0] > 0:
        mi.logZerr = (mi.all_H[0] / nlive0[-1]) ** 0.5
    mi._nlive = nlive[:, -1] + (nchildren[-1] - 1) * A[:, -1]
    if last_values is not None and len(last_values):
        Lmax = np.max(last_values)
        V = mi.all_logVolremaining - log(nlive0[-1])
        mi.all_logZremain = V + log(np.sum(exp(last_values - Lmax))) + Lmax
        mi.logZremainMax = mi.all_logZremain.max()
        mi.logZremain = mi.all_logZremain[0]
        with np.errstate(over='ignore', under='ignore'):
            mi.remainder_ratio = exp(mi.logZremain - mi.logZ)
            mi.remainder_fraction = 1.0 / (1 + exp(mi.logZ - mi.logZremain))

    if mi.check_insertion_order and ranks is not None:
        # python sweep: apply the insertion-order accumulation here
        # (the native sweep already folded it in)
        _accumulate_insertion_ranks(mi, ranks, nact)

    logz_out = logZprev[0]
    with np.errstate(invalid='ignore'):
        logzerr_out = np.std(logZprev[1:], axis=0)
    logvol_out = logVolprev[0].copy()
    insert_order = np.where(cio >= 0, 2 * (cio + 1.0) / nact, np.nan)
    return (Li, node_ids, logz_out, logzerr_out, logvol_out,
            nact.astype(np.int64), insert_order)


def replay_sequence(root, pointpile, nbootstraps=12, random=True,
                    check_insertion_order=True):
    """Vectorized tree replay returning the per-iteration sequence only.

    Runs :func:`_replay_vectorized` through a fresh :class:`MultiCounter`
    and assembles the *sequence* dict (same contents as
    :func:`logz_sequence`'s first return value) without the full
    :func:`combine_results` posterior assembly — the sampler's results
    path (`integrator._update_results`) only needs the trace and the
    replay's insertion-order test, and already built the expensive
    results dict from the run's own iterator.

    Returns ``(sequence, main_iterator, saved_logl, saved_nodeids)``,
    or ``None`` when the tree is empty.
    """
    roots = root.children
    if not len(roots):
        return None
    main_iterator = MultiCounter(
        nroots=len(roots), nbootstraps=max(1, nbootstraps),
        random=random, check_insertion_order=check_insertion_order)
    main_iterator.Lmax = max(n.value for n in roots)
    (saved_logl, saved_nodeids, logz, logzerr, logvol, nlive,
     insert_order) = _replay_vectorized(roots, main_iterator)
    logwt = saved_logl + np.asarray(main_iterator.logweights)[:, 0]
    if len(logvol) > 1:
        logvol[-1] = logvol[-2]
    with np.errstate(over='ignore', under='ignore'):
        weights = exp(logwt - main_iterator.all_logZ[0])
    sequence = dict(
        logz=logz, logzerr=logzerr, logvol=logvol,
        samples_n=nlive, nlive=nlive,
        insert_order=insert_order, logwt=logwt, niter=len(saved_logl),
        logl=saved_logl,
        weights=weights,
        samples=pointpile.getp(saved_nodeids),
    )
    return sequence, main_iterator, saved_logl, saved_nodeids


def logz_sequence(root, pointpile, nbootstraps=12, random=True, onNode=None,
                  verbose=False, check_insertion_order=True):
    """Replay the tree under *root* through a fresh MultiCounter.

    Returns ``(sequence, results)`` where *sequence* holds per-iteration
    logz/logzerr/logvol/nlive/logwt/insert_order arrays and *results* is the
    :func:`combine_results` dictionary.

    When no per-node callback is requested the replay runs through
    :func:`_replay_vectorized` (identical math and RNG stream, whole-run
    array operations instead of a per-node python loop).
    """
    roots = root.children
    if onNode is None and not verbose and len(roots):
        sequence, main_iterator, saved_logl, saved_nodeids = \
            replay_sequence(root, pointpile, nbootstraps=nbootstraps,
                            random=random,
                            check_insertion_order=check_insertion_order)
        results = combine_results(
            saved_logl, saved_nodeids, pointpile, main_iterator)
        return sequence, results
    main_iterator = MultiCounter(
        nroots=len(roots), nbootstraps=max(1, nbootstraps), random=random,
        check_insertion_order=check_insertion_order)
    main_iterator.Lmax = max(n.value for n in roots)
    walker = BreadthFirstIterator(roots)

    # per-iteration trace columns (pre-update state, matching the
    # vectorized replay's convention)
    trace = dict(logz=[], logzerr=[], logvol=[], nlive=[],
                 insert_order=[])
    saved_nodeids, saved_logl = [], []

    while True:
        visit = walker.next_node()
        if visit is None:
            break
        rootid, node, (_, arc_roots, arc_values, _) = visit
        if onNode:
            onNode(node, main_iterator)

        nactive = len(arc_values)
        distinct = len(np.unique(arc_values)) == nactive
        if distinct and node.children:
            # normalized rank of the first child among the active values
            above = (arc_values > node.children[0].value).sum()
            rank_stat = 2 * (above + 1.0) / nactive
        else:
            rank_stat = np.nan

        trace['logz'].append(main_iterator.logZ)
        with np.errstate(invalid='ignore'):
            trace['logzerr'].append(main_iterator.logZerr_bs)
        trace['logvol'].append(main_iterator.logVolremaining)
        trace['nlive'].append(nactive)
        trace['insert_order'].append(rank_stat)
        saved_logl.append(node.value)
        saved_nodeids.append(node.id)
        if verbose:
            sys.stderr.write("%d...\r" % len(saved_logl))

        main_iterator.passing_node(rootid, node, arc_roots, arc_values)
        walker.expand_children_of(rootid, node)

    trace['logvol'][-1] = trace['logvol'][-2]
    results = combine_results(saved_logl, saved_nodeids, pointpile,
                              main_iterator)
    nlive_arr = np.asarray(trace['nlive'])
    sequence = dict(
        logz=np.asarray(trace['logz']),
        logzerr=np.asarray(trace['logzerr']),
        logvol=np.asarray(trace['logvol']),
        samples_n=nlive_arr,
        nlive=nlive_arr,
        insert_order=np.asarray(trace['insert_order']),
        logwt=np.asarray(saved_logl)
        + np.asarray(main_iterator.logweights)[:, 0],
        niter=len(saved_logl),
        logl=saved_logl,
        weights=results['weighted_samples']['weights'],
        samples=results['weighted_samples']['points'],
    )
    return sequence, results
