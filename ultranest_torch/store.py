# noqa: D400 D205
"""
Point storage for checkpointing and resume
------------------------------------------

Append-only log of every evaluated point, as rows
``[Lmin, L, quality, u..., p...]``. Resuming replays rows via
:meth:`PointStore.pop`: the first stored row with
``row_Lmin <= Lmin < L`` substitutes a likelihood evaluation — the exact
matching rule resume correctness depends on (cf. reference
`ultranest/store.py:75-106`).

The replay queue is held as numpy arrays with a consumed mask, so each
``pop`` is one vectorized scan instead of a python loop over tuples.

Backends: HDF5 (recommended), text (tsv/csv), or null.
"""

import os
import warnings

import numpy as np

__all__ = ['NullPointStore', 'TextPointStore', 'HDF5PointStore']


class PointStore:
    """Common row bookkeeping and the vectorized replay queue."""

    def __init__(self, ncols):
        """Track rows of *ncols* columns."""
        self.ncols = int(ncols)
        self.nrows = 0
        self.ncalls = 0
        self._set_replay(np.empty((0, self.ncols)))

    def _set_replay(self, rows):
        """Install previously stored rows as the replay queue."""
        self._replay = np.asarray(rows, dtype=float)
        self._alive = np.ones(len(self._replay), dtype=bool)
        self.stack_empty = not self._alive.any()

    def _check_width(self, row):
        if len(row) != self.ncols:
            raise ValueError("expected %d values, got %d in %s"
                             % (self.ncols, len(row), row))

    def reset(self):
        """Refresh the stack-empty flag (remaining rows stay replayable)."""
        self.stack_empty = not self._alive.any()

    @property
    def stack(self):
        """Remaining replayable rows, as ``(original_index, row)`` pairs."""
        return [(int(i), self._replay[i])
                for i in np.flatnonzero(self._alive)]

    def close(self):
        """Release resources (backend hook)."""
        pass

    def flush(self):
        """Persist pending writes (backend hook)."""
        pass

    def pop(self, Lmin):
        """Replay the first unconsumed row with ``row_Lmin <= Lmin < L``.

        Returns ``(original_row_index, row)`` or ``(None, None)``.
        """
        if not self.stack_empty:
            ok = self._alive & (self._replay[:, 0] <= Lmin) \
                & (self._replay[:, 1] > Lmin)
            hits = np.flatnonzero(ok)
            if len(hits):
                i = hits[0]
                self._alive[i] = False
                self.stack_empty = not self._alive.any()
                return int(i), self._replay[i]
            self.stack_empty = not self._alive.any()
        return None, None

    def add(self, row, ncalls):
        r"""Append ``row = [Lmin, L, \*otherinfo]``; returns its index."""
        self._check_width(row)
        self._write_row(row)
        self.nrows += 1
        self.ncalls = ncalls
        return self.nrows - 1

    def add_many(self, rows, ncalls):
        """Append a whole (n, ncols) block of rows in one backend write.

        Used by the segment engine, which logs hundreds of consumed
        points per device dispatch; per-row appends (one HDF5 dataset
        resize each) would dominate the replay time.
        """
        rows = np.asarray(rows, dtype=float)
        if rows.size == 0:
            return
        self._check_width(rows[0])
        self._write_rows(rows)
        self.nrows += len(rows)
        self.ncalls = ncalls

    def _write_rows(self, rows):
        for row in rows:
            self._write_row(row)

    def _write_row(self, row):
        raise NotImplementedError()


class NullPointStore(PointStore):
    """No storage; counts rows only."""

    def _write_row(self, row):
        pass

    def _check_width(self, row):
        pass

    def pop(self, Lmin):
        """Return no point (None, None)."""
        return None, None


class TextPointStore(PointStore):
    """Tab/comma separated text file storage.

    The ``fmt`` and ``delimiter`` attributes control the output format.
    """

    def __init__(self, filepath, ncols):
        """Load and append to storage at *filepath* with *ncols* columns."""
        PointStore.__init__(self, ncols)
        self.fmt = '%.18e'
        self.delimiter = '\t'
        rows = []
        if os.path.exists(filepath):
            try:
                with open(filepath) as f:
                    for line in f:
                        try:
                            vals = [float(v) for v in line.split()]
                        except ValueError:
                            warnings.warn(
                                "skipping unparsable line in '%s'"
                                % filepath, stacklevel=2)
                            continue
                        if len(vals) != self.ncols:
                            warnings.warn(
                                "skipping lines in '%s' with different "
                                "number of columns" % filepath,
                                stacklevel=2)
                            continue
                        rows.append(vals)
            except IOError:
                pass
        if rows:
            self._set_replay(np.asarray(rows))
        self.ncalls = len(rows)
        self.fileobj = open(filepath, 'ab')  # noqa: SIM115

    def close(self):
        """Close the text file."""
        self.fileobj.close()

    def flush(self):
        """Flush buffered rows to disk."""
        self.fileobj.flush()

    def _write_row(self, row):
        np.savetxt(self.fileobj, [row], fmt=self.fmt,
                   delimiter=self.delimiter)

    def _write_rows(self, rows):
        np.savetxt(self.fileobj, rows, fmt=self.fmt,
                   delimiter=self.delimiter)


class HDF5PointStore(PointStore):
    """HDF5-backed storage: a growing ``points`` dataset + ``ncalls`` attr."""

    FILES_OPENED = []

    def __init__(self, filepath, ncols, **h5_file_args):
        """Load and append to storage at *filepath* with *ncols* columns.

        Extra kwargs are passed to ``h5py.File``. Re-opening a path already
        held open in this process closes the stale handle first (guards
        against stale notebook state).
        """
        import h5py
        PointStore.__init__(self, ncols)
        h5_file_args.setdefault('mode', 'a')
        still_open = HDF5PointStore.FILES_OPENED
        for i, (path2, fileobj2) in enumerate(still_open):
            if filepath == path2:
                fileobj2.close()
                still_open.pop(i)
                break
        self.fileobj = h5py.File(filepath, **h5_file_args)
        still_open.append((filepath, self.fileobj))

        if 'points' not in self.fileobj:
            self.fileobj.create_dataset(
                'points', dtype=float,
                shape=(0, self.ncols), maxshape=(None, self.ncols))
        self._dataset = self.fileobj['points']
        self.nrows, stored_ncols = self._dataset.shape
        if stored_ncols != self.ncols:
            raise IOError(
                "Tried to resume from file '%s', which has a different "
                "number of columns!" % self.fileobj)
        self._set_replay(self._dataset[:])
        self.ncalls = int(self.fileobj.attrs.get('ncalls', self.nrows))

    def close(self):
        """Close the HDF5 file."""
        self.fileobj.close()

    def flush(self):
        """Flush the HDF5 file."""
        self.fileobj.flush()

    def _write_row(self, row):
        self._dataset.resize(self.nrows + 1, axis=0)
        self._dataset[self.nrows, :] = row

    def _write_rows(self, rows):
        self._dataset.resize(self.nrows + len(rows), axis=0)
        self._dataset[self.nrows:self.nrows + len(rows), :] = rows

    def add(self, row, ncalls):
        r"""Append ``row = [Lmin, L, \*otherinfo]``; updates ``ncalls``."""
        out = PointStore.add(self, row, ncalls)
        if self.fileobj.attrs.get('ncalls') != ncalls:
            self.fileobj.attrs['ncalls'] = ncalls
        return out

    def add_many(self, rows, ncalls):
        """Bulk append; updates the ``ncalls`` attribute once."""
        PointStore.add_many(self, rows, ncalls)
        if self.fileobj.attrs.get('ncalls') != ncalls:
            self.fileobj.attrs['ncalls'] = ncalls
