"""Faults planted in the timed path, each of which has to make a run's
``correct`` false: the checks of ``check.py`` are shown to catch them.

Each wraps K3 (``kernels.consume_scan``), which every cell's dispatches
run: an answer altered where it is produced (the worst live slot of each
accepted row moved on by one), half of the batch left out with the mean
of the rest in its place (every other row's likelihood replaced by the
mean of the others'), and a step that returns its state unchanged (the
live likelihoods handed back as they came). The cells run on one card,
so no exchange between chips can be left out.
"""

import time


def _alter(orig):
    import torch

    def call(live_L, rows_L, rows_valid):
        live2, recs = orig(live_L, rows_L, rows_valid)
        nlive = int(torch.isfinite(live_L).sum())
        recs = recs.clone()
        acc = recs[:, 0] > 0.5
        recs[acc, 1] = (recs[acc, 1] + 1) % nlive
        return live2, recs
    return call


def _half(orig):
    def call(live_L, rows_L, rows_valid):
        rows_L = rows_L.clone()
        kept = rows_valid[0::2] > 0.5
        if kept.any():
            rows_L[1::2] = rows_L[0::2][kept].mean()
        return orig(live_L, rows_L, rows_valid)
    return call


def _unchanged(orig):
    def call(live_L, rows_L, rows_valid):
        _, recs = orig(live_L, rows_L, rows_valid)
        return live_L.clone(), recs
    return call


FAULTS = {'answer_altered': _alter, 'half_left_out': _half,
          'state_unchanged': _unchanged}


class FitTooLong(RuntimeError):
    """A fit under a fault ran past its deadline: it gives no number."""


def planted(name, deadline_s=None):
    """A context that replaces ``kernels.consume_scan`` by fault *name*
    and restores it; with *deadline_s*, a call made later than that many
    seconds after entering raises :class:`FitTooLong`, so that a fault
    that keeps a fit from ending cannot hold the run."""
    import contextlib

    from ultranest_torch.ops import kernels

    @contextlib.contextmanager
    def ctx():
        orig = kernels.consume_scan
        broken = FAULTS[name](orig)
        t0 = time.perf_counter()

        def call(*args):
            if deadline_s is not None and \
                    time.perf_counter() - t0 > deadline_s:
                raise FitTooLong('%s: past %.0f s' % (name, deadline_s))
            return broken(*args)
        kernels.consume_scan = call
        try:
            yield
        finally:
            kernels.consume_scan = orig
    return ctx()
