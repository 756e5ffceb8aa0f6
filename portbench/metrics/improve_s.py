"""Seconds a fit in the improvement passes (``integrator.py``): the
port's ``improve`` span, each unbroken run of the per-point iterations in
a pass after the first, with their region rebuilds and candidate
batches."""

from ._phases import per_fit


def read(run):
    return per_fit(run, 'improve')
