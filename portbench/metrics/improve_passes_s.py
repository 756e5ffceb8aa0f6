"""Seconds a fit in the passes after the first (``integrator.py``
``run_iter``): the port's ``passes`` clock, from the start of the second
pass to the end of the last pass's plan, with the segment visits at the
widened width, the per-point iterations, their rebuilds and the plans."""

from ._phases import per_fit


def read(run):
    return per_fit(run, 'passes')
