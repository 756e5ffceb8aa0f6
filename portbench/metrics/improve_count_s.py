"""Seconds a fit that the improvement passes' per-point iterations spend
advancing the tree's counters (``netiter.py``,
``MultiCounter.passing_node``): the port's ``improve/count`` part."""

from ._phases import per_fit


def read(run):
    return per_fit(run, 'improve/count')
