"""Seconds a fit that the improvement passes' per-point iterations spend
on the points they ask of the population walk (``popfused.py``
``FusedPopulationSliceSampler.__next__``): the port's ``improve/walk``
counter, the walk's launch, the harvest with its float64 re-evaluation
and the waits."""

from ._phases import per_fit


def read(run):
    return per_fit(run, 'improve/walk')
