"""Seconds a fit the host spends replaying accepted points into the tree
and building the results (``integrator.py``, ``netiter.py``): the
port's ``replay`` and ``results`` phases."""

from ._phases import per_fit


def read(run):
    return per_fit(run, 'replay', 'results')
