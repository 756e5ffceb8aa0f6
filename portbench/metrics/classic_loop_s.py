"""Seconds a fit of ``run()``'s work outside the segment loop and the
results (``integrator.py``): the port's ``prepare`` (the first live
points through the first region), ``classic`` (the per-point
iterations, their region rebuilds included) and ``plan`` spans."""

from ._phases import per_fit


def read(run):
    return per_fit(run, 'prepare', 'classic', 'plan')
