"""Seconds a fit that the improvement passes' per-point iterations spend
in the reactive strategy's advice (``integrator.py``,
``_adaptive_strategy_advice``): the port's ``improve/advice`` part."""

from ._phases import per_fit


def read(run):
    return per_fit(run, 'improve/advice')
