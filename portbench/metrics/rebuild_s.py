"""Seconds a fit in region rebuilds (``mlfriends.py``,
``ops/bootstrap.py``, K2): the port's ``rebuild`` phase."""

from ._phases import per_fit


def read(run):
    return per_fit(run, 'rebuild')
