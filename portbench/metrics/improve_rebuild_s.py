"""Seconds a fit in the improvement passes' region rebuilds
(``mlfriends.py``, ``ops/bootstrap.py``, K2): the port's
``improve/rebuild`` span."""

from ._phases import per_fit


def read(run):
    return per_fit(run, 'improve/rebuild')
