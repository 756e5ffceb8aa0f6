"""Seconds a fit that the segment dispatch's host spends before its
device work (``popfused.py``, ``fused.py``): the port's ``launch``
parts ``banks`` (the walk's banks), ``load`` (the uploads and the
walk's set-up), ``geometry`` (the region's geometry and whitened live
points) and ``draw`` (the region path's candidates)."""

from ._phases import per_fit


def read(run):
    return per_fit(run, 'launch/banks', 'launch/load', 'launch/geometry',
                   'launch/draw')
