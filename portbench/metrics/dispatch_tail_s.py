"""Seconds a fit that the segment dispatch's host spends after the walk
or the filter (``popfused.py``, ``fused.py``, ``segmentops.py``): the
port's ``launch/tail`` part, the records' compaction, K3, the pack and
``start_fetch``."""

from ._phases import per_fit


def read(run):
    return per_fit(run, 'launch/tail')
