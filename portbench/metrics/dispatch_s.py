"""Seconds a fit in segment dispatch (``fused.py``, ``popfused.py``,
``segmentops.py``): the port's ``launch`` (host enqueue) and ``fetch``
(waiting on the device and the copy back) phases."""

from ._phases import per_fit


def read(run):
    return per_fit(run, 'launch', 'fetch')
