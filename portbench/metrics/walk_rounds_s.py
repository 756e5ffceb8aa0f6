"""Seconds a fit that the segment dispatch's host spends driving the
population walk's rounds (``popfused.py``, ``_drive_rounds``): the
port's ``launch/rounds`` part, the graph replays or the host loop, the
launch counts and the flag's copies and reads, less their waits."""

from ._phases import per_fit


def read(run):
    return per_fit(run, 'launch/rounds')
