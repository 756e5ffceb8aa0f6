"""Seconds a fit that the improvement passes' per-point iterations spend
on the batches of candidates they ask of the card (``fused.py``, the
one-batch dispatch with K1): the port's ``improve/draw`` counter, the
dispatch, the wait and the copy back."""

from ._phases import per_fit


def read(run):
    return per_fit(run, 'improve/draw')
