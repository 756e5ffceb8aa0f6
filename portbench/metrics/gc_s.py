"""Seconds a fit in Python's garbage collector during ``run()``: the
port's ``gc`` counter, which it keeps while torch's profiler records
(``ultranest_torch/tracing.py``)."""

from ._phases import per_fit


def read(run):
    return per_fit(run, 'gc')
