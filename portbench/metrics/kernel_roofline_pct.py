"""The port's hand kernels (``csrc/*.cu`` through ``ops/kernels.py``)
against their bounds: the sum of each call's bound (``bounds/*.py``,
from the call's own arguments) over the sum of their device time in the
traced window, over the kernels that have a bound."""


def read(run):
    if run.trace is None:
        return None
    ks = [k for k in run.trace.kernels.values()
          if k['bound_s'] is not None and k['device_s'] > 0]
    dev = sum(k['device_s'] for k in ks)
    if dev <= 0:
        return None
    return 100.0 * sum(k['bound_s'] for k in ks) / dev
