"""The plain reference: each problem's transform, likelihood and logZ
truth in float64 numpy, written from the published formulas, one module
a problem. Nothing here imports the port, JAX or the package the port
was made from.

Every formula takes a rounding function *r*, applied after each
operation: :func:`exact` (float64, the reference), or :func:`float32` and
:func:`bfloat16`, which compute the same formula in a lower precision
for the control.
"""

import numpy as np


def exact(x):
    """float64, as computed."""
    return np.asarray(x, dtype=np.float64)


def float32(x):
    """Round to float32 (nearest, ties to even), kept as float64."""
    return np.asarray(x, dtype=np.float64).astype(np.float32).astype(
        np.float64)


def bfloat16(x):
    """Round to bfloat16 (8 bits of mantissa; nearest, ties to even),
    kept as float64: float32 bits with the low 16 rounded away."""
    a = np.ascontiguousarray(np.asarray(x, dtype=np.float64).astype(
        np.float32))
    bits = a.view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    out = bits.astype(np.uint32).view(np.float32).astype(np.float64)
    return np.where(np.isfinite(a), out, a)


ROUNDINGS = {'float64': exact, 'float32': float32, 'bfloat16': bfloat16}
