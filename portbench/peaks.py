"""Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's
data sheet, dense): float32 outside the tensor cores and HBM3
bandwidth. A card set below 700 W runs slower; the result line gives the
card's limit beside every share of these."""

F32_OPS_PER_S = 67e12
BYTES_PER_S = 3.35e12


def bound_s(ops, nbytes):
    """The least seconds the card could take for *ops* float32
    operations and *nbytes* bytes, each read or written once."""
    return max(ops / F32_OPS_PER_S, nbytes / BYTES_PER_S)
