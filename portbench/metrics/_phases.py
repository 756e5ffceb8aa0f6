"""Seconds a fit of the port's ``_segment_phase_s`` phases."""


def per_fit(run, *phases):
    """The phases' seconds summed over the window's fits, over the number
    of fits; None where no fit booked any of them."""
    fits = run.fits
    if not fits or not any(p in f['phases'] for f in fits for p in phases):
        return None
    return sum(f['phases'].get(p, 0.0) for f in fits
               for p in phases) / len(fits)
