"""Seconds a fit that the host blocked waiting for the card
(``parallel/launch.py``, ``wait_ready``): every ``*/wait`` key of the
port's ``_segment_phase_s`` (``fetch/wait``, ``launch/wait`` of the
walks' flag reads, ``classic/wait``, ...), summed over the window's
fits, over the fits."""


def read(run):
    fits = run.fits
    if not any(k.endswith('/wait') for f in fits for k in f['phases']):
        return None
    return sum(v for f in fits for k, v in f['phases'].items()
               if k.endswith('/wait')) / len(fits)
