"""Share of a fit's likelihood evaluations that a sequential walk would
have needed (``popfused.py``): 1 - (the step sampler's billed calls -
its useful ones) / the fit's ncall, pooled over the window's fits."""


def read(run):
    fits = [f for f in run.fits if 'ss_ncalls' in f]
    ncall = sum(f['ncall'] for f in fits)
    if not fits or ncall <= 0:
        return None
    waste = sum(f['ss_ncalls'] - f['ss_useful'] for f in fits)
    return 100.0 * (1.0 - waste / ncall)
