"""Share of the improvement passes' harvested walk points that enter the
tree (``popfused.py``, ``integrator.py`` ``_create_point``): 100 x the
port's ``improve/walk/taken`` count over its ``improve/walk/harvested``
count (walkers that finished above their dispatch's threshold), pooled
over the window's fits."""


def read(run):
    fits = run.fits
    harvested = sum(f['phases'].get('improve/walk/harvested#', 0)
                    for f in fits)
    if harvested <= 0:
        return None
    taken = sum(f['phases'].get('improve/walk/taken#', 0) for f in fits)
    return 100.0 * taken / harvested
