# noqa: D400 D205
"""
Live visualisation of nested sampling runs
------------------------------------------

Terminal / Jupyter live views of the current live points: per-parameter
spans with cluster membership indicators (cf. reference
`ultranest/viz.py`).
"""

import sys

import numpy as np

__all__ = ['round_parameterlimits', 'nicelogger', 'isnotebook',
           'LivePointsWidget', 'get_default_viz_callback']

clusteridstrings = ['%d' % i for i in range(10)] + \
    [chr(i) for i in range(ord('A'), ord('Z') + 1)] + \
    [chr(i) for i in range(ord('a'), ord('z') + 1)]

spearman = None


def round_parameterlimits(plo, phi, paramlimitguess=None):
    """Guess plot limits based on parameter ranges.

    Parameters
    ----------
    plo: array of floats
        lower parameter values
    phi: array of floats
        upper parameter values
    paramlimitguess: array of float 2-tuples
        hard parameter limits, if known

    Returns
    -------
    plo_rounded, phi_rounded, formats
    """
    with np.errstate(divide='ignore', invalid='ignore'):
        expos = np.log10(np.abs([plo, phi]))
    expolo = np.floor(np.min(expos, axis=0))
    expohi = np.ceil(np.max(expos, axis=0))
    is_negative = plo < 0
    plo_rounded = np.where(is_negative, -10**expohi, 10**expolo)
    phi_rounded = np.where(is_negative, 10**expohi, 10**expohi)
    plo_rounded = np.where(np.isfinite(plo_rounded), plo_rounded, plo)
    phi_rounded = np.where(np.isfinite(phi_rounded), phi_rounded, phi)

    if paramlimitguess is not None:
        for i, (lo, hi) in enumerate(paramlimitguess):
            # if the limits look rounder, use them
            if lo <= plo[i] and hi >= phi[i]:
                plo_rounded[i] = lo
                phi_rounded[i] = hi

    formats = []
    for lo, hi in zip(plo_rounded, phi_rounded):
        fmt = '%+.1e'
        if np.all(np.isfinite([lo, hi])):
            span = hi - lo
            if span > 0 and 1e-3 < max(abs(lo), abs(hi)) < 1e5:
                digits = max(0, int(np.ceil(-np.log10(span))) + 1)
                fmt = '%%+.%df' % min(digits, 6)
        formats.append(fmt)
    return plo_rounded, phi_rounded, formats


def nicelogger(points, info, region, transformLayer, region_fresh=False):
    """Log the live point distribution as per-parameter text span bars.

    Parameters
    ----------
    points: dict with "u", "p", "logl"
        live points
    info: dict
        integration state (logz, logz_remain, paramnames, ...)
    region, transformLayer:
        current region and whitening layer
    region_fresh: bool
        whether the region was just rebuilt
    """
    p = points['p']
    paramnames = info['paramnames']
    plo = p.min(axis=0)
    phi = p.max(axis=0)
    plo_rounded, phi_rounded, paramformats = round_parameterlimits(
        plo, phi, paramlimitguess=info.get('paramlims'))

    if 'logz' in info:
        sys.stdout.write('logZ = %.2f, remainder logZ = %.2f\n' % (
            info['logz'], info['logz_remain']))

    clusterids = getattr(transformLayer, 'clusterids', None)
    if clusterids is None:
        clusterids = np.ones(len(p), dtype=int)

    width = 60
    for i, param in enumerate(paramnames):
        if plo_rounded[i] == phi_rounded[i]:
            line = '*' * width
        else:
            line = [' '] * width
            span = phi_rounded[i] - plo_rounded[i]
            for j, ci in zip(p[:, i], clusterids):
                k = int((j - plo_rounded[i]) * (width - 1) / span)
                k = min(max(k, 0), width - 1)
                if line[k] == ' ' or line[k] == clusteridstrings[
                        min(ci, len(clusteridstrings) - 1)]:
                    line[k] = clusteridstrings[min(ci, len(clusteridstrings) - 1)]
                else:
                    line[k] = '*'
            line = ''.join(line)
        fmt = paramformats[i]
        sys.stdout.write(('%-20s: ' + fmt + '|%s|' + fmt + '\n') % (
            param[:20], plo_rounded[i], line, phi_rounded[i]))
    sys.stdout.flush()


def isnotebook():
    """Check whether we are running inside a Jupyter notebook."""
    try:
        shell = get_ipython().__class__.__name__  # noqa: F821
        return shell == 'ZMQInteractiveShell'
    except NameError:
        return False


class LivePointsWidget:
    """Jupyter notebook widget showing live points per parameter."""

    def __init__(self):
        """Initialise (lazy: widgets are built on first call)."""
        self.grid = None
        self.label = None

    def initialize(self, paramnames, width):
        """Build the ipywidgets grid for *paramnames*."""
        from ipywidgets import HTML, GridspecLayout, Layout
        from IPython.display import display

        grid = GridspecLayout(len(paramnames), 2,
                              layout=Layout(width='100%'))
        for i, param in enumerate(paramnames):
            grid[i, 0] = HTML(param)
            grid[i, 1] = HTML('...')
        self.label = HTML()
        display(self.label)
        display(grid)
        self.grid = grid

    def __call__(self, points, info, region, transformLayer, region_fresh=False):
        """Update the widget with the current live points."""
        paramnames = info['paramnames']
        if self.grid is None:
            self.initialize(paramnames, width=50)
        p = points['p']
        plo = p.min(axis=0)
        phi = p.max(axis=0)
        if 'logz' in info:
            self.label.value = 'logZ = %.2f, remainder logZ = %.2f' % (
                info['logz'], info['logz_remain'])
        for i in range(len(paramnames)):
            self.grid[i, 1].value = '%.4g ... %.4g' % (plo[i], phi[i])


def get_default_viz_callback():
    """Return the default visualisation callback for this environment."""
    if isnotebook():
        return LivePointsWidget()
    return nicelogger
