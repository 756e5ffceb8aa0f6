# noqa: D400 D205
"""
Publication plots
-----------------

Corner plots, run diagnostic plots and trace plots (dynesty-style) for
nested sampling results, plus highest-density intervals and prediction
bands. The port's own copy of the reference package's ``plot.py``: host
only, numpy and matplotlib. The corner plot uses the ``corner`` package
when installed and falls back to a self-contained matplotlib
implementation otherwise.
"""

import numpy as np

from .utils import quantile as _quantile

__all__ = ['cornerplot', 'highest_density_interval_from_samples',
           'PredictionBand', 'runplot', 'traceplot']


def _weighted_quantile(x, q, weights):
    return np.array(_quantile(x, q, weights=weights))


def _corner_fallback(data, weights, labels, levels, quantiles, color,
                     show_titles):
    """Self-contained corner plot: weighted 1-d/2-d marginals + contours."""
    import matplotlib.pyplot as plt

    ndim = data.shape[1]
    fig, axes = plt.subplots(ndim, ndim,
                             figsize=(2.2 * ndim + 1, 2.2 * ndim + 1),
                             squeeze=False)
    lims = [(data[:, i].min(), data[:, i].max()) for i in range(ndim)]
    for i in range(ndim):
        for j in range(ndim):
            ax = axes[i][j]
            if j > i:
                ax.set_axis_off()
                continue
            if i == j:
                H, edges = np.histogram(data[:, i], bins=40,
                                        weights=weights, density=True)
                ax.stairs(H, edges, color=color, fill=False)
                for q in quantiles:
                    ax.axvline(_weighted_quantile(data[:, i], [q], weights)[0],
                               linestyle='--', color=color, lw=1)
                if show_titles:
                    lo, mid, hi = _weighted_quantile(
                        data[:, i], [quantiles[0], 0.5, quantiles[-1]],
                        weights)
                    ax.set_title(r'%s = $%.3g^{+%.2g}_{-%.2g}$'
                                 % (labels[i], mid, hi - mid, mid - lo),
                                 fontsize=9)
                ax.set_yticks([])
            else:
                H, xe, ye = np.histogram2d(
                    data[:, j], data[:, i], bins=32, weights=weights)
                Hs = H.T
                # credible-level contours from the sorted histogram mass
                sorted_h = np.sort(Hs.ravel())[::-1]
                cum = np.cumsum(sorted_h)
                cum /= cum[-1]
                contour_levels = []
                for lev in sorted(levels):
                    k = np.searchsorted(cum, lev)
                    contour_levels.append(
                        sorted_h[min(k, len(sorted_h) - 1)])
                contour_levels = sorted(set(contour_levels))
                xc = 0.5 * (xe[1:] + xe[:-1])
                yc = 0.5 * (ye[1:] + ye[:-1])
                ax.contourf(xc, yc, Hs,
                            levels=contour_levels + [Hs.max() + 1e-300],
                            colors=[color], alpha=0.3)
                ax.contour(xc, yc, Hs, levels=contour_levels,
                           colors=[color], linewidths=1)
                ax.set_xlim(lims[j])
                ax.set_ylim(lims[i])
            if i == ndim - 1:
                ax.set_xlabel(labels[j])
            else:
                ax.set_xticklabels([])
            if j == 0 and i > 0:
                ax.set_ylabel(labels[i])
            elif i != j:
                ax.set_yticklabels([])
    fig.subplots_adjust(hspace=0.08, wspace=0.08)
    return fig


def cornerplot(results, min_weight=1e-4, with_legend=True, logger=None,
               levels=[0.9973, 0.9545, 0.6827, 0.3934],
               plot_datapoints=False, plot_density=False, show_titles=True,
               quiet=True,
               contour_kwargs=dict(linestyles=['-', '-.', ':', '--'],
                                   colors=['navy', 'navy', 'navy', 'purple']),
               color='purple', quantiles=[0.15866, 0.5, 0.8413],
               **corner_kwargs):
    """Make a corner plot of the weighted posterior samples.

    Parameters
    ----------
    results: dict
        results dictionary (needs paramnames and weighted_samples)
    min_weight: float
        cut off low-weight posterior points
    with_legend: bool
        add a legend for the credible levels (corner backend only)
    logger: None or logger
        warning output when the posterior is degenerate
    levels: list
        credible interval levels for the 2-d contours
    plot_datapoints, plot_density, show_titles, quiet, contour_kwargs,
    color, quantiles, corner_kwargs:
        forwarded to ``corner.corner`` when available

    Returns
    -------
    fig: matplotlib figure
    """
    paramnames = results['paramnames']
    ws = results['weighted_samples']
    data = np.asarray(ws['points'])
    weights = np.asarray(ws['weights'])
    mask = np.cumsum(weights) > min_weight

    if mask.sum() == 1:
        if logger is not None:
            lines = ['Posterior is still concentrated in a single point:']
            lines += ['    %-20s: %s' % (p, results['samples'][mask, i])
                      for i, p in enumerate(paramnames)]
            logger.warning('\n'.join(lines))
            logger.info('Try running longer.')
        return None

    try:
        import corner
        import logging
        import matplotlib.pyplot as plt
        oldfunc = logging.warning
        logging.warning = lambda *args, **kwargs: None
        fig = corner.corner(
            data[mask, :], weights=weights[mask],
            labels=paramnames, show_titles=show_titles, quiet=quiet,
            plot_datapoints=plot_datapoints, plot_density=plot_density,
            levels=levels, quantiles=quantiles,
            contour_kwargs=contour_kwargs, color=color, **corner_kwargs)
        if with_legend and data.shape[1] > 1:
            legend_handles = [plt.Line2D(
                [0], [0], linestyle='--', color=color,
                label='%.1f%% marginal' % (100 * (quantiles[-1] - quantiles[0])))]
            legend_handles += [plt.Line2D(
                [0], [0], linestyle=ls, color=linecolor,
                label='%.1f%%' % (100 * level))
                for ls, linecolor, level in zip(
                    contour_kwargs.get('linestyles', [])[::-1],
                    contour_kwargs.get('colors', [color] * 100)[::-1],
                    levels[::-1])]
            if len(legend_handles) == len(levels) + 1:
                plt.legend(title='credible prob level',
                           handles=legend_handles, loc='lower right',
                           bbox_to_anchor=(1.01, 1.2), frameon=False)
        logging.warning = oldfunc
        return fig
    except ImportError:
        return _corner_fallback(data[mask, :], weights[mask], paramnames,
                                levels, quantiles, color, show_titles)


def highest_density_interval_from_samples(xsamples, xlo=None, xhi=None,
                                          probability_level=0.68):
    """Smallest interval containing *probability_level* of the samples.

    Parameters
    ----------
    xsamples: array
        samples (equally weighted)
    xlo, xhi: float or None
        optional hard bounds; when the HDI touches a bound, the bound is
        returned for that side
    probability_level: float
        credible mass

    Returns
    -------
    (lo, hi): tuple of floats
    """
    xsorted = np.sort(np.asarray(xsamples))
    n = len(xsorted)
    ninterval = max(1, int(np.ceil(probability_level * n)))
    if ninterval >= n:
        lo, hi = xsorted[0], xsorted[-1]
    else:
        widths = xsorted[ninterval:] - xsorted[:n - ninterval]
        j = np.argmin(widths)
        lo, hi = xsorted[j], xsorted[j + ninterval]
    if xlo is not None and lo <= xsorted[0]:
        lo = xlo
    if xhi is not None and hi >= xsorted[-1]:
        hi = xhi
    return lo, hi


class PredictionBand:
    """Plot uncertainty bands of model predictions over a x-grid.

    Call :meth:`add` with one curve per posterior sample, then
    :meth:`shade` / :meth:`line` to draw quantile bands and the median.
    """

    def __init__(self, x, shadeargs={}, lineargs={}):
        """Initialise over grid *x*."""
        self.x = x
        self.ys = []
        self.shadeargs = dict(shadeargs)
        self.lineargs = dict(lineargs)

    def add(self, y):
        """Add a curve (one prediction per posterior sample)."""
        self.ys.append(y)

    def set_shadeargs(self, **kwargs):
        """Set the default shading arguments."""
        self.shadeargs = kwargs

    def set_lineargs(self, **kwargs):
        """Set the default line arguments."""
        self.lineargs = kwargs

    def get_line(self, q=0.5):
        """Over the x-grid, get the quantile *q* of the predictions."""
        assert 0 <= q <= 1
        return np.percentile(self.ys, 100.0 * q, axis=0)

    def shade(self, q=0.341, ax=None, **kwargs):
        """Shade the symmetric quantile region (0.5-q, 0.5+q)."""
        import matplotlib.pyplot as plt
        assert 0 <= q <= 0.5
        band_lo, band_hi = self.get_line(0.5 - q), self.get_line(0.5 + q)
        return (ax or plt).fill_between(
            self.x, band_lo, band_hi, **{**self.shadeargs, **kwargs})

    def line(self, ax=None, **kwargs):
        """Plot the median prediction."""
        import matplotlib.pyplot as plt
        lineargs = dict(self.lineargs)
        lineargs.update(kwargs)
        if ax is None:
            ax = plt
        return ax.plot(self.x, self.get_line(0.5), **lineargs)


def runplot(results, span=None, logplot=False, kde=True, nkde=1000,
            color='blue', plot_kwargs=None, label_kwargs=None,
            lnz_error=True, lnz_truth=None, truth_color='red',
            truth_kwargs=None, max_x_ticks=8, max_y_ticks=3,
            use_math_text=True, mark_final_live=True, fig=None, **kwargs):
    """Plot the run evolution: nlive, likelihood, weights and evidence.

    API-compatible with UltraNest's ``plot.runplot``, including the axis
    option surface (`label_kwargs`, `max_x_ticks`/`max_y_ticks` with 0
    meaning no ticks, `use_math_text`, `mark_final_live`).

    Parameters
    ----------
    results: dict
        run sequence (logvol, nlive/samples_n, logl, logwt, logz, logzerr)
    span: list or None
        optional per-panel (ymin, ymax) ranges
    logplot: bool
        show the evidence panel on a log scale
    kde: bool
        smooth the importance-weight panel with a gaussian kernel density
        estimate over log-volume (instead of the raw per-point weights)
    nkde: int
        number of grid points for the KDE curve
    color: str
        line color
    plot_kwargs: dict or None
        extra keyword arguments for the line plots
    lnz_error: bool
        shade 1/2/3-sigma ln(Z) uncertainty bands
    lnz_truth: float or None
        reference evidence value overplotted on the evidence panel
    truth_color: str
        color for the ``lnz_truth`` line
    truth_kwargs: dict or None
        extra keyword arguments for the truth line
    fig: (figure, axes) or None
        existing figure/axes to draw into

    Returns
    -------
    fig, axes: matplotlib figure and axes
    """
    import matplotlib.pyplot as plt

    plot_kwargs = dict(plot_kwargs or {})
    plot_kwargs.update(kwargs)
    truth_kwargs = dict(truth_kwargs or {})
    label_kwargs = dict(label_kwargs or {})

    logvol = np.asarray(results['logvol'])
    logl = np.asarray(results['logl'])
    logwt = np.asarray(results['logwt'])
    logz = np.asarray(results['logz'])
    logzerr = np.asarray(results.get('logzerr', np.zeros_like(logz)))
    nlive = np.asarray(results.get('samples_n', results.get('nlive')))

    if fig is None:
        fig, axes = plt.subplots(4, 1, figsize=(10, 10), sharex=True)
    else:
        fig, axes = fig
    x = -logvol

    axes[0].plot(x, nlive, color=color, **plot_kwargs)
    axes[0].set_ylabel('Live points')

    rell = np.exp(logl - logl.max())
    axes[1].plot(x, rell, color=color, **plot_kwargs)
    axes[1].set_ylabel('Likelihood\n(relative)')

    if kde and len(x) > 3:
        # weight density over -ln X: gaussian KDE of the sample positions
        # weighted by importance weight, evaluated on an nkde grid
        wt = np.exp(logwt - logwt.max())
        wt = wt / wt.sum()
        grid = np.linspace(x.min(), x.max(), int(nkde))
        # Silverman bandwidth on the weighted sample
        mu = (wt * x).sum()
        sd = np.sqrt(np.maximum((wt * (x - mu) ** 2).sum(), 1e-300))
        neff = 1.0 / np.maximum((wt ** 2).sum(), 1e-300)
        bw = 1.06 * sd * neff ** (-1.0 / 5.0)
        # accumulate over sample chunks: the dense (nkde, niter) matrix
        # would be multi-GB for ordinary million-iteration runs
        dens = np.zeros(len(grid))
        chunk = max(1, (1 << 22) // max(len(grid), 1))
        for i in range(0, len(x), chunk):
            xs, ws = x[i:i + chunk], wt[i:i + chunk]
            dens += np.exp(
                -0.5 * ((grid[:, None] - xs[None, :]) / bw) ** 2).dot(ws)
        dens /= bw * np.sqrt(2 * np.pi)
        axes[2].plot(grid, dens / dens.max(), color=color, **plot_kwargs)
        axes[2].set_ylabel('Importance\nweight PDF')
    else:
        relwt = np.exp(logwt - logwt.max())
        axes[2].plot(x, relwt / relwt.max(), color=color, **plot_kwargs)
        axes[2].set_ylabel('Importance\nweight')

    with np.errstate(invalid='ignore'):
        axes[3].plot(x, logz, color=color, **plot_kwargs)
        finite = np.isfinite(logzerr)
        if lnz_error:
            for s in (1, 2, 3):
                axes[3].fill_between(
                    x[finite], (logz - s * logzerr)[finite],
                    (logz + s * logzerr)[finite], color=color,
                    alpha=0.4 / s)
    if lnz_truth is not None:
        axes[3].axhline(lnz_truth, color=truth_color, **truth_kwargs)
    axes[3].set_ylabel('log(Z)', **label_kwargs)
    axes[3].set_xlabel(r'$-\ln X$ (prior volume)', **label_kwargs)

    if mark_final_live and len(nlive) > 1:
        # the final live-point drain: the suffix where nlive only
        # decreases (where the run appends its remaining live points)
        dec = np.flatnonzero(np.diff(nlive) >= 0)
        live_idx = int(dec[-1]) + 1 if len(dec) else 0
        if 0 < live_idx < len(x):
            for ax in axes:
                ax.axvline(x[live_idx], color=color, ls='dashed', lw=2)

    from matplotlib.ticker import (MaxNLocator, NullLocator,
                                   ScalarFormatter)
    for ax in axes:
        ax.xaxis.set_major_locator(
            NullLocator() if max_x_ticks == 0
            else MaxNLocator(max_x_ticks))
        ax.yaxis.set_major_locator(
            NullLocator() if max_y_ticks == 0
            else MaxNLocator(max_y_ticks))
        sf = ScalarFormatter(useMathText=use_math_text)
        ax.yaxis.set_major_formatter(sf)
    if logplot:
        with np.errstate(invalid='ignore'):
            lo = logz[np.isfinite(logz)]
            if len(lo) > 0:
                axes[3].set_ylim(max(lo.max() - 10 * max(logzerr[finite].max()
                                                         if finite.any() else 1, 1),
                                     lo.min()), lo.max() + 1)
    if span is not None:
        for ax, sp in zip(axes, span):
            if sp is not None:
                ax.set_ylim(sp)
    fig.align_ylabels(axes)
    return fig, axes


def traceplot(results, span=None, quantiles=[0.025, 0.5, 0.975], smooth=0.02,
              post_color='blue', post_kwargs=None, trace_cmap='plasma',
              labels=None, label_kwargs=None, show_titles=False,
              title_fmt='.2f', title_kwargs=None, truths=None,
              truth_color='red', truth_kwargs=None, fig=None, **kwargs):
    """Trace plots: parameter positions vs prior volume + 1-d marginals.

    API-compatible with UltraNest's ``plot.traceplot``.

    Parameters
    ----------
    results: dict
        run sequence (samples, logvol, weights)
    span: list or None
        optional per-parameter plotting ranges
    quantiles: list
        quantiles to mark on the marginal panels
    smooth: float
        histogram bin width as a fraction of the span
    post_color: str
        color for the marginal posterior panels
    post_kwargs: dict or None
        extra keyword arguments for the marginal histograms
    trace_cmap: str
        colormap for the weight-colored trace scatter
    labels: list of str
        parameter names
    label_kwargs: dict or None
        extra keyword arguments for axis labels
    show_titles: bool
        put "median +u -l" titles above the marginal panels
    title_fmt: str
        float format for the titles
    title_kwargs: dict or None
        extra keyword arguments for the titles
    truths: list of float or None
        reference parameter values to overplot
    truth_color: str
        color for the truth lines
    truth_kwargs: dict or None
        extra keyword arguments for the truth lines
    fig: (figure, axes) or None
        existing figure/axes to draw into

    Returns
    -------
    fig, axes: matplotlib figure and axes
    """
    import matplotlib.pyplot as plt

    post_kwargs = dict(post_kwargs or {})
    label_kwargs = dict(label_kwargs or {})
    title_kwargs = dict(title_kwargs or {})
    truth_kwargs = dict(truth_kwargs or {})

    samples = np.asarray(results['samples'])
    logvol = np.asarray(results['logvol'])
    weights = np.asarray(results['weights'])
    nsamples, ndim = samples.shape
    if labels is None:
        labels = ['param %d' % i for i in range(ndim)]

    if fig is None:
        fig, axes = plt.subplots(ndim, 2, figsize=(12, 2.2 * ndim + 1),
                                 squeeze=False)
    else:
        fig, axes = fig
    x = -logvol
    for i in range(ndim):
        ax_trace, ax_hist = axes[i]
        # trace colored by relative weight
        relwt = weights / weights.max()
        ax_trace.scatter(x, samples[:, i], c=relwt, s=2, cmap=trace_cmap)
        ax_trace.set_ylabel(labels[i], **label_kwargs)
        if i == ndim - 1:
            ax_trace.set_xlabel(r'$-\ln X$', **label_kwargs)

        bins = max(10, int(1.0 / smooth))
        ax_hist.hist(samples[:, i], bins=bins, weights=weights,
                     density=True, histtype='step', color=post_color,
                     **post_kwargs)
        for q in quantiles:
            ax_hist.axvline(_weighted_quantile(samples[:, i], [q], weights)[0],
                            linestyle='--', color=post_color, lw=1)
        if truths is not None and truths[i] is not None:
            ax_hist.axvline(truths[i], color=truth_color, **truth_kwargs)
            ax_trace.axhline(truths[i], color=truth_color, **truth_kwargs)
        if show_titles:
            lo, mid, hi = _weighted_quantile(
                samples[:, i], [0.15866, 0.5, 0.8413], weights)
            fmt = '%s = $%' + title_fmt + '^{+%' + title_fmt \
                + '}_{-%' + title_fmt + '}$'
            ax_hist.set_title(fmt % (labels[i], mid, hi - mid, mid - lo),
                              **title_kwargs)
        ax_hist.set_yticks([])
        if i == ndim - 1:
            ax_hist.set_xlabel('value', **label_kwargs)
        if span is not None and span[i] is not None:
            ax_trace.set_ylim(span[i])
            ax_hist.set_xlim(span[i])
    fig.tight_layout()
    return fig, axes
