# noqa: D400 D205
"""
Calibration of step samplers
----------------------------

Runs a sequence of nested sampling runs with doubling step counts until
log(Z) converges — the recommended procedure for choosing the number of
steps (Higson+19). A copy of ``ultranest_tpu/calibrator.py`` over the
port's sampler: the host step samplers and the device population
engines calibrate alike.
"""

import os

import numpy as np

from .integrator import ReactiveNestedSampler

__all__ = ['ReactiveNestedCalibrator']


def _convergence_verdict(results):
    """Judge the tail of a calibration sequence.

    Converged when the last three log(Z) values are neither
    significantly different pairwise nor monotonically ordered.
    Returns ``(converged, message)``.
    """
    if len(results) < 3:
        return False, None
    z2, z1, z0 = [r['logz'] for r in results[-3:]]
    e2, e1, e0 = [r['logzerr'] for r in results[-3:]]
    if abs(z0 - z1) > np.hypot(e0, e1):
        return False, "not converged: last two Z were significantly different"
    if abs(z1 - z2) > np.hypot(e1, e2):
        return False, ("not yet converged: previous two Z were "
                       "significantly different")
    if z0 > z1 > z2:
        return False, ("not converged: monotonic increase in the last "
                       "three Z results")
    if z0 < z1 < z2:
        return False, ("not converged: monotonic decrease in the last "
                       "three Z results")
    return True, None


class ReactiveNestedCalibrator:
    """Step-count calibrator: drop-in replacement for ReactiveNestedSampler.

    Runs full nested sampling repeatedly with nsteps doubling each time
    (starting at the dimensionality), until three consecutive runs have
    unordered log(Z) values with overlapping error bars.

    Usage::

        sampler = ReactiveNestedCalibrator(paramnames, loglike, transform)
        sampler.stepsampler = SliceSampler(nsteps=10, generate_direction=...)
        sampler.run(min_num_live_points=400)
    """

    def __init__(self, param_names, loglike, transform=None, **kwargs):
        """Store the sampler arguments for the repeated runs.

        If ``log_dir`` is in *kwargs*, each run gets the suffix
        ``-nsteps%d``.
        """
        self.init_args = dict(param_names=param_names, loglike=loglike,
                              transform=transform, **kwargs)
        self.stepsampler = None
        self.results = []
        self.nsteps = []
        self.relsteps = []

    def _build_run(self, nsteps):
        """Create (sampler, stepsampler clone) for one calibration run."""
        args = dict(self.init_args)
        logdir = args.get('log_dir')
        if logdir is not None:
            args['log_dir'] = '%s-nsteps%d' % (logdir, nsteps)
        sampler = ReactiveNestedSampler(**args)

        # Clone the prototype by constructor-signature introspection so
        # any step sampler calibrates — the scalar family
        # (generate_direction, check_nsteps, ...) and the device-resident
        # population engines (torch_loglike, engine, spec_depth, device,
        # ...) alike. Every constructor argument of the port's samplers
        # is kept as an attribute of the same name, so the clone equals
        # its prototype but for nsteps and the log file.
        import inspect

        proto = self.stepsampler
        params = inspect.signature(type(proto).__init__).parameters
        clone_kwargs = {
            name: getattr(proto, name) for name in params
            if name not in ('self', 'nsteps', 'log', 'logfile')
            and hasattr(proto, name)}
        clone_kwargs['nsteps'] = nsteps
        if logdir is not None and ('log' in params or 'logfile' in params):
            handle = open(  # noqa: SIM115
                args['log_dir'] + '/stepsampler.log', 'w')
            clone_kwargs['log' if 'log' in params else 'logfile'] = handle
        sampler.stepsampler = type(proto)(**clone_kwargs)
        return sampler

    def _harvest_jump_stats(self, stepsampler):
        """Record relative jump distances when the sampler tracked them."""
        labels = getattr(stepsampler, 'logstat_labels', [])
        if 'jump-distance' not in labels or \
                'reference-distance' not in labels:
            return
        stats = np.asarray(stepsampler.logstat)
        jumps = stats[:, labels.index('jump-distance')]
        refs = stats[:, labels.index('reference-distance')]
        self.relsteps.append(jumps / refs)

    def _finish_run(self, sampler, result):
        """Record one completed calibration run (diagnostics + stats)."""
        print("Z=%(logz).2f +- %(logzerr).2f" % result)
        step = sampler.stepsampler
        if sampler.log_to_disk:
            step.plot(os.path.join(sampler.logs['plots'],
                                   'stepsampler.pdf'))
            step.plot_jump_diagnostic_histogram(
                os.path.join(sampler.logs['plots'],
                             'stepsampler-jumphist.pdf'),
                histtype='step', bins='auto')
        step.print_diagnostic()
        self._harvest_jump_stats(step)
        self.results.append(result)

    def run_iter(self, **kwargs):
        """Yield (nsteps, result) for each calibration run until convergence.

        Convergence: the last three runs are not monotonically ordered in
        log(Z) and consecutive error bars overlap.

        The ladder runs strictly sequentially: each rung's dispatches
        chain on its own device live set.
        """
        assert self.stepsampler is not None, \
            'assign a .stepsampler before calibrating'
        self.run_args = kwargs
        self.results = []
        self.nsteps = []
        self.relsteps = []
        nsteps = len(self.init_args['param_names'])

        while True:
            print("running with %d steps ..." % nsteps)
            self.sampler = self._build_run(nsteps)
            result = self.sampler.run(**self.run_args)
            self._finish_run(self.sampler, result)
            self.nsteps.append(nsteps)
            yield nsteps, result

            converged, message = _convergence_verdict(self.results)
            if converged:
                print("converged! nsteps=%d appears safe" % nsteps)
                return
            if message:
                print(message)
            nsteps *= 2

    def run(self, **kwargs):
        """Run calibration runs until convergence; returns the last result."""
        result = None
        for _nsteps, result in self.run_iter(**kwargs):
            pass
        return result

    def plot(self):
        """Store convergence diagnostics plots into the plots folder."""
        import matplotlib.pyplot as plt
        self.sampler.stepsampler.plot(os.path.join(
            self.sampler.logs['plots'], 'stepsampler.pdf'))

        table = []
        plt.figure("jump-distance")
        print("jump distance diagnostic:")
        for nsteps, relsteps, result in zip(self.nsteps, self.relsteps,
                                            self.results):
            mww = result['insertion_order_MWW_test']
            table.append([
                nsteps, result['logz'], result['logzerr'],
                min(result['niter'], mww['independent_iterations']),
                1 * mww['converged'], np.nanmean(relsteps > 1)])
            plt.hist(np.log10(relsteps + 1e-10), histtype='step',
                     bins='auto', label=nsteps)
            print('  %-4d: %.2f%%  avg:%.2f' % (
                nsteps, np.nanmean(relsteps > 1) * 100.0,
                np.exp(np.nanmean(np.log(relsteps)))))
        if 'log_dir' in self.init_args:
            np.savetxt(
                self.init_args['log_dir'] + 'calibration.csv', table,
                delimiter=',', comments='',
                header='nsteps,logz,logzerr,maxUrun,Uconverged,stepfrac',
                fmt='%d,%.3f,%.3f,%d,%d,%.5f')
        plt.xlabel('$log_{10}$(relative step distance)')
        plt.ylabel('Frequency')
        plt.legend(title='nsteps', loc='best')
        if self.sampler.log_to_disk:
            plt.savefig(os.path.join(self.sampler.logs['plots'],
                                     'nsteps-calibration-jumps.pdf'),
                        bbox_inches='tight')
            plt.close()

        plt.figure("logz")
        plt.errorbar(x=self.nsteps,
                     y=[r['logz'] for r in self.results],
                     yerr=[r['logzerr'] for r in self.results])
        plt.title('Step sampler calibration')
        plt.xlabel('Number of steps')
        plt.ylabel('ln(Z)')
        if self.sampler.log_to_disk:
            plt.savefig(os.path.join(self.sampler.logs['plots'],
                                     'nsteps-calibration.pdf'),
                        bbox_inches='tight')
            plt.close()
