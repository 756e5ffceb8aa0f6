"""Cells cut to a size that a CPU test run holds: the same files, fewer
live points, and for the population walk fewer walkers and dimensions."""

import copy

from portbench import harness


def small_cell(name):
    """(workload, config) of cell *name*, cut for the CPU."""
    workload, config = harness.load_cell(name)
    workload, config = copy.deepcopy(workload), copy.deepcopy(config)
    workload['run']['min_num_live_points'] = 100
    workload['fit_pool'] = dict(workload['fit_pool'], size=1)
    workload['check_fits'] = 1
    if config['stepsampler']:
        config['stepsampler']['kwargs'].update(popsize=128, nsteps=16)
        config['problem_args'] = dict(config['problem_args'], ndim=8)
    return workload, config


CELLS = ('eggbox2d.live400', 'asymgauss50.live400')
