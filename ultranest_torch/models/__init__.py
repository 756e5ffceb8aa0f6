"""Analytic benchmark problems with numpy and torch likelihoods."""

from .problems import (Problem, asymgauss, corrgauss, corrpeak, dirichlet,
                       eggbox, funnel, gauss, hyperrect, loggamma,
                       multigauss, multishell, pyramid, rosenbrock, shell,
                       sine, slantedeggbox)

__all__ = ['Problem', 'gauss', 'multigauss', 'asymgauss', 'corrgauss',
           'eggbox', 'rosenbrock', 'multishell', 'shell', 'loggamma',
           'funnel', 'pyramid', 'sine', 'corrpeak', 'hyperrect',
           'dirichlet', 'slantedeggbox']
