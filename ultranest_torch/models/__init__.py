"""Analytic benchmark problems with numpy and torch likelihoods."""

from .problems import Problem, corrgauss, eggbox, gauss

__all__ = ['Problem', 'gauss', 'corrgauss', 'eggbox']
