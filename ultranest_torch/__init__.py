# noqa: D400 D205
"""
ultranest_torch
---------------

PyTorch/CUDA port of :mod:`ultranest_tpu`, for one NVIDIA H100.

Two paths of :class:`ReactiveNestedSampler` are ported. Region
rejection: pass a torch likelihood as ``torch_loglike=`` (and
``torch_transform=``) and the proposal, region filtering and likelihood
run on ``device`` ('cuda' by default). The population walks: set
``sampler.stepsampler`` to a
:class:`ultranest_torch.popfused.FusedPopulationSliceSampler` (engine
'spec', 'async' or 'sync') or a
:class:`ultranest_torch.popfused.FusedPopulationRandomWalkSampler`. The
hand-written CUDA kernels on these paths are in
:mod:`ultranest_torch.ops.kernels`.

The host tier is ported too: the host step samplers of
:mod:`ultranest_torch.stepsampler`, the classic :class:`NestedSampler`
and the plots (:mod:`ultranest_torch.plot`). Their loops are numpy on
the host; the regions they use are built on ``device``.

This package imports torch and never jax; it does not import
:mod:`ultranest_tpu` either.
"""

from .integrator import NestedSampler, ReactiveNestedSampler
from .utils import vectorize

__all__ = ['NestedSampler', 'ReactiveNestedSampler', 'vectorize']
__version__ = '0.1.0'
