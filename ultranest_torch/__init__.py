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
the host; the regions they use are built on ``device``. So are the
stored runs (:func:`read_file`, ``resume='resume-similar'``; both need
h5py), the warm starts (:func:`warmstart_from_similar_file`,
:mod:`ultranest_torch.hotstart`), the step-count calibrator
(:mod:`ultranest_torch.calibrator`), the pymultinest-style driver
(:mod:`ultranest_torch.solvecompat`) and the trajectory samplers
(:mod:`ultranest_torch.pathsampler`, :mod:`ultranest_torch.dychmc`,
:mod:`ultranest_torch.dyhmc`, gradients by ``torch.autograd``). A device
read that misses the dispatch deadline
(``ULTRANEST_TORCH_DISPATCH_DEADLINE``) degrades a run to the host path.

This package imports torch and never jax; it does not import
:mod:`ultranest_tpu` either.
"""

from .integrator import (NestedSampler, ReactiveNestedSampler, read_file,
                         warmstart_from_similar_file)
from .utils import vectorize

__all__ = ['NestedSampler', 'ReactiveNestedSampler', 'read_file',
           'warmstart_from_similar_file', 'vectorize']
__version__ = '0.1.0'
