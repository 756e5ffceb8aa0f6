# noqa: D400 D205
"""
ultranest_torch
---------------

PyTorch/CUDA port of :mod:`ultranest_tpu`, for one NVIDIA H100.

The region-rejection path of :class:`ReactiveNestedSampler` is ported:
pass a torch likelihood as ``torch_loglike=`` (and ``torch_transform=``)
and the proposal, region filtering and likelihood run on ``device``
('cuda' by default), with the three hand-written CUDA kernels of
:mod:`ultranest_torch.ops.kernels` on the path.

This package imports torch and never jax; it does not import
:mod:`ultranest_tpu` either.
"""

from .integrator import ReactiveNestedSampler
from .utils import vectorize

__all__ = ['ReactiveNestedSampler', 'vectorize']
__version__ = '0.1.0'
