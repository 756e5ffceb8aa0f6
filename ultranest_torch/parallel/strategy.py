# noqa: D400 D205
"""
Strategy reductions
-------------------

The bootstrap KL table of the reactive improvement strategy
(``ultranest_tpu/parallel/strategy.py:44-105``), as torch in float64 on
the host. With a mesh the JAX package takes this host branch too on
every multi-process mesh (``strategy.py:77-82``): the table is
replicated host data, every rank computes the identical decision, and a
round trip over the interconnect would buy nothing. With one process
per rank every mesh of more than one rank is multi-process, so the port
always computes it here.
"""

import numpy as np
import torch

__all__ = ['bootstrap_kl_table']


def bootstrap_kl_table(ref_logw, other_logw, mesh=None, axis_name=None):
    """KL divergence table of bootstrap posteriors vs the main estimator.

    Parameters
    ----------
    ref_logw: array (niter, 1)
        log posterior weights of the main estimator
    other_logw: array (niter, nbootstraps)
        log posterior weights of each bootstrap estimator
    mesh, axis_name: DeviceMesh or None, dimension name(s) or None
        accepted for the JAX package's signature; the table is computed
        on the host of every rank alike (see the module docstring)

    Returns
    -------
    KL: array (niter, nbootstraps)
        pointwise KL contributions, zero where the estimator had no weight
    KLtot: array (nbootstraps,)
        total divergence per bootstrap estimator
    """
    ref = torch.as_tensor(np.asarray(ref_logw, np.float64))
    other = torch.as_tensor(np.asarray(other_logw, np.float64))
    KL = torch.where(torch.isfinite(other),
                     torch.exp(other) * (other - ref),
                     torch.zeros((), dtype=other.dtype))
    return KL.numpy(), KL.sum(dim=0).numpy()
