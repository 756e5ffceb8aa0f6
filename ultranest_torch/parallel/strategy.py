# noqa: D400 D205
"""
Strategy reductions
-------------------

The single-device bootstrap KL table of the reactive improvement
strategy (``ultranest_tpu/parallel/strategy.py:44-75``, its
``mesh=None`` branch), as torch in float64 on the host, where that
branch computes it too. The mesh-sharded variant waits for the port's
multi-GPU work.
"""

import numpy as np
import torch

__all__ = ['bootstrap_kl_table']


def bootstrap_kl_table(ref_logw, other_logw):
    """KL divergence table of bootstrap posteriors vs the main estimator.

    Parameters
    ----------
    ref_logw: array (niter, 1)
        log posterior weights of the main estimator
    other_logw: array (niter, nbootstraps)
        log posterior weights of each bootstrap estimator

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
