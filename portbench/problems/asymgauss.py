"""The asymmetric gaussian as a user of the sampler writes it (UltraNest's
``examples/testasymgauss.py``): widths log-spaced from 0.1 down to
*sigma_min*, centres along a sine; a numpy likelihood for the host and a
torch one whose constants live on *device* once, so that the walk's CUDA
graphs can capture it."""

import numpy as np


def make(device, ndim=50, sigma_min=0.01):
    """The sampler's inputs for the *ndim*-d asymmetric gaussian."""
    sigma = np.logspace(-1, np.log10(sigma_min), ndim)
    width = 1 - 5 * sigma
    width[width < 1e-20] = 1e-20
    centers = (np.sin(np.arange(ndim) / 2.0) * width + 1.0) / 2.0
    norm = -0.5 * np.log(2 * np.pi * sigma ** 2).sum()

    def loglike(theta):
        return -0.5 * (((theta - centers) / sigma) ** 2).sum(axis=1) + norm

    import torch
    c_dev = torch.as_tensor(centers, dtype=torch.float32, device=device)
    s_dev = torch.as_tensor(sigma, dtype=torch.float32, device=device)

    def torch_loglike(theta):
        return -0.5 * (((theta - c_dev) / s_dev) ** 2).sum(dim=1) + norm

    return dict(param_names=['param%d' % (i + 1) for i in range(ndim)],
                loglike=loglike, transform=None,
                torch_loglike=torch_loglike, torch_transform=None)
