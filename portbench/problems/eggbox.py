"""The 2-d eggbox as a user of the sampler writes it (UltraNest's
``examples/testeggbox.py``): a numpy likelihood and transform for the
host and their torch twins for the device path."""

import math

import numpy as np


def make(device):
    """The sampler's inputs for the eggbox on *device*."""
    def loglike(z):
        chi = np.cos(z[:, 0] / 2) * np.cos(z[:, 1] / 2)
        return (2 + chi) ** 5

    def transform(x):
        return x * 10 * np.pi

    import torch

    def torch_loglike(z):
        chi = torch.cos(z[:, 0] / 2) * torch.cos(z[:, 1] / 2)
        return (2 + chi) ** 5

    def torch_transform(x):
        return x * 10 * math.pi

    return dict(param_names=['x', 'y'], loglike=loglike, transform=transform,
                torch_loglike=torch_loglike, torch_transform=torch_transform)
