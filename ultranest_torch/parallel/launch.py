# noqa: D400 D205
"""
Device result fetches
---------------------

The JAX package's launcher (``ultranest_tpu/parallel/launch.py``) also
holds the multi-controller setup and a dispatch watchdog; the port
keeps only what the single-card path needs: the exception type the
integrator names and a two-step fetch that lets the host keep
dispatching while a result streams home.
"""

import numpy as np
import torch

__all__ = ['DeviceLostError', 'start_fetch', 'finish_fetch']


class DeviceLostError(RuntimeError):
    """A device dispatch exceeded its deadline (accelerator lost)."""


def start_fetch(x):
    """Begin copying device tensor *x* to the host; returns a handle.

    On a CUDA device the copy goes ``non_blocking`` into pinned host
    memory on the current stream, and a CUDA event is recorded behind
    it; nothing waits here. A CPU tensor is its own handle.
    """
    if x.device.type != 'cuda':
        return x, None
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def finish_fetch(handle):
    """Wait for a :func:`start_fetch` copy; returns a numpy array."""
    host, done = handle
    if done is not None:
        done.synchronize()
    return np.asarray(host.numpy())
