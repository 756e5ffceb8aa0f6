# noqa: D400 D205
"""
Device result fetches and the dispatch watchdog
-----------------------------------------------

The JAX package's launcher (``ultranest_tpu/parallel/launch.py``) also
holds the multi-controller setup; the port keeps what the single-card
path needs: a two-step fetch that lets the host keep dispatching while a
result streams home, and the dispatch watchdog.

The watchdog: a lost device (a hung kernel, a card that fell off the
bus) would block the next device-to-host read for ever. Every blocking
read of a dispatch path waits through :func:`wait_ready`, which polls
the CUDA event recorded behind the copy and raises
:class:`DeviceLostError` once the deadline has passed; the integrator
catches it and degrades to the host path. The deadline is
``ULTRANEST_TORCH_DISPATCH_DEADLINE`` seconds (default
:data:`DEFAULT_DISPATCH_DEADLINE`; 0 disables the watchdog). The wait
is a poll of ``Event.query()`` with a yield between queries, not a
thread around ``synchronize()``, so a read that timed out leaves nothing
behind.
"""

import os
import time

import numpy as np
import torch

__all__ = ['DeviceLostError', 'DEFAULT_DISPATCH_DEADLINE', 'dispatch_deadline',
           'wait_ready', 'fetch_with_deadline', 'start_fetch', 'finish_fetch']


class DeviceLostError(RuntimeError):
    """A device dispatch exceeded its deadline (accelerator lost)."""


# generous, as the reference's: a first call may build the CUDA kernels
DEFAULT_DISPATCH_DEADLINE = 900.0


def dispatch_deadline():
    """Seconds a blocking device read may take (0: no deadline)."""
    env = os.environ.get('ULTRANEST_TORCH_DISPATCH_DEADLINE')
    return float(env) if env else DEFAULT_DISPATCH_DEADLINE


def is_ready(event):
    """Whether the work behind *event* (None: no device work) completed.

    The one place the watchdog asks the device; tests replace it to
    simulate a device that stops answering.
    """
    return event is None or event.query()


def wait_ready(event, deadline=None):
    """Wait until *event* completes; raise DeviceLostError past *deadline*.

    *deadline* in seconds, None for :func:`dispatch_deadline`. Completed
    work costs one query; otherwise the host spins on ``query()`` with a
    yield to other threads between queries.
    """
    if is_ready(event):
        return
    if deadline is None:
        deadline = dispatch_deadline()
    if not deadline or deadline <= 0:
        if event is not None:
            event.synchronize()
        return
    t_end = time.monotonic() + deadline
    while not is_ready(event):
        if time.monotonic() > t_end:
            raise DeviceLostError(
                'device read exceeded the %g s dispatch deadline '
                '(accelerator lost?)' % deadline)
        time.sleep(0)


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


def finish_fetch(handle, deadline=None):
    """Wait for a :func:`start_fetch` copy; returns a numpy array.

    Raises DeviceLostError if the copy is not done within *deadline*
    seconds (None: :func:`dispatch_deadline`).
    """
    host, done = handle
    wait_ready(done, deadline)
    return np.asarray(host.numpy())


def fetch_with_deadline(x, deadline=None):
    """Host copy of tensor *x*, raising DeviceLostError past *deadline*."""
    return finish_fetch(start_fetch(x), deadline)
