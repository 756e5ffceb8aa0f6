# noqa: D400 D205
"""
Multi-process launcher, device result fetches and the dispatch watchdog
-----------------------------------------------------------------------

Counterpart of ``ultranest_tpu/parallel/launch.py``. Every process of a
multi-GPU job calls :func:`init_distributed` once and builds one mesh
over the job (:func:`global_mesh`, or :func:`slice_mesh` for nodes x
ranks per node); the samplers then shard over it. Typical launches::

    # torchrun --nproc-per-node 4 run.py   (MASTER_ADDR, RANK, ... set)
    import ultranest_torch.parallel.launch as launch
    launch.init_distributed()
    mesh = launch.global_mesh()
    sampler = ReactiveNestedSampler(..., torch_loglike=f, mesh=mesh)

    # or explicitly, process 0 of 2 (and PROCID=1 in the other):
    #   ULTRANEST_TORCH_COORDINATOR=host0:9911 ULTRANEST_TORCH_NPROC=2 \\
    #   ULTRANEST_TORCH_PROCID=0 python run.py
    # mpiexec-style launchers: OMPI_COMM_WORLD_{SIZE,RANK} (or
    # PMI_{SIZE,RANK}) with a coordinator address

Data placement: every rank holds the same full host copy of a sharded
input and takes its own block (:func:`shard_rows`), where the JAX
package builds a global array from those copies.

The module also holds a two-step fetch that lets the host keep
dispatching while a result streams home, and the dispatch watchdog.

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
import torch.distributed as dist

from .. import tracing
from . import make_mesh, shard_count, shard_index

__all__ = ['init_distributed', 'global_mesh', 'slice_mesh',
           'is_multiprocess_mesh', 'fetch_replicated', 'shard_rows',
           'DeviceLostError', 'DEFAULT_DISPATCH_DEADLINE', 'dispatch_deadline',
           'wait_ready', 'fetch_with_deadline', 'start_fetch', 'finish_fetch']


def _first_env(*names):
    """The first of the environment variables *names* that is set."""
    for name in names:
        if os.environ.get(name, '') != '':
            return os.environ[name]
    return None


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, backend='nccl', **kwargs):
    """Join this process to the job's ``torch.distributed`` process group.

    Argument resolution order (``ultranest_tpu/parallel/launch.py:115``):

    1. explicit arguments;
    2. ``ULTRANEST_TORCH_COORDINATOR`` (host:port) /
       ``ULTRANEST_TORCH_NPROC`` / ``ULTRANEST_TORCH_PROCID``;
    3. an MPI launcher's ``OMPI_COMM_WORLD_SIZE/RANK`` or
       ``PMI_SIZE/RANK`` for the process count and rank;
    4. torchrun's ``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE`` and
       ``RANK``.

    *backend* is NCCL unless the caller names another (the CPU tests
    name gloo). With NCCL the process first selects its card:
    ``LOCAL_RANK`` (or ``OMPI_COMM_WORLD_LOCAL_RANK``), else its rank
    modulo the cards it sees. Remaining keyword arguments go to
    ``torch.distributed.init_process_group`` (e.g. ``timeout``). A no-op
    when the process group already exists.
    """
    if dist.is_initialized():
        return
    if coordinator_address is None:
        coordinator_address = _first_env('ULTRANEST_TORCH_COORDINATOR')
    if coordinator_address is None and _first_env('MASTER_ADDR'):
        coordinator_address = '%s:%s' % (
            os.environ['MASTER_ADDR'], _first_env('MASTER_PORT') or '29500')
    if num_processes is None:
        num_processes = _first_env('ULTRANEST_TORCH_NPROC',
                                   'OMPI_COMM_WORLD_SIZE', 'PMI_SIZE',
                                   'WORLD_SIZE')
    if process_id is None:
        process_id = _first_env('ULTRANEST_TORCH_PROCID',
                                'OMPI_COMM_WORLD_RANK', 'PMI_RANK', 'RANK')
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError(
            'init_distributed needs a coordinator address, a process count '
            'and a rank (arguments, ULTRANEST_TORCH_COORDINATOR/_NPROC/'
            '_PROCID, an MPI launcher or torchrun); got %r, %r, %r'
            % (coordinator_address, num_processes, process_id))
    num_processes, process_id = int(num_processes), int(process_id)
    if backend == 'nccl':
        local = _first_env('LOCAL_RANK', 'OMPI_COMM_WORLD_LOCAL_RANK')
        torch.cuda.set_device(int(local) if local is not None
                              else process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method='tcp://%s' % coordinator_address,
        world_size=num_processes, rank=process_id, **kwargs)


def global_mesh(axis_name='ranks'):
    """A 1-axis mesh over every rank of the job."""
    return make_mesh(axis_name=axis_name)


def slice_mesh(axis_names=('dcn', 'ranks')):
    """A 2-axis mesh: nodes x ranks per node.

    Ranks are grouped by node through ``LOCAL_WORLD_SIZE`` (torchrun
    numbers ranks node by node); the outer dimension crosses the slow
    interconnect. Falls back to a 1 x N mesh when the job has one node,
    no ``LOCAL_WORLD_SIZE``, or nodes of unequal size
    (``ultranest_tpu/parallel/launch.py:174-197``). Every rank must
    call it.
    """
    world = dist.get_world_size()
    local = int(_first_env('LOCAL_WORLD_SIZE') or world)
    sizes = [None] * world
    dist.all_gather_object(sizes, local)
    if len(set(sizes)) == 1 and 1 < local < world and world % local == 0:
        shape = (world // local, local)
    else:
        shape = (1, world)
    return make_mesh(shape=shape, axis_name=tuple(axis_names))


def is_multiprocess_mesh(mesh):
    """Whether *mesh* spans other processes: with one process per rank,
    any mesh of more than one rank."""
    return mesh is not None and mesh.size() > 1


def shard_rows(x, mesh, axis_name=None):
    """This shard's block of rows of *x*, the full host copy every rank
    holds (the counterpart of ``put_along_mesh``/``put_args``)."""
    n = shard_count(mesh, axis_name)
    if len(x) % n:
        raise ValueError('%d rows do not split over %d shards' % (len(x), n))
    k = len(x) // n
    i = shard_index(mesh, axis_name)
    return x[i * k:(i + 1) * k]


def fetch_replicated(x):
    """Host copy of a result every rank holds alike (gathered or reduced):
    this rank's own replica, read under the dispatch deadline. Host arrays
    pass through."""
    if torch.is_tensor(x):
        return fetch_with_deadline(x)
    return np.asarray(x)


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
    yield to other threads between queries. The wait is booked as
    ``wait`` in the sampler's run in progress (:mod:`ultranest_torch.tracing`).
    """
    t0 = time.perf_counter()
    try:
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
    finally:
        tracing.book('wait', time.perf_counter() - t0)


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
