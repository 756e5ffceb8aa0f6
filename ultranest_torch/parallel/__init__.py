# noqa: D400 D205
"""
Mesh-sharded data parallelism over torch.distributed
----------------------------------------------------

Counterpart of ``ultranest_tpu/parallel/__init__.py``. Every rank is one
process with one device and runs the whole sampler; the tree, the live
set and the host RNG streams stay identical on every rank. Only
candidate generation, the population walk and the bootstrap rounds are
sharded, and their results are all-gathered.

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` with named
dimensions, the counterpart of a ``jax.sharding.Mesh`` and its axis
names. Work is sharded over every dimension (:func:`mesh_axes`); an
explicit *axis_name* restricts it to one dimension, or to a tuple of
them, and the ranks along the others do the same work. A shard's index
is its row-major coordinate over the sharded dimensions, as
``jax.lax.axis_index`` gives it over an axis tuple, so a (2, 2)
``('dcn', 'ranks')`` mesh gathers in the order of a 1-axis 4-rank mesh.

The collectives (:func:`all_gather_rows`, :func:`psum`, :func:`pmax`,
:func:`pmean`) act on tensors and run dimension by dimension over the
mesh's own process groups. Each picks its route by the name of the
group's backend: a CUDA tensor goes to NCCL as it is and is staged
through host memory for gloo, which has no CUDA all-gather. A failed
collective raises; nothing falls back.

Per-shard random streams stand where ``jax.random.fold_in(key,
axis_index)`` stands: every rank draws the same per-dispatch key from
its host stream and seeds its generator from (key, shard index) through
a fixed integer mix (:func:`shard_seed`).
"""

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ['make_mesh', 'mesh_axes', 'check_mesh', 'shard_count',
           'shard_index', 'shard_seed', 'all_gather_rows', 'psum', 'pmax',
           'pmean', 'parallel_propose_evaluate']

_M64 = (1 << 64) - 1
# all_gather_into_tensor before its rename (torch 2.13)
_all_gather_single = getattr(dist, 'all_gather_single', None) \
    or dist.all_gather_into_tensor


def mesh_axes(mesh):
    """All dimension names of *mesh*: a single name (1-axis) or a tuple.

    The one place the "shard over every dimension" rule is encoded
    (``ultranest_tpu/parallel/__init__.py:32``).
    """
    names = mesh.mesh_dim_names or tuple(range(mesh.ndim))
    return names[0] if len(names) == 1 else tuple(names)


def make_mesh(n_devices=None, axis_name='ranks', shape=None):
    """A mesh over the ranks of the initialised process group.

    Parameters
    ----------
    n_devices: int or None
        ranks in the mesh (default: the world size). A process cannot
        take "the first n devices" of other processes, so anything but
        the world size raises, as a mesh that silently shrank would make
        a multi-shard test pass without testing anything.
    axis_name: str or tuple of str
        dimension name(s); a tuple requires a matching *shape*
    shape: tuple of int or None
        multi-dimension shape, e.g. ``(2, 4)`` with ``axis_name=('dcn',
        'ranks')``: two nodes of four ranks (outer dimension slowest)

    The mesh's device type is ``'cuda'`` on an NCCL group and ``'cpu'``
    otherwise; the samplers take their device separately. Every rank
    must call it: a multi-dimension mesh creates a process group per
    dimension.
    """
    if not dist.is_initialized():
        raise RuntimeError(
            'make_mesh needs an initialised process group '
            '(ultranest_torch.parallel.launch.init_distributed)')
    world = dist.get_world_size()
    if shape is not None:
        if isinstance(axis_name, str):
            raise ValueError('a multi-axis shape needs a tuple axis_name')
        if len(shape) != len(axis_name):
            raise ValueError('shape %r / axis_name %r length mismatch'
                             % (shape, axis_name))
        n_devices = int(np.prod(shape))
    else:
        if not isinstance(axis_name, str):
            raise ValueError('a tuple axis_name needs a shape')
        shape, axis_name = (world if n_devices is None else n_devices,), \
            (axis_name,)
        n_devices = shape[0]
    if n_devices != world:
        raise ValueError(
            'requested a %d-rank mesh but the process group has %d ranks; '
            'start one process per rank' % (n_devices, world))
    device_type = 'cuda' if 'nccl' in str(dist.get_backend()) else 'cpu'
    return DeviceMesh(device_type, torch.arange(world).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axis_name))


def check_mesh(mesh, axis_name=None):
    """Validate a sampler's *mesh* and *axis_name*; returns them.

    Raises TypeError for a mesh that is not a DeviceMesh and ValueError
    for an axis name without a mesh or one the mesh does not have.
    """
    if mesh is None:
        if axis_name is not None:
            raise ValueError('axis_name=%r needs a mesh' % (axis_name,))
        return None, None
    if not isinstance(mesh, DeviceMesh):
        raise TypeError('mesh must be a torch.distributed.device_mesh.'
                        'DeviceMesh, got %s' % type(mesh).__name__)
    _dims(mesh, axis_name)
    if mesh.get_coordinate() is None:
        raise ValueError('this rank is not in the mesh')
    return mesh, axis_name


def _dims(mesh, axis_name):
    """Indices of the sharded dimensions, in row-major order."""
    if axis_name is None:
        return list(range(mesh.ndim))
    names = mesh.mesh_dim_names or tuple(range(mesh.ndim))
    wanted = axis_name if isinstance(axis_name, tuple) else (axis_name,)
    missing = [a for a in wanted if a not in names]
    if missing:
        raise ValueError('mesh %r has no dimension %r' % (names, missing))
    return [names.index(a) for a in wanted]


def shard_count(mesh, axis_name=None):
    """Number of shards: the product of the sharded dimensions (1 without
    a mesh)."""
    if mesh is None:
        return 1
    return int(np.prod([mesh.size(d) for d in _dims(mesh, axis_name)]))


def shard_index(mesh, axis_name=None):
    """This rank's shard: its row-major coordinate over the sharded
    dimensions (0 without a mesh)."""
    if mesh is None:
        return 0
    coord = mesh.get_coordinate()
    idx = 0
    for d in _dims(mesh, axis_name):
        idx = idx * mesh.size(d) + coord[d]
    return idx


def shard_seed(key, index):
    """Generator seed of shard *index* from a host key of two uint32 words.

    A splitmix64 mix of the key and the index: the torch counterpart of
    ``jax.random.fold_in(key, axis_index)``. Streams of different shards
    differ, and each is the same from run to run.
    """
    x = ((int(key[0]) << 32) | int(key[1])) \
        ^ ((int(index) + 1) * 0x9E3779B97F4A7C15 & _M64)
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & _M64
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & _M64
    return (x ^ (x >> 31)) & (2**63 - 1)


def _staged(x, group):
    """Whether a collective on *x* over *group* must go through host
    memory: a CUDA tensor on a group without NCCL (gloo)."""
    if x.device.type != 'cuda':
        return False
    backend = str(dist.get_backend(group))
    if 'nccl' in backend:
        return False
    if 'gloo' in backend:
        return True
    raise ValueError('no collective route for a CUDA tensor on backend %r'
                     % backend)


def _to_host(x):
    """Host copy of device tensor *x*, read under the dispatch deadline
    (:func:`~ultranest_torch.parallel.launch.fetch_with_deadline`)."""
    from .launch import fetch_with_deadline
    return torch.from_numpy(fetch_with_deadline(x))


def _coordinate_order(mesh, d, group):
    """Block permutation from the group's rank order to the coordinate
    order along dimension *d* (None when they agree)."""
    coord = mesh.get_coordinate()
    line = mesh.mesh[tuple(slice(None) if k == d else coord[k]
                           for k in range(mesh.ndim))].tolist()
    ranks = dist.get_process_group_ranks(group)
    perm = [ranks.index(r) for r in line]
    return None if perm == list(range(len(perm))) else perm


def _gather_dim(x, mesh, d):
    """All-gather *x* along mesh dimension *d*, blocks in coordinate order."""
    group = mesh.get_group(d)
    n = mesh.size(d)
    src = x.contiguous()
    staged = _staged(src, group)
    if staged:
        src = _to_host(src)
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    _all_gather_single(out, src, group=group)
    perm = _coordinate_order(mesh, d, group)
    if perm is not None:
        out = out.view((n, -1) + tuple(src.shape[1:]))[perm].reshape(
            out.shape)
    return out.to(x.device) if staged else out


def all_gather_rows(x, mesh, axis_name=None):
    """Rows of *x* from every shard, concatenated in shard order.

    The counterpart of ``jax.lax.all_gather(x, axis, tiled=True)``:
    (n, ...) on each shard gives (nshards * n, ...) on every shard. Over
    several dimensions the innermost is gathered first.
    """
    for d in reversed(_dims(mesh, axis_name)):
        x = _gather_dim(x, mesh, d)
    return x


def _all_reduce(x, op, mesh, axis_name):
    y = x.clone()
    for d in _dims(mesh, axis_name):
        group = mesh.get_group(d)
        if _staged(y, group):
            host = _to_host(y)
            dist.all_reduce(host, op=op, group=group)
            y.copy_(host)
        else:
            dist.all_reduce(y, op=op, group=group)
    return y


def psum(x, mesh, axis_name=None):
    """Sum of *x* over the shards (``jax.lax.psum``); exact on integers."""
    return _all_reduce(x, dist.ReduceOp.SUM, mesh, axis_name)


def pmax(x, mesh, axis_name=None):
    """Maximum of *x* over the shards (``jax.lax.pmax``)."""
    return _all_reduce(x, dist.ReduceOp.MAX, mesh, axis_name)


def pmean(x, mesh, axis_name=None):
    """Mean of *x* over the shards (``jax.lax.pmean``).

    Gathered, then averaged in shard order, so that every rank and every
    mesh of the same shards gets the same bits.
    """
    return all_gather_rows(x[None], mesh, axis_name).mean(dim=0)


def parallel_propose_evaluate(mesh, loglike, transform, x_dim,
                              ndraw_per_shard=128, axis_name=None,
                              device='cuda'):
    """Build a sharded propose + evaluate function
    (``ultranest_tpu/parallel/__init__.py:85-133``).

    Each shard draws *ndraw_per_shard* candidates inside the enlarged
    wrapping ellipsoid from its own stream (:func:`shard_seed`), filters
    and evaluates them; the results are all-gathered and the member
    counts summed.

    Returns ``f(keys, ell_ctr, ell_axes_T, ell_invcov, enlarge, Lmin) ->
    (u, v, logl, accepted, ncall)``: *keys* (nshards, 2) uint32 host
    keys, one per shard; the outputs are the same on every shard, ncall a
    0-d int64 tensor.
    """
    mesh, axis_name = check_mesh(mesh, axis_name)
    nshards = shard_count(mesh, axis_name)
    index = shard_index(mesh, axis_name)
    device = torch.device(device)
    gen = torch.Generator(device=device)

    def f(keys, ell_ctr, ell_axes_T, ell_invcov, enlarge, Lmin):
        keys = np.asarray(keys, np.uint32).reshape(nshards, 2)
        gen.manual_seed(shard_seed(keys[index], index))
        ctr, axes_T, invcov = (torch.as_tensor(np.asarray(a, np.float32),
                                               device=device)
                               for a in (ell_ctr, ell_axes_T, ell_invcov))
        enlarge = float(np.float32(enlarge))
        z = torch.randn((ndraw_per_shard, x_dim), generator=gen,
                        device=device)
        z = z / torch.linalg.vector_norm(z, dim=1, keepdim=True)
        r = torch.rand((ndraw_per_shard, 1), generator=gen,
                       device=device) ** (1.0 / x_dim)
        u = ctr + (z * r * float(np.sqrt(np.float32(enlarge)))) @ axes_T
        dlt = u - ctr
        member = ((u > 0) & (u < 1)).all(dim=1) \
            & (((dlt @ invcov) * dlt).sum(dim=1) <= enlarge)
        v = transform(u)
        logl = loglike(v).to(torch.float32).masked_fill(~member, -np.inf)
        accepted = member & (logl > float(np.float32(Lmin)))
        ncall = member.sum()
        if mesh is None:
            return u, v, logl, accepted, ncall
        # gloo gathers no bool: the flags travel as uint8
        return (all_gather_rows(u, mesh, axis_name),
                all_gather_rows(v, mesh, axis_name),
                all_gather_rows(logl, mesh, axis_name),
                all_gather_rows(accepted.to(torch.uint8), mesh,
                                axis_name) != 0,
                psum(ncall, mesh, axis_name))
    return f
