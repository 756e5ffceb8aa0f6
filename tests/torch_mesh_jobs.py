"""Child ranks of the port's mesh tests (``tests/test_torch_parallel.py``).

Run as ``python tests/torch_mesh_jobs.py JOB RANK WORLD PORT WORKDIR``,
one process per rank, all joined by a gloo process group on 127.0.0.1
(set ``GLOO_SOCKET_IFNAME=lo``). Imports torch and ``ultranest_torch``
only. Each rank reads ``WORKDIR/inputs.npz`` (written by the test) and
writes its results to ``WORKDIR/JOB_rankRANK.npz``; the tests compare
them. Both sides of an exact comparison are computed here, in one
process, so that thread counts cannot change a bit.

Jobs:

* ``shards`` (4 ranks, ``LOCAL_WORLD_SIZE=2``): the sharded bootstrap
  radius, region enlargements, KL table, segment dispatch (fed the
  banks the test wrote for each shard), rejection dispatch and
  ``parallel_propose_evaluate``, each on a 1-axis mesh, a (2, 2)
  ``('dcn', 'ranks')`` mesh and a (2, 2) mesh whose rank order differs
  from its shard order; ``slice_mesh``; the errors.
* ``runs`` (2 ranks): ``ReactiveNestedSampler(mesh=)`` on the rejection
  path and ``FusedPopulationSliceSampler(mesh=)`` on the segment path,
  whole runs.
"""
import copy
import hashlib
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)


def ll_torch(x):
    return -0.5 * (((x - 0.5) / 0.1) ** 2).sum(dim=1)


def ll_np(x):
    return -0.5 * (((x - 0.5) / 0.1) ** 2).sum(axis=1)


def l1_torch(x):
    """The L1 likelihood of ``tests/test_torch_popfused.py``: no rounding
    order can change its values."""
    center = (0.5, 0.45, 0.55)
    s = torch.abs(x[:, 0] - center[0]) + torch.abs(x[:, 1] - center[1])
    if x.shape[1] == 3:
        s = s + torch.abs(x[:, 2] - center[2])
    return -s


def raises(exc, fn, *args, **kwargs):
    try:
        fn(*args, **kwargs)
    except exc:
        return True
    return False


def digest(*arrays):
    h = hashlib.md5()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def mesh_outputs(name, mesh, inp, out):
    """Every sharded function on *mesh*; results under ``name_*`` keys."""
    from ultranest_torch import convert
    from ultranest_torch.fused import MAX_RETURN, FusedRegionSampler
    from ultranest_torch.mlfriends import (AffineLayer, MLFriends,
                                           ScalingLayer)
    from ultranest_torch.ops import kernels
    from ultranest_torch.ops.bootstrap import _bootstrap_radius
    from ultranest_torch.parallel import (parallel_propose_evaluate,
                                          shard_index, shard_seed)
    from ultranest_torch.parallel.launch import finish_fetch
    from ultranest_torch.popfused import FusedPopulationSliceSampler

    idx = shard_index(mesh)
    out[name + '_index'] = idx

    # bootstrap radius: 30 rounds (not a multiple of 4), and 3 (fewer
    # rounds than shards: every shard computes all of them)
    tp, masks = inp['radius_tpoints'], inp['radius_masks']
    kernels.reset_counts()
    out[name + '_radius'] = _bootstrap_radius(tp, masks, 'cpu', mesh=mesh)
    out[name + '_radius_calls'] = kernels.PLAIN_CALLS['bootstrap_radius']
    out[name + '_radius_few'] = _bootstrap_radius(tp, masks[:3], 'cpu',
                                                  mesh=mesh)
    if name == 'flat':
        out['radius_single'] = _bootstrap_radius(tp, masks, 'cpu')
        out['radius_few_single'] = _bootstrap_radius(tp, masks[:3], 'cpu')

    # region enlargement through the region API
    u = inp['enl_u']
    layer = ScalingLayer()
    layer.optimize(u, u)
    for key, m in ((name + '_enl_mesh', mesh), ('enl_single', None)):
        region = MLFriends(u, layer, device='cpu')
        out[key] = region.compute_enlargement(
            nbootstraps=24, rng=np.random.RandomState(3), mesh=m)

    # segment dispatch, fed this shard's banks
    for case in ('a', 'b'):
        d = int(inp['seg_%s_d' % case])
        port = FusedPopulationSliceSampler(
            popsize=int(inp['seg_popsize']), nsteps=int(inp['seg_nsteps']),
            torch_loglike=l1_torch, spec_depth=int(inp['seg_depth']),
            seed=0, device='cpu', mesh=mesh)
        if inp['seg_%s_treg_on' % case]:
            port._treg_key = (True, d)
        banks = convert.walk_banks('cpu', **{
            k: inp['seg_%s_b%d_%s' % (case, idx, k)]
            for k in ('xibank', 'i1', 'i2', 'jx', 'pick', 'idx0')})
        axes, tpack, treg = convert.walk_inputs(
            inp['seg_%s_axes' % case], inp['seg_%s_tpack' % case],
            inp['seg_%s_treg' % case], 'cpu')
        kernels.reset_counts()
        got = port._run_segment(
            banks, torch.as_tensor(inp['seg_%s_live_u' % case]),
            torch.as_tensor(inp['seg_%s_live_L' % case]),
            int(inp['seg_%s_nlive' % case]), axes, 1.0, treg, tpack)
        for k, a in zip(('lu2', 'lL2', 'packed', 'counts'), got):
            out['%s_seg_%s_%s' % (name, case, k)] = a.numpy()
        out['%s_seg_%s_scans' % (name, case)] = \
            kernels.PLAIN_CALLS['consume_scan']

    # rejection dispatch against the shards' dispatches done one by one
    ru = inp['rej_u']
    layer = AffineLayer()
    layer.optimize(ru, ru)
    region = MLFriends(ru, layer, device='cpu')
    region.maxradiussq, region.enlarge = region.compute_enlargement(
        nbootstraps=5, rng=np.random.RandomState(1))
    region.create_ellipsoid()
    Lmin = float(inp['rej_Lmin'])
    fs = FusedRegionSampler(ll_torch, None, ru.shape[1], seed=7, mesh=mesh,
                            device='cpu')
    nshards = fs.nshards
    keys = copy.deepcopy(fs._key_rng).integers(
        0, 2**32, size=(nshards, 2), dtype=np.uint32)
    handle, counts, _, _ = fs._launch(region, Lmin, 512)
    out[name + '_rej_gathered'] = finish_fetch(handle)
    out[name + '_rej_nc'] = int(finish_fetch(counts))
    inputs = fs._inputs(region)
    singles = [fs._propose(shard_seed(keys[s], s), inputs, Lmin,
                           max(128, 512 // nshards),
                           max(16, MAX_RETURN // nshards))
               for s in range(nshards)]
    out[name + '_rej_singles'] = torch.cat([p for p, _ in singles]).numpy()
    out[name + '_rej_singles_nc'] = sum(int(nc) for _, nc in singles)
    cu, cv, clogl, cnc, _ = fs(region, Lmin, 512)
    out[name + '_rej_call_u'] = cu
    out[name + '_rej_call_logl'] = clogl
    out[name + '_rej_call_nc'] = cnc

    f = parallel_propose_evaluate(mesh, ll_torch, lambda x: x, 2,
                                  ndraw_per_shard=64, device='cpu')
    pkeys = np.random.RandomState(0).randint(0, 2**32, size=(nshards, 2),
                                             dtype=np.uint32)
    res = f(pkeys, np.full(2, 0.5), np.eye(2) * 0.3, np.eye(2) / 0.09, 1.0,
            -10.0)
    for k, a in zip(('u', 'v', 'logl', 'acc', 'ncall'), res):
        out['%s_ppe_%s' % (name, k)] = a.numpy()


def job_shards(rank, world, work):
    from torch.distributed.device_mesh import DeviceMesh

    from ultranest_torch.fused import FusedRegionSampler
    from ultranest_torch.parallel import make_mesh, shard_count
    from ultranest_torch.parallel.launch import (fetch_replicated,
                                                 is_multiprocess_mesh,
                                                 shard_rows, slice_mesh)
    from ultranest_torch.parallel.strategy import bootstrap_kl_table
    from ultranest_torch.popfused import FusedPopulationSliceSampler

    inp = dict(np.load(os.path.join(work, 'inputs.npz')))
    out = {}
    meshes = dict(
        flat=make_mesh(world),
        grid=make_mesh(shape=(2, world // 2), axis_name=('dcn', 'ranks')),
        perm=DeviceMesh('cpu', torch.tensor([[1, 0], [3, 2]]),
                        mesh_dim_names=('dcn', 'ranks')))
    for name, mesh in meshes.items():
        mesh_outputs(name, mesh, inp, out)
    flat = meshes['flat']
    out['slice_shape'] = np.array(slice_mesh().mesh.shape)
    out['kl_mesh'], out['kl_mesh_tot'] = bootstrap_kl_table(
        inp['kl_ref'], inp['kl_other'], mesh=flat)
    out['kl_host'], out['kl_host_tot'] = bootstrap_kl_table(
        inp['kl_ref'], inp['kl_other'])
    out['multiprocess'] = is_multiprocess_mesh(flat)
    out['shard_rows'] = shard_rows(np.arange(8), meshes['perm'])
    out['shard_rows_ranks'] = shard_rows(np.arange(8), meshes['grid'],
                                         'ranks')
    out['count_ranks'] = shard_count(meshes['grid'], 'ranks')
    out['fetched'] = fetch_replicated(torch.arange(3))
    out['err_make_mesh'] = raises(ValueError, make_mesh, world - 1)
    out['err_make_mesh_shape'] = raises(
        ValueError, make_mesh, shape=(2, world), axis_name=('dcn', 'ranks'))
    out['err_popsize'] = raises(
        ValueError, FusedPopulationSliceSampler, popsize=6, nsteps=2,
        torch_loglike=ll_torch, device='cpu', mesh=flat)
    out['err_axis'] = raises(ValueError, FusedRegionSampler, ll_torch, None,
                             2, mesh=flat, axis_name='nope', device='cpu')
    np.savez(os.path.join(work, 'shards_rank%d.npz' % rank), **out)


def job_runs(rank, world, work):
    from ultranest_torch import ReactiveNestedSampler
    from ultranest_torch.parallel.launch import global_mesh
    from ultranest_torch.popfused import FusedPopulationSliceSampler

    mesh = global_mesh()
    out = {}
    opts = dict(show_status=False, viz_callback=False,
                max_num_improvement_loops=0, min_ess=0, dlogz=2.0,
                frac_remain=0.1)
    # the rejection path, candidate generation sharded
    s = ReactiveNestedSampler(['a', 'b'], ll_np, vectorized=True, seed=42,
                              torch_loglike=ll_torch, device='cpu', mesh=mesh)
    billed = []
    unpack = s.fused_sampler._unpack

    def spy(*args):
        r = unpack(*args)
        billed.append(r[3])
        return r
    s.fused_sampler._unpack = spy
    r = s.run(min_num_live_points=100, **opts)
    out.update(rej_logz=r['logz'], rej_logzerr=r['logzerr'],
               rej_ncall=r['ncall'], rej_niter=r['niter'],
               rej_billed=sum(billed), rej_nshards=s.fused_sampler.nshards,
               rej_digest=digest(r['weighted_samples']['points'],
                                 r['weighted_samples']['logl']))
    # the population segment path, walkers sharded, region rounds too
    s2 = ReactiveNestedSampler(['a', 'b'], ll_np, vectorized=True, seed=7,
                               device='cpu', mesh=mesh)
    ss = s2.stepsampler = FusedPopulationSliceSampler(
        popsize=16, nsteps=6, torch_loglike=ll_torch, seed=5, engine='spec',
        device='cpu', mesh=mesh)
    r2 = s2.run(min_num_live_points=50, **opts)
    out.update(pop_logz=r2['logz'], pop_logzerr=r2['logzerr'],
               pop_ncall=r2['ncall'], pop_niter=r2['niter'],
               pop_billed=ss.ncalls,
               pop_segments=sum(s2._segment_exits.values()),
               pop_digest=digest(r2['weighted_samples']['points'],
                                 r2['weighted_samples']['logl']))
    np.savez(os.path.join(work, 'runs_rank%d.npz' % rank), **out)


def main(argv):
    from ultranest_torch.parallel.launch import init_distributed
    job, rank, world, port, work = argv
    rank, world = int(rank), int(world)
    init_distributed(coordinator_address='127.0.0.1:%s' % port,
                     num_processes=world, process_id=rank, backend='gloo')
    try:
        {'shards': job_shards, 'runs': job_runs}[job](rank, world, work)
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()


if __name__ == '__main__':
    main(sys.argv[1:])
