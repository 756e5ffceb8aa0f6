"""K1t, the transposed membership test, against the JAX package on the CPU.

On the CPU :func:`ultranest_torch.ops.kernels.radius_member_t` runs its
plain torch version. It is held, exactly, against

* the shootout script's Pallas body ``_member_kernel_t``
  (``evaluate/bench_pallas_membership.py``), run through a
  ``pl.pallas_call(..., interpret=True)`` built here the way the script
  builds it (the script itself has no interpret switch);
* the script's ``xla_member`` on the same inputs laid out row-major;
* the port's row-major K1 plain version;

with squared radii taken from the candidates' own nearest distances,
so that candidates sit exactly on the boundary (on a grid of quarters
for the JAX comparisons, where XLA's fused multiply-add and separate
roundings give the same sums; see ``_grid_inputs``). The CUDA kernel
is held against the plain version on a card by tests/test_torch_cuda.py.
"""
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ultranest_torch.evaluate import bench_membership
from ultranest_torch.ops import kernels

_SCRIPT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'evaluate', 'bench_pallas_membership.py')


def _shootout():
    spec = importlib.util.spec_from_file_location('bench_pallas_membership',
                                                  _SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SHOOTOUT = _shootout()


@functools.partial(jax.jit, static_argnames=('ndim',))
def _pallas_t_interpret(tp_t, tm, cd_t, r2, ndim):
    """``pallas_member_t`` of the script, in interpret mode."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    m = cd_t.shape[1]
    tile = min(1024, m)
    return pl.pallas_call(
        functools.partial(SHOOTOUT._member_kernel_t, ndim),
        grid=(m // tile,),
        in_specs=[
            pl.BlockSpec(tp_t.shape, lambda i: (0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((tp_t.shape[1],), lambda i: (0,),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((cd_t.shape[0], tile), lambda i: (0, i),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec(memory_space=pltpu.SMEM),
        ],
        out_specs=pl.BlockSpec((tile,), lambda i: (i,),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((m,), jnp.int32),
        interpret=True,
    )(tp_t, tm, cd_t, r2)


def _port_t(tp, tm, cd, r2):
    return kernels.radius_member_t(
        torch.as_tensor(np.ascontiguousarray(tp.T)), torch.as_tensor(tm),
        torch.as_tensor(np.ascontiguousarray(cd.T)), r2).numpy()


def _grid_inputs(npts, m, d, seed):
    """The shootout's inputs snapped to a grid of quarters.

    XLA on the CPU contracts ``acc + diff * diff`` into a fused
    multiply-add, so for general floats its sums can differ from the
    separately rounded ones in the last bit, exactly at the boundary.
    On a grid of quarters every difference, square and sum is exact in
    float32, so both arithmetics give the same distances and a radius
    taken from them puts candidates exactly on the boundary.
    """
    tp, tm, cd, _ = SHOOTOUT.make_inputs(npts, m, d, seed=seed)
    tp, cd = (np.round(a * 4) / 4 for a in (tp, cd))
    tm[::7] = 0                       # some invalid live points
    return tp.astype(np.float32), tm, cd.astype(np.float32)


# the shootout's shapes cut down (M a multiple of the script's tile)
@pytest.mark.parametrize('npts,m,d', [(64, 1024, 16), (96, 2048, 2),
                                      (128, 1024, 8), (50, 256, 3)])
def test_member_t_matches_pallas_and_xla_on_the_boundary(npts, m, d):
    tp, tm, cd = _grid_inputs(npts, m, d, seed=npts)
    valid = tm > 0
    radii, mind = bench_membership.boundary_radii(
        torch.as_tensor(tp[valid]), torch.as_tensor(cd), nradii=17)
    nboundary = 0
    for r2 in radii + [4.0 * d]:
        got = _port_t(tp, tm, cd, r2)
        pallas = np.asarray(_pallas_t_interpret(
            np.ascontiguousarray(tp.T), tm, np.ascontiguousarray(cd.T),
            np.asarray([r2], np.float32), ndim=d))
        xla = np.asarray(SHOOTOUT.xla_member(tp, tm, cd, np.float32(r2)))
        np.testing.assert_array_equal(got, pallas)
        np.testing.assert_array_equal(got.astype(bool), xla)
        on = (mind == r2).numpy()
        if r2 in radii:
            assert on.any() and got[on].all()
            nboundary += int(on.sum())
    assert nboundary >= len(radii)


@pytest.mark.parametrize('npts,m,d', [(64, 1024, 16), (96, 2048, 2),
                                      (128, 1024, 8)])
def test_member_t_equals_row_major_k1_on_the_boundary(npts, m, d):
    """General floats: K1t's arithmetic is K1's, bit for bit."""
    tp, tm, cd, _ = SHOOTOUT.make_inputs(npts, m, d, seed=npts)
    tm[::5] = 0
    radii, mind = bench_membership.boundary_radii(
        torch.as_tensor(tp[tm > 0]), torch.as_tensor(cd), nradii=65)
    for r2 in radii:
        got = _port_t(tp, tm, cd, r2)
        row_major = kernels.radius_member(
            torch.as_tensor(tp), torch.as_tensor(tm), torch.as_tensor(cd),
            r2).numpy()
        np.testing.assert_array_equal(got, row_major)
        on = (mind == r2).numpy()
        assert on.any() and got[on].all()


def test_member_t_plain_route_and_checks():
    kernels.reset_counts()
    tp_t = torch.zeros((2, 4))
    out = kernels.radius_member_t(tp_t, torch.ones(4, dtype=torch.int32),
                                  torch.zeros((2, 8)), 0.5)
    assert out.dtype == torch.int32 and out.tolist() == [1] * 8
    assert kernels.PLAIN_CALLS['radius_member_t'] == 1
    assert sum(kernels.LAUNCHES.values()) == 0
    empty = kernels.radius_member_t(tp_t, torch.ones(4, dtype=torch.int32),
                                    torch.zeros((2, 0)), 0.5)
    assert empty.shape == (0,)
    meta = torch.zeros((2, 4), device='meta')
    with pytest.raises(ValueError):
        kernels.radius_member_t(meta, torch.ones(4, dtype=torch.int32),
                                torch.zeros((2, 8)), 0.5)


@pytest.mark.parametrize('npts,m,d', [(32, 256, 16), (64, 512, 2)])
def test_shootout_check_on_cpu(npts, m, d):
    """The shootout's correctness check at 65 boundary radii (plain route)."""
    assert bench_membership.check_shape(npts, m, d, 'cpu') >= 65
    tp, tm, cd, r2 = bench_membership.make_inputs(npts, m, d)
    ref = SHOOTOUT.make_inputs(npts, m, d)
    for a, b in zip((tp, tm, cd, r2), ref):
        np.testing.assert_array_equal(a, b)


# ------------- K1t's decomposition: strides, signed mask, groups, tiles -----

def _k1t_model(tp_t, tm, cd_t, r2, G, tile, threads=256, seed=0):
    """numpy model of ``csrc/member_kernel.cuh`` on axis-major operands.

    Every operand is read through its two strides from the flat buffer
    (point i's axis k at ``base[i * 1 + k * N]``, a candidate's at
    ``base[j * 1 + k * M]``). A block of 256 // G candidates keeps them
    in registers (d <= 32: the next of 4, 8, 16, 32 axes, zero above d)
    or stages them as [k][candidate] (d > 32); per tile of *tile* live
    rows it squeezes out the rows whose mask is above 0 (in an order the
    kernel does not fix: here a permutation), then G lanes share a
    candidate, lane g testing rows g, g + G, ..., eight at a time; after
    each chunk the warp votes, a group with a hit stops, and the warp
    leaves once all of its groups have one. The block leaves the tile
    loop once all its candidates have a hit. Sums are float32 in axis
    order, the subtract, multiply and add each rounded.
    """
    d, N = tp_t.shape
    M = cd_t.shape[1]
    tp_flat, cd_flat = tp_t.ravel(), cd_t.ravel()
    r2 = np.float32(r2)
    rng = np.random.RandomState(seed)
    ncb, per_warp = threads // G, 32 // G
    out = np.zeros(M, bool)
    for j0 in range(0, M, ncb):
        js = j0 + np.arange(ncb)
        active = js < M
        if d <= 32:
            D = next(D for D in (4, 8, 16, 32) if d <= D)
            c = np.zeros((ncb, D), np.float32)
            c[active, :d] = cd_flat[js[active, None] + np.arange(d) * M]
        else:
            sh_c = np.zeros(d * ncb, np.float32)
            for t in np.flatnonzero(active):
                sh_c[np.arange(d) * ncb + t] = cd_flat[js[t]
                                                       + np.arange(d) * M]
            c = sh_c.reshape(d, ncb).T
        hit = ~active
        for row0 in range(0, N, tile):
            nrows = min(tile, N - row0)
            rows = row0 + rng.permutation(
                np.flatnonzero(tm[row0:row0 + nrows] > 0))
            nv = len(rows)
            sh_p = np.zeros((d, tile), np.float32)
            sh_p[:, :nv] = tp_flat[rows[None, :] + np.arange(d)[:, None] * N]
            acc = np.zeros((ncb, nv), np.float32)
            for k in range(d):
                diff = sh_p[k, :nv][None, :] - c[:, k][:, None]
                acc = acc + diff * diff
            within = acc <= r2
            for w in range(ncb // per_warp):
                grp = slice(w * per_warp, (w + 1) * per_warp)
                for base in range(0, nv, G * 8):
                    idx = [base + r * G + g for g in range(G)
                           for r in range(8) if base + r * G + g < nv]
                    found = within[grp][:, idx].any(axis=1)
                    hit[grp] |= found & ~hit[grp]
                    if hit[grp].all():
                        break
            if row0 + tile < N and hit.all():
                break
        out[js[active]] = hit[active]
    return out


def _signed_inputs(npts, m, d, seed):
    rng = np.random.RandomState(seed)
    tp = rng.normal(size=(npts, d)).astype(np.float32)
    cd = rng.normal(size=(m, d)).astype(np.float32)
    tm = np.array([1, 1, 0, -1], np.int32)[np.arange(npts) % 4]
    return (np.ascontiguousarray(tp.T), tm, np.ascontiguousarray(cd.T))


def _plain_t(tp_t, tm, cd_t, r2):
    return kernels.radius_member_t_plain(
        torch.as_tensor(tp_t), torch.as_tensor(tm), torch.as_tensor(cd_t),
        float(r2)).numpy().astype(bool)


# d 3 and 16: the candidate in registers; d 40: staged; 200 live rows in
# tiles of 64; 333 candidates: a ragged last block for every G
@pytest.mark.parametrize('d', [3, 16, 40])
@pytest.mark.parametrize('G', [1, 2, 4, 8, 16, 32])
def test_member_t_group_model_equals_plain(G, d):
    tp_t, tm, cd_t = _signed_inputs(200, 333, d, seed=G + d)
    valid = tm > 0
    radii, mind = bench_membership.boundary_radii(
        torch.as_tensor(np.ascontiguousarray(tp_t.T[valid])),
        torch.as_tensor(np.ascontiguousarray(cd_t.T)), nradii=5)
    sign_matters = False
    for r2 in radii:
        want = _plain_t(tp_t, tm, cd_t, r2)
        got = _k1t_model(tp_t, tm, cd_t, r2, G, tile=64)
        np.testing.assert_array_equal(got, want)
        on = (mind == r2).numpy()
        assert on.any() and want[on].all()
        # one tile, as a launch with few live rows has it
        np.testing.assert_array_equal(
            _k1t_model(tp_t, tm, cd_t, r2, G, tile=200), want)
        # K1's plain version on the rows laid out row-major, with the
        # valid rows as its mask
        row_major = kernels.radius_member_plain(
            torch.as_tensor(np.ascontiguousarray(tp_t.T)),
            torch.as_tensor(valid.astype(np.int32)),
            torch.as_tensor(np.ascontiguousarray(cd_t.T)), r2).numpy()
        np.testing.assert_array_equal(want, row_major.astype(bool))
        sign_matters |= not np.array_equal(
            want, _plain_t(tp_t, np.abs(tm), cd_t, r2))
    assert sign_matters


@pytest.mark.parametrize('case', ['all_masked', 'all_negative', 'r2_zero',
                                  'r2_max', 'nan_candidate'])
@pytest.mark.parametrize('G', [1, 8, 32])
def test_member_t_group_model_edges(G, case):
    tp_t, tm, cd_t = _signed_inputs(100, 65, 5, seed=G)
    r2 = 0.5
    if case == 'all_masked':
        tm[:] = 0
    elif case == 'all_negative':
        tm[:] = -1
    elif case == 'r2_zero':
        r2 = 0.0
        cd_t[:, 4] = tp_t[:, 0]          # on a valid row
        cd_t[:, 9] = tp_t[:, 3]          # on a row whose mask is -1
    elif case == 'r2_max':
        r2 = float(np.finfo(np.float32).max)
        cd_t[:, 7] = 3e19                # its distances overflow to inf
    else:
        cd_t[1, 5] = np.nan
    want = _plain_t(tp_t, tm, cd_t, r2)
    np.testing.assert_array_equal(
        _k1t_model(tp_t, tm, cd_t, r2, G, tile=32), want)
    if case in ('all_masked', 'all_negative'):
        assert not want.any()
    elif case == 'r2_zero':
        assert want[4] and not want[9] and want.sum() == 1
    elif case == 'r2_max':
        assert not want[7] and want.sum() == 64
    else:
        assert not want[5] and want.any()


def test_member_t_takes_k1s_dimensions():
    """K1t's limit is the shared core's: d up to ``MAX_MEMBER_DIM``, a
    block's staged candidates within their shared memory."""
    assert not hasattr(kernels, 'MAX_MEMBER_T_DIM')
    for d in (33, 200, 201, kernels.MAX_MEMBER_DIM):
        for m in (1, 4096, 1 << 20):
            g = kernels.member_group_size(m, 512, d)
            assert (kernels._MEMBER_THREADS // g) * d * 4 \
                <= kernels._MEMBER_CAND_BYTES
    # the offsets of the largest operands pass 2**31: the kernel's are
    # 64-bit
    assert (kernels.MAX_MEMBER_DIM - 1) * (1 << 20) > 2 ** 31


@pytest.mark.cuda
@pytest.mark.parametrize('npts,m,d', [(64, 1024, 16), (96, 2048, 2),
                                      (128, 1024, 8), (50, 256, 3)])
def test_member_t_kernel_matches_pallas_on_a_card(npts, m, d):
    """The CUDA kernel against the Pallas body in interpret mode and
    against its plain version, on a grid of quarters (see
    ``_grid_inputs``); needs a CUDA device and jax side by side."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    tp, tm, cd = _grid_inputs(npts, m, d, seed=npts)
    tm[3::7] = -1
    dev = [torch.as_tensor(np.ascontiguousarray(a), device='cuda')
           for a in (tp.T, tm, cd.T)]
    radii, _ = bench_membership.boundary_radii(
        torch.as_tensor(tp[tm > 0]), torch.as_tensor(cd), nradii=17)
    for r2 in radii + [4.0 * d]:
        kernels.reset_counts()
        got = kernels.radius_member_t(*dev, r2)
        assert kernels.LAUNCHES['radius_member_t'] == 1
        assert torch.equal(got, kernels.radius_member_t_plain(*dev, r2))
        pallas = np.asarray(_pallas_t_interpret(
            np.ascontiguousarray(tp.T), tm, np.ascontiguousarray(cd.T),
            np.asarray([r2], np.float32), ndim=d))
        np.testing.assert_array_equal(got.cpu().numpy(), pallas)
