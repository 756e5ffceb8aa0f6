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
