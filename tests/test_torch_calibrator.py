"""The port's step-count calibrator against the JAX package, on the CPU.

Mirrors the calibrator cases of ``tests/test_aux_modules.py:294-339``.
``ReactiveNestedCalibrator`` clones the prototype step sampler for every
rung by constructor introspection (``calibrator.py:85-98``), so every
constructor argument of the port's step samplers, population engines
and trajectory samplers must be an attribute of the same name: a clone
equals its prototype in every argument but nsteps and the log file.
The ladder itself is held to the reference per numpy seed (host slice
sampler: equal logZ in every rung), and the population engine's ladder
to the reference test's own checks (nsteps 4, 8, 16, a fresh clone per
rung).
"""
import inspect

import numpy as np
import pytest
import torch

import ultranest_tpu.calibrator as jcal
from ultranest_torch import calibrator as tcal
from ultranest_torch import dychmc, dyhmc, pathsampler, popfused
from ultranest_torch import popstepsampler as tps
from ultranest_torch import stepsampler as tss
from ultranest_torch.models import problems

CPU = 'cpu'
RUN = dict(min_num_live_points=50, viz_callback=False, show_status=False,
           max_num_improvement_loops=0, min_ess=0, dlogz=2.0,
           frac_remain=0.5)


def loglike(theta):
    return -0.5 * (((theta - 0.5) / 0.1) ** 2).sum(axis=1)


def torch_loglike(theta):
    return -0.5 * (((theta - 0.5) / 0.1) ** 2).sum(dim=1)


def _tlg(u):
    return u, 0.0, -u


# each sampler with every argument away from its default where it can be
PROTOTYPES = {
    'SliceSampler': (tss.SliceSampler, dict(
        nsteps=3, generate_direction=tss.generate_region_random_direction,
        scale=0.7, check_nsteps='move-distance',
        adaptive_nsteps='proposal-total-distances', max_nsteps=77,
        region_filter=True,
        starting_point_selector=tss.select_random_livepoint)),
    'MHSampler': (tss.MHSampler, dict(
        nsteps=3, generate_direction=tss.generate_random_direction,
        scale=0.3, max_nsteps=50)),
    'PopulationRandomWalkSampler': (tps.PopulationRandomWalkSampler, dict(
        popsize=16, nsteps=3,
        generate_direction=tss.generate_cube_oriented_direction, scale=0.2,
        scale_adapt_factor=0.8, scale_min=1e-3, scale_max=2.0)),
    'PopulationSliceSampler': (tps.PopulationSliceSampler, dict(
        popsize=16, nsteps=3,
        generate_direction=tss.generate_cube_oriented_direction, scale=0.5,
        scale_adapt_factor=0.8)),
    'PopulationSimpleSliceSampler': (tps.PopulationSimpleSliceSampler, dict(
        popsize=16, nsteps=3,
        generate_direction=tss.generate_cube_oriented_direction,
        scale_adapt_factor=0.8, adapt_slice_scale_target=3.0, scale=0.5,
        slice_limit=tps.slice_limit_to_unitcube, max_it=30,
        shrink_factor=2.0)),
    'FusedPopulationSliceSampler': (popfused.FusedPopulationSliceSampler,
                                    dict(
        popsize=32, nsteps=3, torch_loglike=torch_loglike,
        torch_transform=lambda u: u * 1.0, scale=0.9, max_it=40,
        scale_adapt_factor=0.8, adapt_slice_scale_target=3.0, seed=17,
        engine='async', harvest_frac=1.0, spec_depth=4,
        adaptive_nsteps=True, max_nsteps=99, spec_depth_auto=False,
        device=torch.device(CPU))),
    'FusedPopulationRandomWalkSampler': (
        popfused.FusedPopulationRandomWalkSampler, dict(
            popsize=32, nsteps=3, torch_loglike=torch_loglike, scale=0.2,
            scale_adapt_factor=0.8, target_acceptance=0.3, seed=5,
            adaptive_nsteps=True, max_nsteps=77,
            device=torch.device(CPU))),
    'SamplingPathStepSampler': (pathsampler.SamplingPathStepSampler,
                                dict(nsteps=3, nresets=4, scale=0.5)),
    'DynamicCHMCSampler': (dychmc.DynamicCHMCSampler, dict(
        scale=0.2, nsteps=3, adaptive_nsteps='move-distance', delta=0.8,
        nudge=1.1)),
    'DynamicHMCSampler': (dyhmc.DynamicHMCSampler, dict(
        ndim=2, nsteps=3, transform_loglike_gradient=_tlg, epsilon=0.2,
        invmassmatrix=2.0, adaptive_nsteps='move-distance', delta=0.8,
        nudge=1.1)),
}


@pytest.mark.parametrize('name', sorted(PROTOTYPES))
def test_clone_equals_its_prototype(name):
    cls, given = PROTOTYPES[name]
    proto = cls(**given)
    calib = tcal.ReactiveNestedCalibrator(['a', 'b'], loglike,
                                          transform=lambda x: x,
                                          vectorized=True, device=CPU)
    calib.stepsampler = proto
    clone = calib._build_run(8).stepsampler
    assert type(clone) is cls and clone is not proto and clone.nsteps == 8
    params = [p for p in inspect.signature(cls.__init__).parameters
              if p not in ('self', 'log', 'logfile')]
    for p in params:
        assert hasattr(proto, p), (name, p, 'not kept as an attribute')
        if p in given:
            assert getattr(proto, p) == given[p], (name, p)
        if p != 'nsteps':
            assert getattr(clone, p) == getattr(proto, p), (name, p)


def test_ladder_equals_the_reference():
    """Host slice sampler: every rung equal to the reference's per seed."""
    from ultranest_tpu import stepsampler as jss
    out = {}
    for name, cal, ss, kw in (('tpu', jcal, jss, {}),
                              ('torch', tcal, tss, dict(device=CPU))):
        np.random.seed(1)
        calib = cal.ReactiveNestedCalibrator(['a', 'b'], loglike,
                                             transform=lambda x: x,
                                             vectorized=True, seed=1, **kw)
        calib.stepsampler = ss.SliceSampler(
            nsteps=2, generate_direction=ss.generate_mixture_random_direction)
        calib.run(**RUN)
        out[name] = calib
    ref, got = out['tpu'], out['torch']
    assert got.nsteps == ref.nsteps and len(got.results) >= 3
    assert [r['logz'] for r in got.results] == \
        [r['logz'] for r in ref.results]
    assert [r['ncall'] for r in got.results] == \
        [r['ncall'] for r in ref.results]


def test_population_ladder():
    """``test_calibrator_popfused``: nsteps 4, 8, 16, a clone per rung."""
    prob = problems.gauss(ndim=4, sigma=0.1)
    calib = tcal.ReactiveNestedCalibrator(
        seed=1, device=CPU, **prob.sampler_kwargs(use_torch=False))
    calib.stepsampler = popfused.FusedPopulationSliceSampler(
        popsize=64, nsteps=4, torch_loglike=prob.torch_loglike, seed=1,
        device=CPU)
    result = calib.run(**RUN)
    assert np.isfinite(result['logz'])
    assert len(calib.results) >= 3
    assert calib.nsteps[:3] == [4, 8, 16]
    assert calib.sampler.stepsampler.nsteps == calib.nsteps[-1]
    assert calib.sampler.stepsampler is not calib.stepsampler
