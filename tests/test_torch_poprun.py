"""The port's population spec-walk path end to end, against the JAX package.

Both packages run the 8-d asymmetric gaussian (``bench.py:126-175`` cut
to d 8, popsize 128, 150 live points) with
``FusedPopulationSliceSampler(engine='spec')`` as the step sampler, a
``ScalingLayer`` and ``SimpleRegion``, on the CPU: the port through
``device='cpu'``, where the consume-scan kernel is served by its plain
torch version. Each logZ must sit inside the bench gate
``|logZ| < max(4 logzerr, 1.5)`` (``bench.py:356``), the two within 4
sigma of each other, and the results dicts and the step samplers'
``get_info_dict`` must carry the same keys. A third case runs upstream's
``run()`` defaults at 64 live points, where both packages go on to
improvement passes.
"""
import numpy as np
import pytest

import ultranest_tpu
import ultranest_tpu.models as jmodels
import ultranest_tpu.mlfriends as jml
import ultranest_tpu.popfused as jpop
import ultranest_torch
import ultranest_torch.mlfriends as tml
import ultranest_torch.popfused as tpop
from ultranest_torch.models import problems
from ultranest_torch.ops import kernels

RUN = dict(min_num_live_points=150, viz_callback=False, show_status=False,
           max_num_improvement_loops=0, min_ess=0, dlogz=2.0,
           frac_remain=0.1, cluster_num_live_points=0)
# upstream's run() defaults (dlogz 0.5, dKL 0.5, min_ess 400, frac_remain
# 0.01, improvement passes without limit, 40 live points a cluster), at
# the 64 live points that dlogz 0.5 asks at least: at d 8 a run with more
# meets its targets in the first pass
UPSTREAM_RUN = dict(min_num_live_points=64, viz_callback=False,
                    show_status=False)
POP = dict(popsize=128, nsteps=16, spec_depth=8, engine='spec')


def _run_ref(seed, run=RUN, **pop):
    prob = jmodels.asymgauss(ndim=8, sigma_min=0.01)
    s = ultranest_tpu.ReactiveNestedSampler(
        prob.param_names, prob.loglike, vectorized=True, seed=seed)
    s.transform_layer_class = jml.ScalingLayer
    s.stepsampler = jpop.FusedPopulationSliceSampler(
        jax_loglike=prob.jax_loglike, seed=seed, **dict(POP, **pop))
    return s, s.run(region_class=jml.SimpleRegion, **run)


def _run_port(seed, run=RUN, **pop):
    prob = problems.asymgauss(ndim=8, sigma_min=0.01)
    s = ultranest_torch.ReactiveNestedSampler(
        prob.param_names, prob.loglike, vectorized=True, seed=seed,
        device='cpu')
    s.transform_layer_class = tml.ScalingLayer
    s.stepsampler = tpop.FusedPopulationSliceSampler(
        torch_loglike=prob.torch_loglike, seed=seed, device='cpu',
        **dict(POP, **pop))
    kernels.reset_counts()
    return s, s.run(region_class=tml.SimpleRegion, **run)


def _gate(res):
    assert abs(res['logz']) < max(4 * res['logzerr'], 1.5), \
        (res['logz'], res['logzerr'])


def _passes(monkeypatch, cls):
    """The passes that runs of *cls* begin, counted into a list."""
    passes = []
    real = cls._begin_pass

    def begin(self, *args, **kw):
        passes.append(self)
        return real(self, *args, **kw)
    monkeypatch.setattr(cls, '_begin_pass', begin)
    return passes


# harvest_frac just below 1 still walks every walker to the end, but
# keeps the run off the segment path: the classic __next__ path;
# 'upstream' runs upstream's run() defaults, a segment pass and then
# improvement passes on the classic path
@pytest.mark.parametrize('mode,pop', [('segment', {}),
                                      ('classic', dict(harvest_frac=0.999)),
                                      ('upstream', {})])
def test_spec_path_matches_jax_package(mode, pop, monkeypatch):
    run = UPSTREAM_RUN if mode == 'upstream' else RUN
    ref_passes = _passes(monkeypatch, ultranest_tpu.ReactiveNestedSampler)
    passes = _passes(monkeypatch, ultranest_torch.ReactiveNestedSampler)
    ref, res_ref = _run_ref(2, run=run, **pop)
    port, res = _run_port(2, run=run, **pop)
    ss = port.stepsampler
    if mode == 'upstream':
        # improvement passes reached in both packages, the port's with
        # points of the walk taken into the tree
        assert len(ref_passes) >= 2 and len(passes) >= 2
        assert port._segment_phase_s['improve/walk/taken#'] >= 1
    else:
        assert len(ref_passes) == len(passes) == 1
    if mode in ('segment', 'upstream'):
        assert port._segment_exits, 'segment path never engaged'
        assert kernels.PLAIN_CALLS['consume_scan'] > 0
        assert ss.logstat and ss.ncalls_useful < ss.ncalls
    else:
        assert not getattr(port, '_segment_exits', None)
        assert kernels.PLAIN_CALLS['consume_scan'] == 0
        assert ss.logstat and ss.nrejects >= 0
    assert sum(kernels.LAUNCHES.values()) == 0          # no card here
    _gate(res)
    _gate(res_ref)
    sigma = np.hypot(res['logzerr'], res_ref['logzerr'])
    assert abs(res['logz'] - res_ref['logz']) < 4 * sigma
    assert sorted(res) == sorted(res_ref)
    assert sorted(ss.get_info_dict()) == \
        sorted(ref.stepsampler.get_info_dict())
    assert np.isfinite(res['samples']).all()
    assert res['samples'].shape[1] == 8
    assert res['ncall'] >= ss.ncalls
