"""The port's fuzzer (``examples/torch_port/testfeatures.py``) against
the JAX package's (``examples/testfeatures.py``), on the CPU.

* The port's ``generate_runargs`` draws the JAX one's dict, keys and
  values, for seeds 0-99: one ``random.seed`` names one configuration in
  both fuzzers.
* Seeds 25-36 run through the port with ``tests/test_fuzz.py``'s caps,
  each to the end and through the fuzzer's own 3-sigma check (no mesh
  here: a single process has world size 1; the JAX package's replay runs
  on 8 virtual devices and shards its ``mesh_devices=4`` draws).
* Four host-tier seeds (the sampler on the host, no torch likelihood,
  no mesh) give the JAX fuzzer's results: ncall and niter equal, logZ
  and logzerr within 1e-6. The host code is a copy and draws from the
  same numpy stream, so the two runs make the same decisions; the
  regions' float32 bootstrap radii can differ by one ulp (XLA on the
  CPU contracts the JAX package's multiply-adds into FMAs; ROADMAP.md
  section C), which moves the proposals by ~1e-9 and the likelihood
  values with them, but no decision.
"""
import random

import pytest

from torch_port_helpers import load_script, one_thread  # noqa: F401







# both fuzzers are called testfeatures.py: each loads under its own name
jax_fuzz = load_script('examples/testfeatures.py', 'jax_testfeatures')
torch_fuzz = load_script('examples/torch_port/testfeatures.py',
                         'torch_port_testfeatures')


def _runargs(module, seed, tmp_path):
    """*module*'s configuration for *seed* with test_fuzz.py's caps."""
    random.seed(seed)

    def choose(myargs):
        if random.random() < 0.25:
            return myargs[0]
        return random.choice(myargs)

    runargs = module.generate_runargs(choose)
    runargs['num_live_points'] = min(runargs['num_live_points'], 100)
    runargs['max_ncalls'] = min(runargs['max_ncalls'], 30000.0)
    runargs['x_dim'] = min(runargs['x_dim'], 6)
    runargs['min_ess'] = 0
    runargs['dlogz'] = max(runargs['dlogz'], 1.0)
    runargs['frac_remain'] = max(runargs['frac_remain'], 0.05)
    if runargs['log_dir'] is not None:
        runargs['log_dir'] = str(tmp_path / 'logs')
    return runargs


def _draw(module, seed):
    random.seed(seed)

    def choose(myargs):
        if random.random() < 0.25:
            return myargs[0]
        return random.choice(myargs)

    return module.generate_runargs(choose)


def test_generate_runargs_draws_the_jax_fuzzers_configurations():
    for seed in range(100):
        mine, ref = _draw(torch_fuzz, seed), _draw(jax_fuzz, seed)
        assert list(mine) == list(ref), seed
        assert mine == ref, seed


@pytest.mark.parametrize('seed', list(range(25, 37)))
def test_fuzzed_configuration_on_the_port(seed, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    runargs = _runargs(torch_fuzz, seed, tmp_path)
    res = torch_fuzz.main(torch_fuzz.AttrDict(runargs), device='cpu')
    if res is not None:
        assert res['logzerr'] > 0 and res['ncall'] >= res['niter'] > 0


def test_no_mesh_without_enough_ranks(tmp_path, monkeypatch):
    """``mesh_devices`` needs that many ranks: one process builds none
    (seed 28 draws ``mesh_devices=4`` with the torch likelihood)."""
    monkeypatch.chdir(tmp_path)
    runargs = _runargs(torch_fuzz, 28, tmp_path)
    assert runargs['mesh_devices'] == 4 and runargs['use_jax']
    assert torch_fuzz.world_size() == 1
    meshes = []
    import ultranest_torch.integrator as integ
    init = integ.ReactiveNestedSampler.__init__

    def spy(self, *args, **kwargs):
        meshes.append(kwargs.get('mesh'))
        return init(self, *args, **kwargs)

    monkeypatch.setattr(integ.ReactiveNestedSampler, '__init__', spy)
    torch_fuzz.main(torch_fuzz.AttrDict(runargs), device='cpu')
    assert meshes == [None]


# host-tier seeds of 25-36 (use_jax False, no popfused step sampler):
# 26 multigauss d 6 with PopulationSliceSampler, 31 gauss d 2 into a run
# directory, 32 gauss d 2 with RegionSliceSampler, 34 powergauss d 2 on
# SimpleRegion
@pytest.mark.parametrize('seed', [26, 31, 32, 34])
def test_host_tier_configuration_equals_the_jax_fuzzer(seed, tmp_path,
                                                       monkeypatch):
    monkeypatch.chdir(tmp_path)
    ref_args = _runargs(jax_fuzz, seed, tmp_path / 'jax')
    assert not ref_args['use_jax'] and ref_args['stepsampler'] != 'popfused'
    ref = jax_fuzz.main(jax_fuzz.AttrDict(ref_args))
    mine = torch_fuzz.main(torch_fuzz.AttrDict(
        _runargs(torch_fuzz, seed, tmp_path / 'torch')), device='cpu')
    assert (mine['ncall'], mine['niter']) == (ref['ncall'], ref['niter'])
    assert abs(mine['logz'] - ref['logz']) < 1e-6 * max(1.0, abs(ref['logz']))
    assert abs(mine['logzerr'] - ref['logzerr']) < 1e-6
