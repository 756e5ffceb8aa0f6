"""The port's region-rejection slice end to end, against the JAX package.

Both packages run the same problems with the fused rejection segment
path forced on (``segment_enabled = True``), on the CPU: the port
through ``device='cpu'``, where every kernel wrapper is served by its
plain torch version. The port's logZ must sit inside the bench gate of
the truth (``bench.py:354-355``) and within 4 sigma of the JAX run, and
its results dict must carry the same keys.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import ultranest_tpu
import ultranest_torch
from ultranest_torch.models import problems
from ultranest_torch.ops import kernels

RUN = dict(viz_callback=False, show_status=False,
           max_num_improvement_loops=0, min_ess=0)


def _gauss_jax(t):
    return -0.5 * (((t - 0.5) / 0.1) ** 2).sum(axis=1) \
        - 1.5 * np.log(2 * np.pi * 0.01)


def _eggbox_jax(z):
    chi = jnp.cos(z[:, 0] / 2) * jnp.cos(z[:, 1] / 2)
    return (2 + chi) ** 5


def _eggbox_jax_transform(x):
    return x * 10 * jnp.pi


CASES = {
    # name: (problem, jax likelihood, jax transform, run options)
    'gauss3d': (problems.gauss(3), _gauss_jax, None,
                dict(min_num_live_points=128, dlogz=1.0, frac_remain=0.1)),
    'eggbox': (problems.eggbox(), _eggbox_jax, _eggbox_jax_transform,
               dict(min_num_live_points=200, dlogz=0.5, frac_remain=0.1,
                    Lepsilon=0.001)),
}


def _sampler(module, prob, seed, **model):
    transform = prob.transform if prob.transform is not None \
        else (lambda x: np.asarray(x))
    return module.ReactiveNestedSampler(
        prob.param_names, prob.loglike, transform=transform,
        vectorized=True, seed=seed, ndraw_min=512, ndraw_max=4096, **model)


@pytest.mark.parametrize('name', sorted(CASES))
def test_slice_matches_jax_package(name):
    prob, jax_ll, jax_tf, opts = CASES[name]
    ref = _sampler(ultranest_tpu, prob, 3, jax_loglike=jax_ll,
                   jax_transform=jax_tf)
    ref.fused_sampler.segment_enabled = True
    res_ref = ref.run(**RUN, **opts)

    kernels.reset_counts()
    port = _sampler(ultranest_torch, prob, 3,
                    torch_loglike=prob.torch_loglike,
                    torch_transform=prob.torch_transform, device='cpu')
    port.fused_sampler.segment_enabled = True
    res = port.run(**RUN, **opts)

    assert port._segment_exits, 'segment path never engaged'
    for k in kernels.KERNELS:
        assert kernels.PLAIN_CALLS[k] > 0, k
        assert kernels.LAUNCHES[k] == 0, k     # no card here
    assert sorted(res) == sorted(res_ref)
    assert abs(res['logz'] - prob.logz) < max(4 * res['logzerr'], 1.0), \
        (res['logz'], res['logzerr'], prob.logz)
    sigma = np.hypot(res['logzerr'], res_ref['logzerr'])
    assert abs(res['logz'] - res_ref['logz']) < 4 * sigma, \
        (res['logz'], res_ref['logz'], sigma)
    assert np.isfinite(res['samples']).all()
    assert res['samples'].shape[1] == prob.ndim


def test_run_directory_files_match(tmp_path):
    """A logged run writes the same run-directory files as the JAX one."""
    import os
    prob = problems.gauss(2)
    trees = []
    for module, model in (
            (ultranest_tpu, dict(jax_loglike=_gauss_jax)),
            (ultranest_torch, dict(torch_loglike=prob.torch_loglike,
                                   device='cpu'))):
        s = module.ReactiveNestedSampler(
            prob.param_names, prob.loglike, vectorized=True, seed=1,
            log_dir=str(tmp_path / module.__name__), ndraw_min=256,
            ndraw_max=1024, **model)
        s.run(**RUN, min_num_live_points=64, dlogz=2.0, frac_remain=0.5)
        top = s.logs['run_dir']
        trees.append(sorted(
            os.path.relpath(os.path.join(d, f), top)
            for d, _, fs in os.walk(top) for f in fs))
    assert trees[0] == trees[1]
