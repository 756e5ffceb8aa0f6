"""The port's host population samplers against the JAX package's.

``ultranest_torch.ops.stepfuncs`` and ``ultranest_torch.popstepsampler``
are carried over from the reference as host numpy code. Driven with the
same numpy seeds, every output must be bit-equal to the reference's.
"""
import numpy as np
import pytest

import ultranest_tpu.ops.stepfuncs as jsf
import ultranest_tpu.popstepsampler as jpss
import ultranest_torch.ops.stepfuncs as tsf
import ultranest_torch.popstepsampler as tpss


class _Layer:
    def __init__(self, u):
        self.mean, self.std = u.mean(axis=0), u.std(axis=0)
        self.axes = np.diag(self.std)

    def transform(self, x):
        return (x - self.mean) / self.std


class _Region:
    """The attributes the population samplers read from a region."""

    def __init__(self, u, maxradiussq=None):
        self.u = u
        self.transformLayer = _Layer(u)
        self.unormed = self.transformLayer.transform(u)
        self.maxradiussq = maxradiussq


def _live(seed, n=60, d=3):
    rng = np.random.RandomState(seed)
    u = np.clip(0.5 + 0.1 * rng.normal(size=(n, d)), 0.01, 0.99)
    return u, _loglike(u)


def _loglike(x):
    return -0.5 * (((x - 0.5) / 0.1) ** 2).sum(axis=1)


def _equal(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


GENERATORS = ['generate_cube_oriented_direction',
              'generate_cube_oriented_direction_scaled',
              'generate_random_direction',
              'generate_region_oriented_direction',
              'generate_region_random_direction',
              'generate_differential_direction',
              'generate_mixture_random_direction']


@pytest.mark.parametrize('name', GENERATORS)
def test_direction_generators_bit_equal(name):
    u, _ = _live(1)
    region = _Region(u)
    out = []
    for mod in (jsf, tsf):
        np.random.seed(5)
        out.append(getattr(mod, name)(u[:20], region, scale=0.7))
    _equal(out[0], out[1])


def _evolve_state(seed, P=40, d=3):
    rng = np.random.RandomState(seed)
    u = np.clip(0.5 + 0.1 * rng.normal(size=(P, d)), 0.01, 0.99)
    v = rng.normal(size=(P, d)) * 0.05
    t = np.where(rng.uniform(size=P) < 0.5, np.nan, 0.0)
    left = -rng.uniform(0.5, 2, size=P)
    right = rng.uniform(0.5, 2, size=P)
    sl = rng.uniform(size=P) < 0.3
    sr = rng.uniform(size=P) < 0.6
    return [u, _loglike(u), t, v, left, right, sl, sr]


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_evolve_and_step_back_bit_equal(seed):
    out = []
    for mod in (jsf, tsf):
        state = [a.copy() for a in _evolve_state(seed)]
        np.random.seed(seed)
        res = mod.evolve(lambda x: x, _loglike, -3.0, *state)
        allL = np.tile(_loglike(state[0])[:, None], (1, 5))
        allL[::3, 2] = -10.0
        gen = np.full(len(allL), 4, dtype=mod.int_dtype)
        cur = np.zeros(len(allL))
        mod.step_back(-3.0, allL, gen, cur)
        out.append((res, state, allL, gen, cur))
    _equal(out[0], out[1])


@pytest.mark.parametrize('seed', [0, 1])
def test_vectorised_slice_update_bit_equal(seed):
    out = []
    for mod in (jsf, tsf):
        rng = np.random.RandomState(seed)
        P, d = 32, 3
        t = rng.uniform(-1, 1, size=P)
        tleft, tright = -np.ones(P), np.ones(P)
        pu = rng.uniform(size=(P, d))
        pL = _loglike(pu)
        workers = np.arange(P, dtype=np.int64)
        status = np.zeros(P, dtype=np.int64)
        allu, allL, allp = np.zeros((P, d)), np.zeros(P), np.zeros((P, d))
        out.append(mod.update_vectorised_slice_sampler(
            t, tleft, tright, pL, pu, pu.copy(), workers, status, -2.0, 1.0,
            allu, allL, allp, P))
    _equal(out[0], out[1])


def _drive(mod, kind, ncalls, seed=3):
    u, L = _live(seed, n=80)
    region = _Region(u)
    f = getattr(mod, 'generate_mixture_random_direction')
    if kind == 'slice':
        s = mod.PopulationSliceSampler(
            popsize=16, nsteps=3, generate_direction=lambda x, r: f(x, r))
    elif kind == 'simple':
        s = mod.PopulationSimpleSliceSampler(
            popsize=16, nsteps=6, generate_direction=f,
            scale_adapt_factor=0.9)
    else:
        s = mod.PopulationRandomWalkSampler(
            popsize=16, nsteps=6, generate_direction=f, scale=0.5)
    np.random.seed(seed)
    outs = []
    # slice: a threshold inside the live set; the others must move every
    # walker, so below it
    Lmin = float(np.sort(L)[5]) if kind == 'slice' else float(L.min()) - 5
    for _ in range(ncalls):
        outs.append(s.__next__(region, Lmin, u, L, lambda x: x, _loglike))
    return outs, s.logstat, s.get_info_dict()


@pytest.mark.parametrize('kind,ncalls', [('slice', 40), ('simple', 20),
                                         ('walk', 20)])
def test_population_samplers_bit_equal(kind, ncalls):
    ref = _drive(jpss, kind, ncalls)
    port = _drive(tpss, kind, ncalls)
    assert any(o[0] is not None for o in ref[0])
    _equal(ref, port)


@pytest.mark.parametrize('maxr', [None, 1e300, 0.3])
def test_diagnostics_bit_equal(maxr):
    u, _ = _live(4)
    region = _Region(u, maxradiussq=maxr)
    rng = np.random.RandomState(0)
    uf = np.clip(u + 0.05 * rng.normal(size=u.shape), 0.01, 0.99)
    for fn in ('reference_sqdistance_info', 'reference_sqdistance'):
        _equal(getattr(jpss, fn)(region), getattr(tpss, fn)(region))
    _equal(jpss.diagnose_move_distances(region, u, uf),
           tpss.diagnose_move_distances(region, u, uf))
    for d in (2, 8, 50, 100):
        assert jpss.decorrelation_gm_target(d) == \
            tpss.decorrelation_gm_target(d)
    v = rng.normal(size=u.shape)
    _equal(jpss.unitcube_line_intersection(u, v),
           tpss.unitcube_line_intersection(u, v))
