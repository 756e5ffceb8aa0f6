"""The harness finds every piece by name, derives seeds, refuses JAX and
reduces a trace; no card needed."""

import glob
import json
import os
import re
import sys
import types

import pytest

from portbench import harness, trace

ROOT = harness.ROOT
SPEC = harness.benchmark_spec()
CELLS = [w['name'] for w in SPEC['workloads']]
METRICS = [m['name'] for m in SPEC['per_layer']]
BOUNDS = sorted(os.path.basename(p)[:-3] for p in glob.glob(
    os.path.join(harness.BENCH_DIR, 'bounds', '*.py'))
    if not os.path.basename(p).startswith('_'))


@pytest.mark.parametrize('cell', CELLS)
def test_cell_loads_its_files_by_name(cell):
    workload, config = harness.load_cell(cell)
    entry = next(w for w in SPEC['workloads'] if w['name'] == cell)
    assert workload['config'] == entry['config'] == config['name']
    assert workload['traffic'] == entry['traffic']
    assert workload['chips'] == entry['chips']
    assert workload['why'] == entry['why']
    cfg = next(c for c in SPEC['configs'] if c['name'] == config['name'])
    assert cfg['file'] == 'portbench/configs/%s.json' % config['name']
    assert cfg['reduced'] == config['reduced']
    assert cfg['source'] == config['source']
    # every departure from upstream's defaults is listed, with its reason
    assumed = {a['key']: a for a in config['assumed']}
    assert sorted(assumed) == sorted(config['reduced'])
    assert all(a['why'] and a['used'] != a['upstream']
               for a in assumed.values())
    settings = dict(config['sampler'], **config['run'])
    for key, a in assumed.items():
        if key in settings:
            assert settings[key] == a['used'], key
        else:
            assert config[key] is not None, key
    assert not set(workload['run']) & set(config['run'])
    assert workload['check_fits'] >= 1
    for kind in ('problems', 'reference'):
        assert os.path.isfile(os.path.join(
            harness.BENCH_DIR, kind, config['problem'] + '.py'))
    limits = config['limits']
    from portbench.check import NUMBERS
    assert sorted(limits) == sorted(NUMBERS)
    assert all(isinstance(v, (int, float)) for v in limits.values())


@pytest.mark.parametrize('metric', METRICS)
def test_metric_reader_matches_its_entry(metric):
    mod = harness.load_module('metrics', metric)
    assert callable(mod.read)
    # nothing to read: no value, never a 0 share
    empty = types.SimpleNamespace(fits=[], trace=None, config={},
                                  workload={})
    assert mod.read(empty) is None


@pytest.mark.parametrize('name', BOUNDS)
def test_bound_names_an_entry_and_its_device_kernels(name):
    mod = harness.load_module('bounds', name)
    from ultranest_torch.ops import kernels
    assert mod.ENTRY == name and callable(getattr(kernels, mod.ENTRY))
    src = ''.join(open(p).read() for p in glob.glob(
        os.path.join(ROOT, 'ultranest_torch', 'csrc', '*')))
    for k in mod.KERNELS:
        assert re.search(r'\b%s\b' % k, src), k
    assert mod.ONCE and set(mod.ONCE) <= set(mod.KERNELS)


def test_bounds_from_shapes_and_counts():
    import torch
    k1 = harness.load_module('bounds', 'radius_member')
    rec = k1.record((torch.zeros(512, 2), torch.ones(512, dtype=torch.int32),
                     torch.zeros(4096, 2), 1.0),
                    torch.ones(4096, dtype=torch.int32), False)
    got = k1.bound_s(rec)
    # every candidate inside: one distance each, 7 operations
    assert got == pytest.approx(max(4096 * 7 / 67e12,
                                    4 * (512 * 2 + 512 + 4096 * 2 + 4096)
                                    / 3.35e12))
    assert k1.bound_s(k1.record((torch.zeros(8, 2),) * 3 + (1.0,),
                                None, True)) is None
    k3 = harness.load_module('bounds', 'consume_scan')
    valid = torch.tensor([1.0, 0.0, 1.0, 0.0, 0.0])
    rec = k3.record((torch.zeros(400), torch.zeros(5), valid), None, False)
    # rows up to the last valid one (3) take three compares a live value,
    # the two after it two
    assert k3.bound_s(rec) == pytest.approx(max(
        400 * (3 * 3 + 2 * 2) / 67e12, 4 * (2 * 400 + 2 * 5 + 5 * 5)
        / 3.35e12))
    assert k3.bound_s(k3.record((torch.zeros(400), torch.zeros(5), valid),
                                None, True)) is None
    k4 = harness.load_module('bounds', 'spec_propose')
    rec = k4.record((torch.zeros(4096, 50), None, None, None,
                     torch.zeros(3, 4096, 8), None), None, True)
    assert rec == dict(P=4096, d=50, D=8)
    assert k4.bound_s(rec) > 0


class _Calls:
    def __init__(self, calls):
        self.calls = calls


def test_kernel_executions_count_either_chain():
    """K3 runs its warp chain up to 1024 live slots and its CTA chain
    above: executions count both, so a graph's replays are still found
    (one launched call, two replays of a captured one)."""
    import torch
    k3 = harness.load_module('bounds', 'consume_scan')
    valid = torch.ones(4)
    ev = [_Ev(0, 1000, trace.WINDOW_SPAN, False, True),
          _Ev(10, 20, 'void (anonymous namespace)::scan_chain_cta(float)',
              True),
          _Ev(20, 30, 'void (anonymous namespace)::scan_counts(float)', True),
          _Ev(40, 50, 'void (anonymous namespace)::scan_chain_warp<32>(f)',
              True),
          _Ev(60, 70, 'void (anonymous namespace)::scan_chain_cta(float)',
              True)]
    calls = [(False, k3.record((torch.zeros(2048), torch.zeros(4), valid),
                               None, False)),
             (True, k3.record((torch.zeros(2048), torch.zeros(4), valid),
                              None, True))]
    tr = trace.Trace(ev, _Calls({'consume_scan': calls}),
                     {'consume_scan': k3})
    k = tr.kernels['consume_scan']
    assert k['executions'] == 3 and k['launched'] == 1
    assert k['device_s'] == pytest.approx(40e-9)
    assert k['bound_s'] is None      # a captured call has no valid rows


def test_fit_seeds_repeat_and_fit_the_sampler():
    for seed in (0, 7, 2 ** 31 + 5, 3 * 2 ** 40):
        seeds = [harness.fit_seed(seed, i) for i in range(50)]
        assert seeds == [harness.fit_seed(seed, i) for i in range(50)]
        assert all(0 <= s < 2 ** 31 for s in seeds)
        assert len(set(seeds)) == 50
    assert harness.fit_seed(1, 0) != harness.fit_seed(2, 0)


def test_check_seeds_are_drawn_from_the_run_seed_apart_from_the_pool():
    for seed in (0, 2 ** 31 + 5, 3 * 2 ** 40):
        seeds = harness.check_seeds(seed, 8)
        assert seeds == harness.check_seeds(seed, 8)
        assert all(0 <= s < 2 ** 31 for s in seeds) and len(set(seeds)) == 8
        pool = harness.FitOrder(dict(size=16, seed=seed), seed).pool
        assert not set(seeds) & set(pool)
    assert harness.check_seeds(1, 3) != harness.check_seeds(2, 3)


@pytest.mark.parametrize('name,caught', [
    ('jax', True), ('jax.numpy', True), ('jaxlib.xla_client', True),
    ('flax', True), ('ultranest_tpu', True), ('ultranest_tpu.popfused', True),
    ('ultranest_torch', False), ('ultranest_torch.popfused', False),
    ('jaxtyping', False), ('ultranest_tpu_extra', False)])
def test_jax_check_compares_whole_top_level_names(name, caught, monkeypatch):
    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    top = name.split('.')[0]
    assert (top in harness.forbidden_modules()) == caught
    if not caught:
        assert harness.forbidden_modules() == before


def test_union_of_overlapping_intervals():
    ev = [(0, 10, 'a'), (5, 15, 'b'), (15, 20, 'c'), (30, 40, 'd'),
          (32, 35, 'e'), (50, 50, 'empty')]
    assert trace.union(ev) == [(0, 20), (30, 40)]
    assert trace.union([]) == []


class _Ev:
    def __init__(self, start, end, name, cuda, note=False):
        self._v = (start, end, name, cuda, note)

    def start_ns(self):
        return self._v[0]

    def end_ns(self):
        return self._v[1]

    def name(self):
        return self._v[2]

    def device_type(self):
        from torch._C._autograd import DeviceType
        return DeviceType.CUDA if self._v[3] else DeviceType.CPU

    def is_user_annotation(self):
        return self._v[4]


def test_idle_share_and_gaps_on_synthetic_trace():
    events = [_Ev(0, 1000, trace.WINDOW_SPAN, False, True),
              _Ev(0, 600, 'fit.run', False, True),
              _Ev(600, 1000, 'fit.results', False, True),
              _Ev(100, 300, 'void spec_propose_kernel<4>(float*)', True),
              _Ev(200, 400, 'void spec_update_kernel<2>(float*)', True),
              _Ev(350, 380, 'Memcpy DtoH', True),
              _Ev(900, 1100, 'scan_counts(float const*)', True),
              # the device's copy of a host span is no work
              _Ev(0, 600, 'fit.run', True, True)]
    tr = trace.Trace(events, None, {})
    assert tr.window_s == pytest.approx(1e-6)
    # busy: [100, 400) and [900, 1000) after clipping to the window
    assert tr.busy_s == pytest.approx(400e-9)
    idle = harness.load_module('metrics', 'device_idle_pct').read(
        types.SimpleNamespace(trace=tr, fits=[]))
    assert idle == pytest.approx(60.0)
    gaps = dict(tr.idle_gaps())
    assert gaps['fit.run'] == pytest.approx(300e-9)     # [0,100) + [400,600)
    assert gaps['fit.results'] == pytest.approx(300e-9)  # [600, 900)
    assert sum(gaps.values()) == pytest.approx(tr.window_s - tr.busy_s)
    ops = dict(tr.device_ops())
    assert ops['spec_propose_kernel'] == pytest.approx(200e-9)


def test_benchmark_json_keeps_to_its_limits():
    name = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
    assert SPEC['command'] == ['python3', 'portbench/run.py']
    assert SPEC['paths'] == ['portbench']
    assert 1 <= SPEC['run_seconds'] <= 51
    names = [m['name'] for m in SPEC['end_to_end'] + SPEC['per_layer']]
    assert len(names) == len(set(names)) and all(map(name.match, names))
    assert {'fit_s', 'setup_s'} <= {m['name'] for m in SPEC['end_to_end']}
    for m in SPEC['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25
    for m in SPEC['per_layer']:
        assert set(m['workloads']) <= set(CELLS)
        assert m['moves'] == 'fit_s'
    for w in SPEC['workloads']:
        assert name.match(w['name']) and w['chips'] == 1
        assert len(w['why']) <= 200
    assert len(json.dumps(SPEC)) < 64 * 1024
