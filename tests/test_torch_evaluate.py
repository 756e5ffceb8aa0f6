"""The port's evaluation tools (``ultranest_torch.evaluate``) against
the JAX package's (``evaluate/``), on the CPU at small sizes.

* ``evaluate_sampling`` and ``viz_sampling``: host numpy step samplers
  on the same numpy seed, so the likelihood sequences, call counts,
  steps and recorded chains are equal exactly (the regions' float32
  radii agree bit for bit).
* ``bias_audit``, ``errbar_study``, ``governor_signal_study`` and
  ``mww_signal_study``: the device walks draw from different streams
  (Philox here, threefry there), so the runs are held to the same row
  keys and to their own gates (|z| < 4 against the analytic logZ), not
  to equal numbers.
* ``evaluate/evaluate_chains.py`` (not ported: it imports neither
  package) reads the chain log of the port's ``stepsampler``: the port
  writes the JAX package's file byte for byte.
* ``profile_run``: the host split of a spec-walk round sums to the
  round body's time.
"""
import cProfile
import json
import os
import pstats
import sys

import numpy as np
import pytest

_REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..')
# the JAX package's tools import their neighbours by bare name (as
# tests/test_shrinkage.py does)
sys.path.insert(0, os.path.join(_REPO, 'evaluate'))
sys.path.insert(0, _REPO)

import evaluate_sampling as jax_evs  # noqa: E402
from torch_port_helpers import load_script, one_thread  # noqa: E402,F401
from ultranest_torch.evaluate import bias_audit  # noqa: E402
from ultranest_torch.evaluate import errbar_study  # noqa: E402
from ultranest_torch.evaluate import evaluate_sampling  # noqa: E402
from ultranest_torch.evaluate import governor_signal_study  # noqa: E402
from ultranest_torch.evaluate import mww_signal_study  # noqa: E402
from ultranest_torch.evaluate import problems  # noqa: E402
from ultranest_torch.evaluate import profile_run  # noqa: E402
from ultranest_torch.evaluate import viz_sampling  # noqa: E402






# a small gaussian for the walk tools: d 3, 32 walkers, 4 steps
TINY = dict(factory='gauss', fkw=dict(ndim=3, sigma=0.1), popsize=32,
            nsteps=4)


def test_problems_are_the_jax_harness_copy():
    with open(os.path.join(_REPO, 'evaluate', 'problems.py')) as f:
        ref = f.read().split('"""', 2)[2]
    with open(problems.__file__) as f:
        mine = f.read().split('"""', 2)[2]
    assert mine == ref


@pytest.mark.parametrize('name,problem,ndim', [
    ('regionslice', 'circgauss', 2), ('popslice', 'circgauss', 2),
    ('cubeslice', 'shell', 2), ('regionball', 'pyramid', 3)])
def test_evaluate_sampling_equals_the_jax_harness(name, problem, ndim):
    ref = jax_evs.evaluate_warmed_sampler(
        problem, ndim, 50, 100, jax_evs.make_sampler(name, ndim, 2 * ndim),
        seed=1)
    mine = evaluate_sampling.evaluate_warmed_sampler(
        problem, ndim, 50, 100,
        evaluate_sampling.make_sampler(name, ndim, 2 * ndim), seed=1,
        device='cpu')
    np.testing.assert_array_equal(mine[0], ref[0])
    assert mine[1] == ref[1]
    np.testing.assert_array_equal(mine[2], ref[2])
    volume = problems.get_problem(problem, ndim)[2]
    for a, b in zip(evaluate_sampling.shrinkage_diagnostic(
            mine[0], volume, ndim, 50),
            jax_evs.shrinkage_diagnostic(ref[0], volume, ndim, 50)):
        np.testing.assert_array_equal(a, b)


def test_evaluate_sampling_main_runs(capsys):
    cdf_mean, ks = evaluate_sampling.main(
        ['--x_dim', '2', '--nlive', '50', '--nsteps', '100'], device='cpu')
    assert 0 < cdf_mean < 1 and 0 <= ks <= 1
    assert 'KS distance vs uniform' in capsys.readouterr().out


def test_viz_sampling_records_the_jax_chains(tmp_path):
    jax_viz = load_script('evaluate/viz_sampling.py', 'jax_viz_sampling')
    chains = []
    for mod, kw in ((jax_viz, {}), (viz_sampling, dict(device='cpu'))):
        loglike, grad, us, Ls, region = mod.prepare('circgauss', 2, 50,
                                                    seed=3, **kw)
        sampler = mod.make_sampler('regionslice', 2, 4)
        chains.append(mod.record_chains(sampler, loglike, grad, us, Ls,
                                        region, nchains=3))
    for a, b in zip(*chains):
        np.testing.assert_array_equal(a, b)
    out = tmp_path / 'viz.pdf'
    viz_sampling.plot('circgauss', 'regionslice', loglike, us, region,
                      chains[1], str(out))
    assert out.stat().st_size > 0


def test_chain_log_is_read_by_evaluate_chains(tmp_path):
    """The port's chain log has the JAX package's layout: both write the
    same file for the same seed, and ``evaluate_chains.analyse`` reads
    it."""
    from ultranest_torch import stepsampler
    from ultranest_tpu import stepsampler as jax_stepsampler
    chains = load_script('evaluate/evaluate_chains.py', 'evaluate_chains')
    files = []
    for mod, evs, kw, tag in (
            (jax_stepsampler, jax_evs, {}, 'jax'),
            (stepsampler, evaluate_sampling, dict(device='cpu'), 'torch')):
        path = tmp_path / ('chains_%s.txt' % tag)
        with open(path, 'w') as log:
            sampler = mod.RegionSliceSampler(nsteps=6, log=log)
            evs.evaluate_warmed_sampler('circgauss', 3, 40, 60, sampler,
                                        seed=4, **kw)
        files.append(path.read_bytes())
    assert files[0] == files[1] and len(files[1]) > 0
    verdict = chains.analyse(str(tmp_path / 'chains_torch.txt'))
    assert verdict in ('converged', 'NOT converged: increase nsteps')


def test_bias_audit_matches_the_jax_tool(monkeypatch, capsys):
    jax_audit = load_script('evaluate/bias_audit.py', 'jax_bias_audit')
    monkeypatch.setitem(jax_audit.PROBLEMS, 'tiny', TINY)
    monkeypatch.setitem(bias_audit.PROBLEMS, 'tiny', TINY)
    assert {k: v for k, v in bias_audit.PROBLEMS.items()} == \
        {k: v for k, v in jax_audit.PROBLEMS.items()}
    ref = jax_audit.audit('tiny', 2)
    mine = bias_audit.audit('tiny', 2, device='cpu')
    assert list(mine) == list(ref)
    assert [list(r) for r in mine['rows']] == [list(r) for r in ref['rows']]
    assert mine['bound'] == ref['bound'] and len(mine['z']) == 2
    for row in mine['rows']:
        assert abs((row['logz'] - row['truth']) / row['logzerr']) < 4
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('{')]
    assert json.loads(lines[-1])['problem'] == 'tiny'


def test_bias_audit_verdict_and_exit_code(monkeypatch, tmp_path):
    """The verdict |mean z| < 2.5/sqrt(N) and the exit code, on rows with
    known z (2, 2, 2: biased; 1, -1, 0: not)."""
    rows = [dict(logz=t, logzerr=1.0, truth=0.0) for t in (2.0, 2.0, 2.0)]
    assert not bias_audit.verdict('x', rows)['unbiased']
    rows = [dict(logz=t, logzerr=1.0, truth=0.0) for t in (1.0, -1.0, 0.0)]
    line = bias_audit.verdict('x', rows)
    assert line['unbiased'] and line['mean_z'] == 0.0
    assert line['bound'] == round(2.5 / np.sqrt(3), 3)
    for z, code in ((0.1, 0), (3.0, 1)):
        monkeypatch.setattr(bias_audit, 'run_one', lambda spec, seed, z=z,
                            **kw: dict(seed=seed, logz=z, logzerr=1.0,
                                       truth=0.0))
        out = tmp_path / ('audit%d.jsonl' % code)
        assert bias_audit.main(['--problem', 'shell8', '--seeds', '2',
                                '--device', 'cpu', '--out', str(out)]) \
            == code
        line = json.loads(out.read_text())
        assert line['problem'] == 'shell8' and line['device'] == 'cpu'


def _tiny_jax_study(monkeypatch, module):
    """*module* (a JAX study) made to run d 3 with 32 walkers."""
    import ultranest_tpu.models as jax_models
    import ultranest_tpu.popfused as jax_popfused
    gauss = jax_models.gauss
    monkeypatch.setattr(jax_models, 'gauss',
                        lambda ndim, sigma: gauss(ndim=3, sigma=sigma))
    cls = jax_popfused.FusedPopulationSliceSampler

    class Small(cls):
        def __init__(self, popsize, nsteps, *args, **kwargs):
            super().__init__(32, nsteps, *args, **kwargs)

    monkeypatch.setattr(jax_popfused, 'FusedPopulationSliceSampler', Small)


@pytest.mark.parametrize('study', ['governor_signal_study',
                                   'mww_signal_study'])
def test_signal_studies_match_the_jax_rows(study, monkeypatch, capsys):
    ref_mod = load_script('evaluate/%s.py' % study, 'jax_' + study)
    _tiny_jax_study(monkeypatch, ref_mod)
    mine_mod = dict(governor_signal_study=governor_signal_study,
                    mww_signal_study=mww_signal_study)[study]
    kw = dict(sigma=0.1) if study == 'governor_signal_study' else {}
    ref = ref_mod.run(8, seed=3, **kw)
    mine = mine_mod.run(8, seed=3, ndim=3, popsize=32, device='cpu', **kw)
    assert list(mine) == list(ref)
    assert np.isfinite(mine['logz']) and mine['logzerr'] > 0


def test_errbar_study_matches_the_jax_rows(monkeypatch):
    import bench
    from ultranest_torch import models
    from ultranest_tpu import models as jax_models
    ref = bench._run_popfused(jax_models.gauss(ndim=3, sigma=0.1), 3,
                              popsize=32, nsteps=4, adaptive_nsteps=False)
    ref.update(problem='tiny', popsize=32, nsteps=4, seed=3, adaptive=False,
               classic=False, sigma=None, wall_total=0.0)
    mine = errbar_study.run(models.gauss(ndim=3, sigma=0.1), 'tiny', 3, 32,
                            4, device='cpu')
    assert sorted(mine) == sorted(ref)
    assert abs(mine['logz']) < 4 * mine['logzerr']
    classic = errbar_study.run(models.gauss(ndim=3, sigma=0.1), 'tiny', 3,
                               32, 4, classic=True, device='cpu')
    assert classic['classic'] and classic['ncall'] > 0
    from ultranest_torch.popfused import FusedPopulationSliceSampler
    assert FusedPopulationSliceSampler.segment_ok.__name__ == 'segment_ok'


def test_profile_run_splits_the_round():
    pr = cProfile.Profile()
    pr.enable()
    row, sampler = profile_run.run_asymgauss50(seed=1, device='cpu', ndim=4,
                                               popsize=32, nsteps=4)
    pr.disable()
    assert row['rounds'] > 0 and row['phases_s']['launch'] > 0
    assert abs(row['logz'] - row['logz_expected']) < 4 * row['logzerr']
    stats = pstats.Stats(pr)
    split = profile_run.round_split(stats, row['rounds'])
    body = [v for k, v in stats.stats.items() if k[2] == 'round_body']
    total = 1e3 * sum(v[3] for v in body) / row['rounds']
    assert 'round_body (own)' in split
    assert sum(split.values()) == pytest.approx(total, rel=1e-6)
    assert 'function calls' in profile_run.top_entries(pr, 'tottime', 5)


def test_bias_audit_fixed_nsteps_entry():
    """The port's gauss100 entry at a fixed nsteps of 800: the bench's
    gauss100 with the governor off, held to the JAX record's gauss100;
    the JAX tool's own entries stay as they are."""
    spec = bias_audit.PORT_PROBLEMS['gauss100_fixed800']
    ref = bias_audit.PROBLEMS['gauss100']
    assert spec['nsteps'] == 800 and 'skw' not in spec
    assert spec['anchor'] == 'gauss100'
    assert {k: spec[k] for k in ('factory', 'fkw', 'popsize')} == \
        {k: ref[k] for k in ('factory', 'fkw', 'popsize')}
    assert not set(bias_audit.PORT_PROBLEMS) & set(bias_audit.PROBLEMS)


JAX_RECORD = os.path.join(_REPO, 'evaluate', 'records',
                          'bias_audit_anchors_r5_2026-08-20.json')
PORT_RECORD = os.path.join(
    _REPO, 'ultranest_torch', 'evaluate', 'records',
    'bias_audit_gauss100_h100_20seeds_2026-10-17.json')


def test_bias_audit_welch_comparison_against_a_jax_record(monkeypatch,
                                                         tmp_path):
    """Welch's t of the mean logZ equals scipy's unequal-variance t test
    on the port's 20-seed gauss100 record against the JAX package's; the
    CLI puts it in the audit line of a port entry, against its anchor."""
    import scipy.stats
    jax_rows = bias_audit.record_rows(JAX_RECORD, 'gauss100')
    port_rows = bias_audit.record_rows(PORT_RECORD, 'gauss100')
    assert len(jax_rows) == 10 and len(port_rows) == 20
    w = bias_audit.welch(port_rows, jax_rows)
    ref = scipy.stats.ttest_ind([r['logz'] for r in port_rows],
                                [r['logz'] for r in jax_rows],
                                equal_var=False)
    assert w['t'] == round(float(ref.statistic), 3)
    assert w['p'] == round(float(ref.pvalue), 4)
    assert (w['n'], w['ref_n']) == (20, 10)
    assert abs(w['mean'] - 0.556) < 1e-3 and abs(w['ref_mean'] - 0.474) < 1e-3
    with pytest.raises(KeyError):
        bias_audit.record_rows(PORT_RECORD, 'gauss100_hard')
    monkeypatch.setattr(bias_audit, 'run_one', lambda spec, seed, **kw: dict(
        seed=seed, logz=0.1 * seed, logzerr=1.0, truth=0.0))
    out = tmp_path / 'fixed.jsonl'
    assert bias_audit.main(['--problem', 'gauss100_fixed800', '--seeds', '3',
                            '--device', 'cpu', '--out', str(out),
                            '--jax-record', JAX_RECORD]) == 0
    line = json.loads(out.read_text())
    assert line['problem'] == 'gauss100_fixed800'
    assert line['welch']['anchor'] == 'gauss100'
    assert line['welch']['n'] == 3 and line['welch']['ref_n'] == 10
    assert line['welch']['mean'] == 0.2
