"""The command as the check runs it: no result without a card or without
the program; on a card, a correct result line (marked ``cuda``)."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness

ROOT = harness.ROOT


def _run(cwd, *args, timeout=600):
    return subprocess.run(
        [sys.executable, 'portbench/run.py', '--workload', 'eggbox2d.live400',
         '--seed', str(2 ** 31 + 11), '--trace', '0', *args],
        cwd=cwd, capture_output=True, text=True, timeout=timeout)


def test_no_result_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    proc = _run(tmp_path, '--seconds', '1')
    assert proc.returncode != 0 and proc.stdout.strip() == ''
    assert 'ultranest_torch' in proc.stderr


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')


def test_no_result_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    proc = _run(ROOT, '--seconds', '1', timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ''
    assert 'CUDA' in proc.stderr


@pytest.mark.cuda
@pytest.mark.parametrize('trace', ['0', '1'])
def test_a_short_run_on_the_card(card, trace):
    proc = subprocess.run(
        [sys.executable, 'portbench/run.py', '--workload', 'eggbox2d.live400',
         '--seed', str(2 ** 31 + 13), '--seconds', '2', '--trace', trace],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line['correct'] and line['failed'] == 0
    assert line['device']['platform'] == 'gpu' and line['device']['count'] == 1
    assert list(line)[-1] == 'checks'
    if trace == '1':
        assert 0 < line['device']['busy_s'] < line['device']['window_s']
        assert 'kernel_roofline_pct' in line['metrics']
    else:
        assert set(line['metrics']) == {'fit_s', 'setup_s'}
