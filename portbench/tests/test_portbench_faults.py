"""A whole run without the card's look, with the timed path broken
underneath (``portbench/faults.py``): ``correct`` comes out false for
each fault the cells can have, and true without one.
"""

import pytest
import torch

from portbench import harness
from portbench.faults import FAULTS, planted
from portbench.tests._small import CELLS, small_cell


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize('fault', sorted(FAULTS) + ['sound'])
@pytest.mark.parametrize('cell', CELLS)
def test_run_is_correct_only_without_a_fault(cell, fault):
    import contextlib
    workload, config = small_cell(cell)
    with planted(fault) if fault != 'sound' else contextlib.nullcontext():
        result, rows, _ = harness.run_cell(
            cell, workload, config, harness.benchmark_spec(), 2 ** 31 + 77,
            0.5, 0, device='cpu', force_segment=True)
    assert result['failed'] == 0 and result['attempted'] >= 1
    assert result['correct'] == (fault == 'sound'), rows
    assert list(result)[-1] == 'checks'
    assert set(result['metrics']) == {'fit_s', 'setup_s'}
