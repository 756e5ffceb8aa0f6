"""The control fails the comparison: the reference in bfloat16, the
precision below the float32 that the configurations state for the device
likelihood, put in the program's place at the points of the same fits,
breaks at least one limit; the program's own numbers keep them all."""

import pytest
import torch

from portbench import check, control
from portbench.tests._small import CELLS, small_cell


@pytest.mark.parametrize('cell', CELLS)
def test_control_fails_and_program_passes(cell):
    torch.set_num_threads(1)
    workload, config = small_cell(cell)
    rows = control.readings(cell, [11, 2 ** 31 + 3], 0.5, device='cpu',
                            workload=workload, config=config,
                            force_segment=True, emit=lambda line: None)
    for row in rows:
        assert row['failed'] == 0 and row['fits'] >= 1
        assert check.judge(row['program'], config['limits'])[0], row
        assert not check.judge(row['bfloat16'], config['limits'])[0], row
    s = control.summary(rows)
    assert s['logl_gap']['control_min'] > 3 * s['logl_gap']['program_max']
