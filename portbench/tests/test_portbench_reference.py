"""The plain reference on fixed points, its truths and its roundings."""

import ast
import glob
import os

import numpy as np
import pytest

from portbench import harness
from portbench.reference import asymgauss, bfloat16, eggbox, exact, float32


def test_eggbox_on_fixed_points():
    u = np.array([[0.0, 0.0], [0.2, 0.4], [0.1, 0.0], [0.2, 0.3]])
    theta = eggbox.transform(u)
    np.testing.assert_allclose(theta, u * 10 * np.pi, rtol=1e-15)
    got = eggbox.loglike(theta)
    # a peak (both cosines 1) at 3^5, a valley (1 and -1) at 1, and 2^5
    # where a cosine is 0
    np.testing.assert_allclose(got, [243.0, 1.0, 32.0, 32.0], rtol=1e-13,
                               atol=1e-12)


def test_eggbox_quadrature_truth():
    # the midpoint rule converges as the grid's square: 4000 and 8000
    # points a side agree to well under the gate's floor of 1
    z4, z8 = eggbox.truth(4000), eggbox.truth(8000)
    assert abs(z4 - z8) < 1e-5
    assert abs(z4 - 235.856) < 1e-3


def test_asymgauss_on_fixed_points():
    c, s = asymgauss.constants(50, 0.01)
    assert s[0] == pytest.approx(0.1) and s[-1] == pytest.approx(0.01)
    norm = -0.5 * np.log(2 * np.pi * s ** 2).sum()
    one_sigma = c + s * (np.arange(50) % 2 * 2 - 1)
    got = asymgauss.loglike(np.stack([c, one_sigma]))
    np.testing.assert_allclose(got, [norm, norm - 25.0], rtol=1e-14)
    assert np.all(c - 2.5 * s > -1e-12) and np.all(c + 2.5 * s < 1 + 1e-12)


def test_asymgauss_truth_is_the_mass_inside_the_cube():
    from scipy.stats import norm
    c, s = asymgauss.constants(50, 0.01)
    want = np.log(norm.cdf((1 - c) / s) - norm.cdf(-c / s)).sum()
    assert asymgauss.truth(50, 0.01) == pytest.approx(want, abs=1e-12)
    assert -0.1 < asymgauss.truth(50, 0.01) < 0


def test_roundings():
    x = np.array([1.0, 1 + 2 ** -9, 1 + 3 * 2 ** -9, 243.0, 1 / 3, -0.0])
    np.testing.assert_array_equal(bfloat16(x), [1.0, 1.0, 1 + 2 ** -7,
                                                243.0, 0.333984375, -0.0])
    assert float32(1 / 3) == float(np.float32(1 / 3))
    assert exact(1 / 3) == 1 / 3
    assert np.isinf(bfloat16(np.inf))


@pytest.mark.parametrize('path', sorted(glob.glob(os.path.join(
    harness.BENCH_DIR, 'reference', '*.py'))))
def test_reference_imports_nothing_of_the_program(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split('.')[0])
    assert names <= {'math', 'numpy'}, names
