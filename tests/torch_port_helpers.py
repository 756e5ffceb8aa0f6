"""Helpers shared by the tests of the port's files outside the package
(``tests/test_torch_{examples,tutorials,fuzz,languages,evaluate,docs,
warm_eggbox}.py``)."""
import importlib.util
import os

import pytest
import torch

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), '..')


def load_script(path, name):
    """Import the script at *path* (relative to the repository) as module
    *name*. The ported examples share their file names with the JAX
    package's, so neither directory goes on ``sys.path``."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread for each test. Host-tier runs make many small
    torch reductions on the CPU (the plain K2 of every region rebuild);
    with every core busy, as under several test workers, each parallel
    call waits ~20 ms for the thread pool, against ~0.2 ms on one
    thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
