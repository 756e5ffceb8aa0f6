"""Helpers shared by the tests of the port's files outside the package
(``tests/test_torch_{examples,tutorials,fuzz,languages,evaluate,docs,
warm_eggbox}.py``), and the stand-in CUDA graphs of the walks' tests
(``tests/test_torch_{spec,sync}_round.py``)."""
import collections
import importlib.util
import os

import pytest
import torch

from ultranest_torch import popfused
from ultranest_torch.ops import kernels

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


class _StandIn:
    """A stand-in graph of *n* rounds: a replay runs the round body *n*
    times on the host, then the flag."""

    def __init__(self, body, flag, n):
        self.body, self.flag, self.n = body, flag, n

    def replay(self):
        for _ in range(self.n):
            self.body()
        self.flag()


class StandInGraphs(popfused.SpecGraphs):
    """SpecGraphs whose "graphs" run the round body on the host, so that
    the walks' graph path runs on the CPU. A capture runs the warm-up
    round, as a real one does, then for each n of *sizes* (kept in
    :attr:`captured`) books a graph whose replay adds n times the
    kernels one round calls (their plain versions, on the CPU) to
    ``kernels.LAUNCHES``; the round it runs to count them is left out of
    ``kernels.PLAIN_CALLS``, as a real capture launches nothing."""

    def capture(self, entry, sizes, body, flag):
        body()          # the warm-up round
        flag()
        for n in sizes:
            before = collections.Counter(kernels.PLAIN_CALLS)
            body()
            launched = collections.Counter(kernels.PLAIN_CALLS)
            launched.subtract(before)
            kernels.PLAIN_CALLS.clear()
            kernels.PLAIN_CALLS.update(before)
            entry.graphs[n] = (_StandIn(body, flag, n), collections.Counter(
                {k: n * c for k, c in launched.items() if c}))
        self.captured = list(sizes)
        return 0.0
