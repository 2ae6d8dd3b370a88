"""One torch thread per test module, and for the CLIs the tests start.

The port's tests compute on small maps.  Under the tier-1 command's six
xdist workers on eight cores, torch's default of one intra-op thread per
core makes the threads of every worker wait on each other, and a test then
runs many times slower than alone.  A test module imports
:func:`one_torch_thread` (an autouse, module-scoped fixture) to compute on
one thread, and starts a child process with :func:`one_thread_env`.  A
test whose comparison depends on the thread count (ROADMAP.md, Queue 3)
keeps torch's default count with :func:`default_torch_threads`.
"""

import os

import pytest
import torch

DEFAULT_THREADS = torch.get_num_threads()  # before any fixture of this module ran


def one_thread_env(**extra):
    """The environment of a child process (``python -m
    radet_tpu_torch.tools.*``) that computes with torch on one thread:
    this process's, with ``OMP_NUM_THREADS=1`` and ``extra``."""
    return dict(os.environ, OMP_NUM_THREADS="1", **extra)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The importing module's torch work on one CPU thread; the old count
    is restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def default_torch_threads():
    """One test on torch's default thread count, inside a module on one
    thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(DEFAULT_THREADS)
    yield
    torch.set_num_threads(threads)
