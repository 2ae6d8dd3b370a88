"""Remove what the port's tests write under pytest's temporary directory once
they pass.

A full-width flagship checkpoint with its optimizer state is 287 MB, and the
port's test modules once left 7.2 GB under ``/tmp/pytest-of-<user>`` in one
run, of which pytest keeps the last three.  A test module imports both
fixtures (autouse): :func:`drop_passed_tmp_path` removes a test's
``tmp_path`` when the test passed, and :func:`drop_module_tmp` removes the
directories the module made with ``tmp_path_factory`` when none of its tests
failed.  What a failed test or module wrote stays for inspection.
"""

import shutil

import pytest


@pytest.fixture(autouse=True)
def drop_passed_tmp_path(request):
    """The test's ``tmp_path``, if it took one, removed after it passed."""
    failed = request.session.testsfailed
    yield
    path = request.node.funcargs.get("tmp_path")
    if path is not None and request.session.testsfailed == failed:
        shutil.rmtree(path, ignore_errors=True)


@pytest.fixture(scope="module", autouse=True)
def drop_module_tmp(request, tmp_path_factory):
    """The directories made under this process's temporary base while the
    module ran, removed at its end when none of its tests failed."""
    base = tmp_path_factory.getbasetemp()
    before = set(base.iterdir())
    failed = request.session.testsfailed
    yield
    if request.session.testsfailed == failed:
        for path in set(base.iterdir()) - before:
            shutil.rmtree(path, ignore_errors=True)
