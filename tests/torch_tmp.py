"""Temporary directories that the port's test modules delete after use.

pytest keeps the temporary directories of its last three runs, and removes
the oldest only when a session ends, so every weight file, snapshot,
artifact and .bin record file a test leaves behind stays on disk through two
more runs. A module that imports ``tmp_path`` from here gets pytest's own
``tmp_path``, deleted when the test ends; a module-scoped fixture makes its
directory with ``module_dir`` and deletes it at the module's teardown.
"""

import contextlib
import shutil

import pytest


@pytest.fixture
def tmp_path(tmp_path):
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@contextlib.contextmanager
def module_dir(tmp_path_factory, name):
    """A new directory under pytest's base temporary directory, deleted
    when the ``with`` block ends."""
    path = tmp_path_factory.mktemp(name)
    try:
        yield path
    finally:
        shutil.rmtree(path, ignore_errors=True)
