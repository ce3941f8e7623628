"""Hands back what a heavy test module held once it ends: the files its
tests wrote and the heap it freed.

A pytest-xdist worker runs many test files in one process, and pytest keeps
every test's ``tmp_path`` until the session ends (and the last three
sessions' after it). A whole run of the suite on 6 workers wrote 8.6 GB of
temporary files (the auto-encoder Trainer tests' checkpoints alone ~5.5 GB,
~280 MB each) and left the workers holding 53 GB of a 62 GB host's memory:
glibc keeps a file's freed heap, so a worker stays at the high-water mark
of the heaviest file it ran (4-7 GB for each auto-encoder file). A run that
fills the disk fails its last tests all at once.

Importing the fixtures below into a module (``from tests.torch_release
import release_after_module, release_after_test  # noqa: F401``) deletes
each passing test's ``tmp_path`` after it and, after the module's last
test, the temporary directories its module fixtures created in this worker
(kept when one of its tests failed), then collects garbage and calls
glibc's ``malloc_trim(0)``. Measured on five auto-encoder files run in one
process: 7.0 GB resident after each fell to 1.6-1.8 GB, the peak from 11.6
to 7.8 GB. JAX's compiled programs are kept.
"""

import ctypes
import gc
import os
import shutil

import pytest


@pytest.fixture(scope="module", autouse=True)
def release_after_module(request, tmp_path_factory):
    base = tmp_path_factory.getbasetemp()
    before, failed = set(os.listdir(base)), request.session.testsfailed
    yield
    if request.session.testsfailed == failed:
        for name in set(os.listdir(base)) - before:
            shutil.rmtree(os.path.join(base, name), ignore_errors=True)
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):  # not glibc: nothing to hand back this way
        pass


@pytest.fixture(autouse=True)
def release_after_test(request, tmp_path):
    failed = request.session.testsfailed
    yield
    if request.session.testsfailed == failed:
        shutil.rmtree(tmp_path, ignore_errors=True)
