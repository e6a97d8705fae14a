"""Autouse fixtures for the port's tests that run scripts or processes
from the working directory: a test of the JAX package run earlier in the
same pytest worker can leave the process in a directory that has since
been deleted, and os.getcwd() (runscript, chdir, a child process) then
fails.  Such a test starts from the repository root instead.  Import
both names into a test module to use them."""

import os

import pytest

from .khmer_tst_utils import REPO_ROOT


def _leave_a_deleted_directory():
    try:
        os.getcwd()
    except FileNotFoundError:
        os.chdir(REPO_ROOT)


@pytest.fixture(autouse=True, scope="module")
def cwd_for_module():
    """Before the module's own module-scoped fixtures."""
    _leave_a_deleted_directory()


@pytest.fixture(autouse=True)
def cwd_for_test():
    _leave_a_deleted_directory()
