"""Small filesystem context helpers (role of reference
distributions/fileutil.py:31-62 — tmpdir/chdir contexts used by IO tests
and scripts)."""

import contextlib
import os
import shutil
import tempfile


@contextlib.contextmanager
def chdir(wd):
    oldwd = os.getcwd()
    try:
        os.chdir(wd)
        yield wd
    finally:
        os.chdir(oldwd)


@contextlib.contextmanager
def tempdir(cleanup_on_error=True):
    """Create, enter, and (on success — or always when cleanup_on_error)
    remove a temporary working directory."""
    oldwd = os.getcwd()
    wd = tempfile.mkdtemp()
    ok = False
    try:
        os.chdir(wd)
        yield wd
        ok = True
    finally:
        os.chdir(oldwd)
        if ok or cleanup_on_error:
            shutil.rmtree(wd, ignore_errors=True)
