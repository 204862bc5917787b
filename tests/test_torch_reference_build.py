"""Steady loading of the JAX package's native libraries for the port's tests.

The reference builds its host libraries in place (parakeet_tpu/native.py:
`_build` and `build_capi` run g++ with `-o` straight onto the file under
parakeet_tpu/_native/, not through a temporary). A test process that opens
the file while another one is still writing it gets an OSError, and the
reference's `_load` then caches `_tried=True, _lib=None` for the rest of
that process: every comparison with the reference's native code would skip
or fail. The JAX package stays as it is, so the port's tests load it
through `reference_native` and `reference_capi`: one exclusive `flock` on a
lock file under build/parakeet_tpu_torch/ serialises the port's test
processes, and under it a failed load is retried, the module's cache
cleared each time, until a deadline of at least the reference's own 120 s
g++ timeout. Where g++ is present and the library still does not load, the
caller fails; only a missing g++ or libpython skips."""

import ctypes
import fcntl
import os
import shutil
import sysconfig
import threading
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest

from parakeet_tpu_torch.ops._build import BUILD_DIR

LOCK = BUILD_DIR / "reference_native.lock"
DEADLINE_S = 180.0  # > the reference's 120 s g++ timeout
POLL_S = 0.5


@contextmanager
def _exclusive():
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(LOCK, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _retry(load, what: str, deadline_s: float, poll_s: float):
    """load() under the lock until it returns something other than None;
    fails the test at the deadline."""
    with _exclusive():
        deadline = time.monotonic() + deadline_s
        while True:
            got = load()
            if got is not None:
                return got
            if time.monotonic() >= deadline:
                pytest.fail(f"the reference's {what} did not load within {deadline_s:.0f} s, although g++ is present")
            time.sleep(poll_s)


def reference_native(deadline_s: float = DEADLINE_S, poll_s: float = POLL_S):
    """parakeet_tpu.native with its library loaded."""
    from parakeet_tpu import native

    if os.environ.get("PARAKEET_NO_NATIVE"):
        pytest.skip("PARAKEET_NO_NATIVE is set: the reference's native library is turned off")
    if shutil.which("g++") is None:
        if not native.available():
            pytest.skip("g++ not present: the reference's native library cannot build")
        return native

    def load():
        if native._load() is not None:
            return native
        native._tried, native._lib = False, None
        return None

    return _retry(load, "native library", deadline_s, poll_s)


def reference_capi(deadline_s: float = DEADLINE_S, poll_s: float = POLL_S) -> Path:
    """The path of the reference's C API library, built and loadable."""
    from parakeet_tpu.native import build_capi

    if sysconfig.get_config_var("Py_ENABLE_SHARED") != 1:
        pytest.skip("no shared libpython: the reference's C API cannot embed the interpreter")
    if shutil.which("g++") is None:
        pytest.skip("g++ not present: the reference's C API cannot build")

    def load():
        path = build_capi()
        if path is None:
            return None
        try:
            ctypes.CDLL(str(path))
        except OSError:
            return None
        return path

    return _retry(load, "C API library", deadline_s, poll_s)


@pytest.mark.skipif(shutil.which("g++") is None, reason="g++ not present to build the reference's library")
def test_reference_native_recovers_from_a_half_written_library(tmp_path, monkeypatch):
    """A truncated library (a build still writing it) makes the reference's
    first load fail and cache the failure; the helper retries and loads the
    file once the whole of it is in place."""
    from parakeet_tpu import native as RN

    whole = Path(reference_native()._lib._name).read_bytes()
    monkeypatch.setattr(RN, "_CACHE", tmp_path)
    monkeypatch.setattr(RN, "_tried", False)
    monkeypatch.setattr(RN, "_lib", None)
    lib = tmp_path / RN._LIB_NAME
    # the first bytes of the ELF header, as a linker that has just begun
    # writing leaves the file (a cut past the program headers would map
    # pages beyond the end of the file, and touching those raises SIGBUS);
    # newer than the sources, so `_build` takes it as built
    lib.write_bytes(whole[:32])
    assert RN._load() is None and RN._tried and not RN.available()

    def finish():
        time.sleep(1.0)
        part = tmp_path / "whole.part"
        part.write_bytes(whole)
        os.replace(part, lib)

    writer = threading.Thread(target=finish)
    writer.start()
    try:
        got = reference_native(deadline_s=60.0, poll_s=0.1)
    finally:
        writer.join()
    assert got is RN and RN._lib is not None and Path(RN._lib._name) == lib
    assert RN.int16_to_float(np.array([16384], np.int16))[0] == 0.5


@pytest.mark.skipif(shutil.which("g++") is None, reason="g++ not present to build the reference's library")
def test_reference_native_fails_where_the_library_never_loads(tmp_path, monkeypatch):
    """With g++ present, a library that never becomes whole fails the
    caller at the deadline instead of skipping."""
    from parakeet_tpu import native as RN

    whole = Path(reference_native()._lib._name).read_bytes()
    monkeypatch.setattr(RN, "_CACHE", tmp_path)
    monkeypatch.setattr(RN, "_tried", False)
    monkeypatch.setattr(RN, "_lib", None)
    (tmp_path / RN._LIB_NAME).write_bytes(whole[:32])
    with pytest.raises(pytest.fail.Exception, match="did not load within"):
        reference_native(deadline_s=0.3, poll_s=0.1)
