"""The JAX package's native library, built once and loaded in every test
process before a port test compares against it.

The JAX package builds ``native/build/libmatrel_opt.so`` in place on
first use (``matrel_tpu/utils/native.py``: ``g++ -o <the library>``, no
temporary name, no lock between processes) and memoises a failed load
for the life of the process. Parallel test workers in a fresh checkout
race to build it; a worker that opens the file while another's ``g++``
is still writing it gets "file too short", and its chain DP, SpMV plan
fill and Matrix Market reader fall back to Python for good — costs
that differ from the native DP's within the nnz rounding, which the
port's exact comparisons then catch.

:func:`ensure_reference_native` runs at import of this module (every
test worker imports every test module while collecting, before it runs
a test) and of the port's test modules that compare through that
library. Under an ``flock`` on a file beside the library it rebuilds a
stale or unloadable library with the JAX package's own command into a
temporary name and renames it into place, clears a memoised failure and
requires the load to succeed. Nothing in the JAX package changes.
"""

import ctypes
import fcntl
import os
import shutil
import subprocess
import sys
import textwrap
import time

from matrel_tpu.utils import native as j_native

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _loads(path: str) -> bool:
    try:
        ctypes.CDLL(path)
        return True
    except OSError:
        return False


def ensure_reference_native():
    """The JAX package's native library, complete and loaded in this
    process (its ``load()`` handle); builds it under the lock where it
    is missing, stale or unloadable. Fails loudly without ``g++``."""
    lib_path = j_native._LIB_PATH
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    with open(lib_path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if j_native._stale() or not _loads(lib_path):
                srcs = [os.path.join(j_native._NATIVE_DIR, s)
                        for s in j_native._SOURCES]
                tmp = f"{lib_path}.{os.getpid()}.tmp"
                # the JAX package's own command (utils/native.py _build)
                subprocess.run(["g++", "-O3", "-fPIC", "-std=c++17",
                                "-pthread", "-shared", "-o", tmp] + srcs,
                               check=True, capture_output=True,
                               timeout=120)
                os.replace(tmp, lib_path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    with j_native._lock:
        if j_native._lib is None:
            j_native._tried = False       # forget a memoised failure
    lib = j_native.load()
    assert lib is not None, f"the JAX package's {lib_path} did not load"
    return lib


ensure_reference_native()


#: The race test: processes, their stagger (s) and the wall bound (s).
RACE_PROCS, RACE_STAGGER_S, RACE_TIMEOUT_S = 6, 0.5, 60.0

_RACER = textwrap.dedent("""
    import os, sys
    sys.path[:0] = [{here!r}, {repo!r}]
    import test_torch_native_guard as guard
    from matrel_tpu.utils import native as j_native
    d = {copy!r}
    with j_native._lock:
        j_native._NATIVE_DIR = d
        j_native._LIB_PATH = os.path.join(d, "build", "libmatrel_opt.so")
        j_native._lib, j_native._tried = None, False
    lib = guard.ensure_reference_native()
    print("LOADED", lib._name)
""")


def test_guard_survives_parallel_first_builds(tmp_path):
    """Six processes started RACE_STAGGER_S apart on a copy of native/
    with no build: each runs the guard and loads the copy's library."""
    copy = tmp_path / "native"
    copy.mkdir()
    for name in j_native._SOURCES:
        shutil.copy(os.path.join(REPO, "native", name), copy / name)
    code = _RACER.format(here=HERE, repo=REPO, copy=str(copy))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    t0 = time.monotonic()
    procs = []
    for _ in range(RACE_PROCS):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env))
        time.sleep(RACE_STAGGER_S)
    want = os.path.join(str(copy), "build", "libmatrel_opt.so")
    for p in procs:
        out, _ = p.communicate(
            timeout=max(RACE_TIMEOUT_S - (time.monotonic() - t0), 1.0))
        assert p.returncode == 0, out
        assert f"LOADED {want}" in out, out
    assert not [f for f in os.listdir(copy / "build")
                if f.endswith(".tmp")]
