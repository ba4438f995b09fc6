"""The port's native loader builds ``libsvcio.so`` once when processes
load at the same time: the exists check and ``make`` run under an
exclusive file lock, so a second loader waits and finds a whole library."""

import os
import shutil
import subprocess
import sys

import pytest

from svc_tpu_torch.runtime import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_LOADER = """
import os, sys, time
import numpy as np
from svc_tpu_torch.runtime import native
d = sys.argv[1]
native._NATIVE_DIR = d
native._LIB_PATH = os.path.join(d, "libsvcio.so")
native._LOCK_PATH = os.path.join(d, "build", "native.lock")
real = native._build
def slow_build():
    with open(os.path.join(d, "builds.log"), "a") as f:
        f.write(f"{os.getpid()}\\n")
    time.sleep(1.0)  # hold the lock while the other process asks for it
    return real()
native._build = slow_build
assert native.load() is not None
coeffs = np.arange(3 * 8 * 8, dtype=np.float32).reshape(3, 8, 8)
raw = native.serialize_frame_native(coeffs, np.ones((1, 1), np.uint32), 8, 8)
types, back = native.deserialize_frame_native(raw, 3, 8, 8, 8, 8)
assert (back == coeffs).all() and types[0, 0] == 1
print("ok")
"""


@pytest.fixture
def scratch_native(tmp_path):
    if shutil.which("make") is None or shutil.which("g++") is None:
        pytest.skip("no make / g++ to build the native library")
    d = tmp_path / "native"
    d.mkdir()
    for name in ("Makefile", "svcio.cpp"):
        shutil.copy(os.path.join(REPO, "native", name), d / name)
    return d


def test_concurrent_loads_build_once(scratch_native):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = [subprocess.Popen([sys.executable, "-c", _LOADER, str(scratch_native)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert out.strip() == "ok"
    # one make: the second loader waited for the lock and found the library
    builds = (scratch_native / "builds.log").read_text().split()
    assert len(builds) == 1
    assert (scratch_native / "build" / "native.lock").exists()


def test_loader_takes_the_lock_around_the_build(monkeypatch, tmp_path):
    # the build runs while the lock is held, the load after it is released
    events = []
    lock_path = tmp_path / "build" / "native.lock"
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_LIB_PATH", str(tmp_path / "libsvcio.so"))
    monkeypatch.setattr(native, "_LOCK_PATH", str(lock_path))
    real_flock = native.fcntl.flock
    monkeypatch.setattr(native.fcntl, "flock",
                        lambda f, op: (events.append("lock"), real_flock(f, op)))
    monkeypatch.setattr(native, "_build", lambda: events.append("build") or False)
    assert native.load() is None
    assert events == ["lock", "build"]
    assert lock_path.exists()
    assert native._lib is None


def test_port_library_is_its_own_copy(monkeypatch, tmp_path, scratch_native):
    # the port builds and loads build/native/libsvcio.so, never the
    # native/libsvcio.so that other loaders build there without a lock: a
    # half-written file there (here: a truncated one) neither stops the
    # port's load nor is touched by it
    assert native._LIB_PATH == os.path.join(REPO, "build", "native", "libsvcio.so")
    assert os.path.dirname(native._LIB_PATH) != native._NATIVE_DIR
    partial = scratch_native / "libsvcio.so"
    partial.write_bytes(b"\x7fELF")
    lib_path = tmp_path / "build" / "native" / "libsvcio.so"
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_NATIVE_DIR", str(scratch_native))
    monkeypatch.setattr(native, "_LIB_PATH", str(lib_path))
    monkeypatch.setattr(native, "_LOCK_PATH", str(tmp_path / "build" / "native.lock"))
    assert native.load() is not None
    assert lib_path.stat().st_size > 4
    assert partial.read_bytes() == b"\x7fELF"
