"""ctypes bindings for the native host runtime (``native/svcio.cpp`` at the
root of the checkout), the port's own copy of ``svc_tpu/runtime/native.py``.

Provides the C++ implementations of the bitstream wire-format hot path and
the pipelined bitstream writer — the native counterpart of the reference's
C++ queue/writer/serializer runtime (libs/queue.hpp,
apps/encoder.cpp:151-173, libs/encoder.cpp:222-269).

The library is built on demand with ``make`` (g++); every entry point has
a pure-NumPy fallback so the port works without a native toolchain. The
build runs under an exclusive ``flock`` on ``build/native.lock`` at the
checkout root, held around the exists check and ``make``: processes that
load at once (pytest-xdist workers) build once, and the others wait and
find the whole library. It is loaded after the lock is released.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import sys
import threading
from typing import Optional, Tuple

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libsvcio.so")
_LOCK_PATH = os.path.join(_ROOT, "build", "native.lock")
_lib = None
_lib_lock = threading.Lock()


def _build() -> bool:
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return True
    except Exception:
        return False


def _ensure_built() -> bool:
    """Build the library unless it exists, under the cross-process lock."""
    try:
        os.makedirs(os.path.dirname(_LOCK_PATH), exist_ok=True)
        lock = open(_LOCK_PATH, "a")
    except OSError:  # no writable build/: build unlocked
        return os.path.exists(_LIB_PATH) or _build()
    with lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        return os.path.exists(_LIB_PATH) or _build()


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not _ensure_built():
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None

        lib.svc_serialize_frame.restype = ctypes.c_longlong
        lib.svc_serialize_frame.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.svc_deserialize_frame.restype = ctypes.c_longlong
        lib.svc_deserialize_frame.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.svc_serialize_blocks.restype = ctypes.c_longlong
        lib.svc_serialize_blocks.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
        ]
        lib.svc_writer_open.restype = ctypes.c_void_p
        lib.svc_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.svc_writer_push.restype = ctypes.c_int
        lib.svc_writer_push.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong
        ]
        lib.svc_writer_close.restype = ctypes.c_int
        lib.svc_writer_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def serialize_frame_native(
    coeffs: np.ndarray,
    block_types: np.ndarray,
    tb_w: int,
    tb_h: int,
) -> Optional[bytes]:
    """Native frame serialization; ``block_types`` must already be expanded
    to the transform-block grid. Returns None if the library is missing."""
    lib = load()
    if lib is None:
        return None
    coeffs = np.ascontiguousarray(coeffs, dtype=np.float32)
    types = np.ascontiguousarray(block_types, dtype=np.uint32)
    c, ph, pw = coeffs.shape
    nblocks = (ph // tb_h) * (pw // tb_w)
    out = np.empty(nblocks * (4 + 4 * tb_w * tb_h * c), np.uint8)
    n = lib.svc_serialize_frame(
        coeffs.ctypes.data, types.ctypes.data, c, ph, pw, tb_w, tb_h,
        out.ctypes.data,
    )
    assert n == out.nbytes
    return out.tobytes()


def serialize_blocks_native(
    coeff_blocks: np.ndarray, types: np.ndarray
) -> Optional[bytes]:
    """Native serialization for wire-block-layout coefficients
    ``(nby, nbx, C, bh, bw)`` — contiguous per-block memcpy."""
    lib = load()
    if lib is None:
        return None
    blocks = np.ascontiguousarray(coeff_blocks, dtype=np.float32)
    types = np.ascontiguousarray(types, dtype=np.uint32)
    nby, nbx, c, tbh, tbw = blocks.shape
    n_blocks = nby * nbx
    block_floats = c * tbh * tbw
    out = np.empty(n_blocks * (4 + 4 * block_floats), np.uint8)
    n = lib.svc_serialize_blocks(
        blocks.ctypes.data, types.ctypes.data, n_blocks, block_floats,
        out.ctypes.data,
    )
    assert n == out.nbytes
    return out.tobytes()


def deserialize_frame_native(
    data: bytes, channels: int, ph: int, pw: int, tb_w: int, tb_h: int
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    lib = load()
    if lib is None:
        return None
    nby, nbx = ph // tb_h, pw // tb_w
    expected = nby * nbx * (4 + 4 * tb_w * tb_h * channels)
    if len(data) < expected:
        raise ValueError("failed to read all expected blocks")
    buf = np.frombuffer(data, np.uint8, count=expected)
    types = np.empty((nby, nbx), np.uint32)
    coeffs = np.empty((channels, ph, pw), np.float32)
    lib.svc_deserialize_frame(
        buf.ctypes.data, channels, ph, pw, tb_w, tb_h,
        types.ctypes.data, coeffs.ctypes.data,
    )
    return types, coeffs


class NativeWriter:
    """Pipelined bitstream writer backed by the C++ queue + thread."""

    def __init__(self, path: Optional[str], capacity: int = 10):
        lib = load()
        if lib is None:
            raise RuntimeError("native runtime unavailable")
        self._lib = lib
        self._handle = lib.svc_writer_open(
            (path or "").encode(), capacity
        )
        if not self._handle:
            raise OSError(f"failed to open {path!r} for writing")

    def push(self, data: bytes) -> None:
        buf = np.frombuffer(data, np.uint8)
        rc = self._lib.svc_writer_push(
            self._handle, buf.ctypes.data, buf.nbytes
        )
        if rc != 0:
            raise OSError("Failed to write bytes.")

    def close(self) -> None:
        if self._handle:
            rc = self._lib.svc_writer_close(self._handle)
            self._handle = None
            if rc != 0:
                raise OSError("Failed to write bytes.")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
