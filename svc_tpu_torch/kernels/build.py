"""Compile ``csrc/*.cu`` with nvcc into one shared library, bind with ctypes.

The kernels have a plain C interface (pointers, sizes, a stream), so the
library is built by invoking ``nvcc`` directly — seconds, where a PyTorch
C++ extension that includes the torch headers takes minutes — and loaded
with :mod:`ctypes`. The build happens at first use, into
``build/svc_tpu_torch/`` at the checkout root, keyed by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one does
not. Nothing is compiled when this module is imported.

Every C entry point returns ``cudaGetLastError()`` right after its launch;
:class:`Kernel` raises when that is not ``cudaSuccess`` (a launch refused for
its configuration never runs, and a later synchronize would not report it).

``--use_fast_math`` is deliberately absent: it approximates ``/`` and
``logf``, and the decoder's dequantization parity depends on IEEE division.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "svc_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_result: Optional["BuildResult"] = None


@dataclasses.dataclass
class BuildResult:
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc's output (ptxas register / shared-memory report)


def sources() -> List[Path]:
    """Every file the library is built from (``.cu`` and ``.cuh``)."""
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _source_hash() -> str:
    h = hashlib.sha256()
    for f in sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, ``nvcc`` on ``PATH``, or the toolkit's
    default install location, in that order."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels of svc_tpu_torch are built from source at first use"
    )


def build() -> BuildResult:
    """Build the kernel library if its hash-keyed file is missing."""
    global _build_result
    with _lock:
        if _build_result is not None:
            return _build_result
        out = BUILD_DIR / f"libsvc_kernels_{_source_hash()}.so"
        if out.exists():
            _build_result = BuildResult(out, 0.0, "")
            return _build_result
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp)]
        cmd += [str(f) for f in sorted(CSRC_DIR.glob("*.cu"))]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}"
            )
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half
        _build_result = BuildResult(out, seconds, log)
        return _build_result


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    result = build()
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(result.path))
            lib.svc_error_string.restype = ctypes.c_char_p
            lib.svc_error_string.argtypes = [ctypes.c_int]
            _lib = lib
        return _lib


_REGISTRY: Dict[str, "Kernel"] = {}


class Kernel:
    """One C entry point of the library plus its launch counter.

    ``launches`` is a plain integer that :meth:`launch` adds one to after
    each successful launch and nothing else touches — a run can show that
    its main path went through the kernel (``chip_smoke.py``).
    """

    def __init__(
        self,
        name: str,
        symbol: str,
        argtypes: Sequence,
        source: str,
        replaces: str,
    ):
        self.name = name
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.source = source  # repo path of the CUDA source
        self.replaces = replaces  # file:line of the TPU kernel it ports
        self.launches = 0
        self._fn = None
        _REGISTRY[name] = self

    def launch(self, *args) -> None:
        if self._fn is None:
            lib = library()
            fn = getattr(lib, self.symbol)
            fn.restype = ctypes.c_int
            fn.argtypes = self.argtypes
            self._fn = fn
        rc = self._fn(*args)
        if rc != 0:
            msg = library().svc_error_string(rc).decode()
            raise RuntimeError(f"{self.name}: CUDA error {rc} ({msg})")
        self.launches += 1


def kernels() -> Dict[str, Kernel]:
    """Every kernel registered by the imported ``ops`` modules."""
    return dict(_REGISTRY)


def reset_launch_counts() -> None:
    for k in _REGISTRY.values():
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in _REGISTRY.items()}


def stream_handle(tensor) -> int:
    """PyTorch's current CUDA stream on ``tensor``'s device, as an int."""
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream


# ctypes argument types shared by the wrappers: pointers, the stream and
# sizes go as c_void_p / c_int explicitly (an undeclared Python int would be
# passed as a 32-bit int and cut a 64-bit pointer)
PTR = ctypes.c_void_p
INT = ctypes.c_int
