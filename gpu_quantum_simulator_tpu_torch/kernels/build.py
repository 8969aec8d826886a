"""Build and load the port's CUDA kernels (plain C interface, ctypes).

Every ``*.cu`` under ``gpu_quantum_simulator_tpu_torch/csrc`` is compiled
with ``nvcc`` for Hopper (``sm_90a``) into one shared library under
``build/torch_kernels/`` at the repository root, at first use, and loaded
with ctypes.  Each C entry point launches on the stream it is given and
returns ``cudaGetLastError()``; the wrappers raise on a non-zero code.

Only the wrappers call ``load()``, and only for CUDA tensors: importing
this module builds nothing, and a CPU run never needs ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
_SO = os.path.join(BUILD_DIR, "libqsim_torch_kernels.so")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# seconds and compiler output of the build this process ran (None: the
# library was already built and only loaded)
last_build: Optional[dict] = None


def sources():
    return sorted(os.path.join(SRC_DIR, f) for f in os.listdir(SRC_DIR)
                  if f.endswith(".cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's CUDA kernels are built "
        "from source on the machine that runs them")


def _build() -> None:
    global last_build
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, *sources()]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    with open(os.path.join(BUILD_DIR, "build.log"), "w") as f:
        f.write(" ".join(cmd) + "\n" + log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, _SO)
    last_build = {"seconds": secs, "log": log}


def _declare(lib: ctypes.CDLL) -> None:
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.qsim_error_string.restype = ctypes.c_char_p
    lib.qsim_error_string.argtypes = [I]
    lib.qsim_mat_step.restype = I
    lib.qsim_mat_step.argtypes = [P, P, P, P, P, P, L, I, P]
    lib.qsim_gather_step.restype = I
    lib.qsim_gather_step.argtypes = [P, P, P, P, L, I, I, I, P, P, P]
    lib.qsim_relayout.restype = I
    lib.qsim_relayout.argtypes = [P, P, P, P, L, I, P, I, P]


def load() -> ctypes.CDLL:
    """The kernel library, built from the repository's sources if stale."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        srcs = sources()
        if not os.path.exists(_SO) or any(
                os.path.getmtime(s) > os.path.getmtime(_SO) for s in srcs):
            _build()
        lib = ctypes.CDLL(_SO)
        _declare(lib)
        _lib = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if rc != 0:
        raise RuntimeError(
            f"{what}: CUDA error {rc} ({lib.qsim_error_string(rc).decode()})")
