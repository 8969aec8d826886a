"""Build and load the port's CUDA kernels (plain C interface, ctypes).

Every ``*.cu`` under ``gpu_quantum_simulator_tpu_torch/csrc`` is compiled
with ``nvcc`` for Hopper (``sm_90a``), one ``nvcc`` process per source, all
started together, and the objects are linked into one shared library under
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


def _inputs():
    """Every file the library is built from (sources and headers)."""
    return sorted(os.path.join(SRC_DIR, f) for f in os.listdir(SRC_DIR)
                  if f.endswith((".cu", ".cuh")))


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
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    jobs = []
    for src in sources():
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-c", "-Xcompiler",
               "-fPIC", "-Xptxas", "-v", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = "", []
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        log += " ".join(cmd) + "\n" + out
        if proc.returncode != 0:
            failed.append(os.path.basename(cmd[-1]))
    tmp = f"{_SO}.{tag}"
    if not failed:
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp,
               *(obj for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log += " ".join(cmd) + "\n" + proc.stdout + proc.stderr
        if proc.returncode != 0:
            failed.append("link")
    for _, obj, _ in jobs:
        if os.path.exists(obj):
            os.remove(obj)
    secs = time.perf_counter() - t0
    with open(os.path.join(BUILD_DIR, "build.log"), "w") as f:
        f.write(log)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
    os.replace(tmp, _SO)
    last_build = {"seconds": secs, "log": log}


def _declare(lib: ctypes.CDLL) -> None:
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.qsim_error_string.restype = ctypes.c_char_p
    lib.qsim_error_string.argtypes = [I]
    lib.qsim_mat_step.restype = I
    lib.qsim_mat_step.argtypes = [P, P, P, P, P, P, L, I, P, I, I, P]
    lib.qsim_mat_step_high.restype = I
    lib.qsim_mat_step_high.argtypes = [P, P, P, P, P, L, I, P, I, I, P]
    lib.qsim_gather_step.restype = I
    lib.qsim_gather_step.argtypes = [P, P, P, P, L, I, I, I, P, P, P, I, I, P]
    lib.qsim_relayout.restype = I
    lib.qsim_relayout.argtypes = [P, P, P, P, L, I, P, I, P]
    lib.qsim_relayout_inplace.restype = I
    lib.qsim_relayout_inplace.argtypes = [P, P, P, P, L, I, P, I, P]
    lib.qsim_split_mat_step.restype = I
    lib.qsim_split_mat_step.argtypes = [P, P, P, P, P, P, L, I, P]
    lib.qsim_split_mat_step_high.restype = I
    lib.qsim_split_mat_step_high.argtypes = [P, P, P, P, P, L, I, P]
    lib.qsim_split_swap_rows.restype = I
    lib.qsim_split_swap_rows.argtypes = [P, P, P, P, L, I, P]
    lib.qsim_split_tswap_pair.restype = I
    lib.qsim_split_tswap_pair.argtypes = [P, P, P, P, L, I, I, P]
    lib.qsim_split_row_step.restype = I
    lib.qsim_split_row_step.argtypes = [P, P, P, P, L, I, P, P, I, P]
    lib.qsim_wide_chain.restype = I
    lib.qsim_wide_chain.argtypes = [P, P, P, P, P, P, L, I, L, P]
    lib.qsim_wide_chain_high.restype = I
    lib.qsim_wide_chain_high.argtypes = [P, P, P, P, P, I, L, P]
    lib.qsim_butterfly_high.restype = I
    lib.qsim_butterfly_high.argtypes = [P, P, P, P, L, I, P, P]
    for fn in (lib.qsim_copy_stream, lib.qsim_copy_direct):
        fn.restype = I
        fn.argtypes = [P, P, I, L, I, I, P]
    lib.qsim_copy_grid.restype = I
    lib.qsim_copy_grid.argtypes = [P, P, I, L, L, P]
    lib.qsim_vmem_chunk.restype = I
    lib.qsim_vmem_chunk.argtypes = [P, P, P, P, P, P, I, I, I,
                                    ctypes.POINTER(I), P]


def load() -> ctypes.CDLL:
    """The kernel library, built from the repository's sources if stale."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_SO) or any(
                os.path.getmtime(s) > os.path.getmtime(_SO)
                for s in _inputs()):
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
