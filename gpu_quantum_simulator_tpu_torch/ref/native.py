"""ctypes binding to the native f64 reference simulator (csrc/qsim_ref.cpp).

The same C++ source as the JAX package's ``ref/native.py``, reduced to
``simulate_native``: an independent double-precision ground truth that runs
wherever a C++ compiler does, so the port can be held to it on the card's
host with no JAX installed.  Builds ``libqsimref.so`` under ``build/host/``
on first use (``build_host_lib``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import Optional

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_CSRC = os.path.join(_ROOT, "csrc")
HOST_BUILD_ROOT = os.path.join(_ROOT, "build", "host")
# csrc/Makefile's flags without -fopenmp: a CUDA host may have no libgomp,
# qsim_fuse.cpp uses no OpenMP, and qsim_ref.cpp's pragmas only split
# independent loops, so the results are the same.  -march=native stays, as
# in the Makefile, so the port fuses bit for bit like the JAX package's
# build on the same host; the build directory is keyed by what it resolves
# to (host_build_dir), so a tree carried to another CPU rebuilds.
HOST_CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-shared"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_dir: Optional[str] = None


class NativeUnavailable(RuntimeError):
    pass


def _run(cmd, what: str) -> str:
    try:
        return subprocess.run(cmd, check=True, capture_output=True,
                              text=True).stdout
    except (subprocess.CalledProcessError, FileNotFoundError) as exc:
        detail = getattr(exc, "stderr", "") or str(exc)
        raise NativeUnavailable(f"cannot build {what}: {detail}") from exc


def host_build_dir() -> str:
    """``build/host/<machine>-<key>``: the key hashes the compiler, the
    flags and the target options ``-march=native`` selects on this CPU."""
    global _build_dir
    if _build_dir is None:
        cxx = os.environ.get("CXX", "g++")
        target = _run([cxx, "-march=native", "-Q", "--help=target"],
                      "the host libraries")
        key = hashlib.sha256(
            "\0".join([cxx, *HOST_CXXFLAGS, target]).encode()).hexdigest()
        _build_dir = os.path.join(
            HOST_BUILD_ROOT, f"{platform.machine()}-{key[:16]}")
    return _build_dir


def build_host_lib(source: str, name: str) -> str:
    """Compile ``csrc/<source>`` into ``host_build_dir()/<name>`` unless it
    is up to date; return the library's path.  The port builds its own
    copies there, so the JAX package's OpenMP builds in csrc/ are left
    alone."""
    src = os.path.join(_CSRC, source)
    out_dir = host_build_dir()
    so = os.path.join(out_dir, name)
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    _run([os.environ.get("CXX", "g++"), *HOST_CXXFLAGS, "-o", tmp, src], name)
    os.replace(tmp, so)
    return so


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build_host_lib("qsim_ref.cpp", "libqsimref.so"))
        lib.qsr_error.restype = ctypes.c_char_p
        lib.qsr_parse_string.restype = ctypes.c_void_p
        lib.qsr_parse_string.argtypes = [ctypes.c_char_p]
        lib.qsr_num_qubits.argtypes = [ctypes.c_void_p]
        lib.qsr_free.argtypes = [ctypes.c_void_p]
        lib.qsr_simulate.argtypes = [
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(dtype=np.float64),
            np.ctypeslib.ndpointer(dtype=np.float64),
        ]
        _lib = lib
        return lib


def simulate_native(circuit) -> np.ndarray:
    """Run the native f64 simulator on a Circuit (serialized through QASM)."""
    lib = get_lib()
    ptr = lib.qsr_parse_string(circuit.to_qasm().encode())
    if not ptr:
        raise ValueError(lib.qsr_error().decode())
    try:
        n = lib.qsr_num_qubits(ptr)
        size = 1 << n
        out_re = np.empty(size, dtype=np.float64)
        out_im = np.empty(size, dtype=np.float64)
        rc = lib.qsr_simulate(ptr, out_re, out_im)
        if rc != 0:
            raise RuntimeError(lib.qsr_error().decode())
    finally:
        lib.qsr_free(ptr)
    return out_re + 1j * out_im
