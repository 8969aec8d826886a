"""ctypes binding to the native f64 reference (csrc/qsim_ref.cpp).

The same C++ source and the same functions as the JAX package's
``ref/native.py`` (parse, simulate, sample): an independent
double-precision ground truth and a fast parser for large circuit files
that run wherever a C++ compiler does, so the port can be held to them on
the card's host with no JAX installed.  Builds ``libqsimref.so`` under
``build/host/`` on first use (``build_host_lib``), without OpenMP; the
sampler is serial in both builds, so its samples are the JAX package's.
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
        lib.qsr_parse_file.restype = ctypes.c_void_p
        lib.qsr_parse_file.argtypes = [ctypes.c_char_p]
        lib.qsr_parse_string.restype = ctypes.c_void_p
        lib.qsr_parse_string.argtypes = [ctypes.c_char_p]
        lib.qsr_num_qubits.argtypes = [ctypes.c_void_p]
        lib.qsr_num_gates.restype = ctypes.c_int64
        lib.qsr_num_gates.argtypes = [ctypes.c_void_p]
        lib.qsr_gates.argtypes = [ctypes.c_void_p] + [
            np.ctypeslib.ndpointer(dtype=np.float64),
            np.ctypeslib.ndpointer(dtype=np.float64),
            np.ctypeslib.ndpointer(dtype=np.int32),
            np.ctypeslib.ndpointer(dtype=np.int32),
            np.ctypeslib.ndpointer(dtype=np.int32),
            np.ctypeslib.ndpointer(dtype=np.float64),
        ]
        lib.qsr_free.argtypes = [ctypes.c_void_p]
        lib.qsr_simulate.argtypes = [
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(dtype=np.float64),
            np.ctypeslib.ndpointer(dtype=np.float64),
        ]
        lib.qsr_sample.argtypes = [
            np.ctypeslib.ndpointer(dtype=np.float64),
            np.ctypeslib.ndpointer(dtype=np.float64),
            ctypes.c_int,
            ctypes.c_uint64,
            np.ctypeslib.ndpointer(dtype=np.int64),
            ctypes.c_int64,
        ]
        _lib = lib
        return lib


def available() -> bool:
    try:
        get_lib()
        return True
    except NativeUnavailable:
        return False


class _Handle:
    def __init__(self, lib, ptr):
        self._lib, self._ptr = lib, ptr

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.qsr_free(self._ptr)
            self._ptr = None


def _parse(lib, path: Optional[str] = None,
           text: Optional[str] = None) -> _Handle:
    if path is not None:
        ptr = lib.qsr_parse_file(path.encode())
    else:
        ptr = lib.qsr_parse_string(text.encode())
    if not ptr:
        raise ValueError(lib.qsr_error().decode())
    return _Handle(lib, ptr)


def parse_qasm_native(source: str, *, is_path: bool = False):
    """Parse QASM with the native parser; returns the same Circuit IR."""
    from ..ir.circuit import Circuit

    lib = get_lib()
    h = _parse(lib, path=source if is_path else None,
               text=None if is_path else source)
    n = lib.qsr_num_qubits(h._ptr)
    m = int(lib.qsr_num_gates(h._ptr))
    u_re = np.empty((m, 4), dtype=np.float64)
    u_im = np.empty((m, 4), dtype=np.float64)
    target = np.empty(m, dtype=np.int32)
    control = np.empty(m, dtype=np.int32)
    opcode = np.empty(m, dtype=np.int32)
    param = np.empty(m, dtype=np.float64)
    lib.qsr_gates(h._ptr, u_re, u_im, target, control, opcode, param)

    circ = Circuit(n)
    for g in range(m):
        name = _OPCODES[opcode[g]]
        if name == "cx":
            circ.append("cx", int(control[g]), int(target[g]))
        elif name == "rz":
            circ.append("rz", int(target[g]), params=(float(param[g]),))
        else:
            circ.append(name, int(target[g]))
    return circ


# Must match enum Opcode in csrc/qsim_ref.cpp.
_OPCODES = ("cx", "id", "x", "sx", "z", "s", "sdg", "t", "tdg", "rz", "h")


def simulate_native(circuit_or_path,
                    num_qubits: Optional[int] = None) -> np.ndarray:
    """Run the native f64 simulator; accepts a Circuit (serialized through
    QASM) or a .qasm path."""
    lib = get_lib()
    if isinstance(circuit_or_path, str):
        h = _parse(lib, path=circuit_or_path)
    else:
        h = _parse(lib, text=circuit_or_path.to_qasm())
    n = lib.qsr_num_qubits(h._ptr)
    size = 1 << n
    out_re = np.empty(size, dtype=np.float64)
    out_im = np.empty(size, dtype=np.float64)
    rc = lib.qsr_simulate(h._ptr, out_re, out_im)
    if rc != 0:
        raise RuntimeError(lib.qsr_error().decode())
    return out_re + 1j * out_im


def sample_native(state: np.ndarray, num_samples: int,
                  seed: int = 0) -> np.ndarray:
    """``num_samples`` basis indices drawn from |state|^2 by the native
    sampler (std::mt19937_64 seeded with ``seed``)."""
    lib = get_lib()
    n = int(np.log2(len(state)))
    out = np.empty(num_samples, dtype=np.int64)
    lib.qsr_sample(
        np.ascontiguousarray(state.real, dtype=np.float64),
        np.ascontiguousarray(state.imag, dtype=np.float64),
        n,
        seed,
        out,
        num_samples,
    )
    return out
