"""ctypes binding to the native fusion pipeline (csrc/qsim_fuse.cpp).

``fuse_native(circuit, max_qubits, max_high)`` runs the 4x4 pairing state
machine + greedy k-qubit fusion in C++ and returns the same ``Op`` list as
``fuse_k(fuse_4x4(circuit), ...)``.  The library is built from the same
source into ``build/host/`` (``ref.native.build_host_lib``).  Callers fall
back to the Python passes when the toolchain is unavailable
(``available()``).
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional

import numpy as np

from ..ir.circuit import Circuit
from ..ir.oplist import Op

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        from ..ref.native import build_host_lib

        lib = ctypes.CDLL(build_host_lib("qsim_fuse.cpp", "libqsimfuse.so"))
        lib.qsf_error.restype = ctypes.c_char_p
        lib.qsf_fuse.restype = ctypes.c_void_p
        lib.qsf_fuse.argtypes = [
            ctypes.c_int, ctypes.c_longlong,
            np.ctypeslib.ndpointer(dtype=np.float64),
            np.ctypeslib.ndpointer(dtype=np.float64),
            np.ctypeslib.ndpointer(dtype=np.int32),
            np.ctypeslib.ndpointer(dtype=np.int32),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.qsf_num_ops.restype = ctypes.c_longlong
        lib.qsf_num_ops.argtypes = [ctypes.c_void_p]
        lib.qsf_op_width.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
        lib.qsf_op_qubits.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong,
            np.ctypeslib.ndpointer(dtype=np.int32),
        ]
        lib.qsf_op_matrix.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong,
            np.ctypeslib.ndpointer(dtype=np.complex128),
        ]
        lib.qsf_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def available() -> bool:
    from ..ref.native import NativeUnavailable

    try:
        get_lib()
        return True
    except NativeUnavailable:
        return False


def fuse_native(
    circuit: Circuit,
    max_qubits: int = 7,
    max_high: Optional[int] = None,
    high_threshold: int = 7,
    window: int = 1,
) -> List[Op]:
    """Native fusion.  ``window``: number of concurrently-open blocks; an op
    is absorbed into an older block when its support is disjoint from every
    newer one (commutation-aware packing; window=1 = plain chaining).  The
    C++ side's cost-model and low-cap arguments (``qsf_fuse2``) serve the
    JAX package's wide engine, which the port does not run."""
    lib = get_lib()
    u_re, u_im, target, control = circuit.to_soa()
    h = lib.qsf_fuse(
        circuit.num_qubits, len(circuit), u_re, u_im, target, control,
        max_qubits, -1 if max_high is None else max_high, high_threshold,
        window,
    )
    if not h:
        raise RuntimeError(lib.qsf_error().decode())
    try:
        num = lib.qsf_num_ops(h)
        ops: List[Op] = []
        qbuf = np.empty(10, dtype=np.int32)
        for i in range(num):
            w = lib.qsf_op_width(h, i)
            lib.qsf_op_qubits(h, i, qbuf)
            u = np.empty((1 << w, 1 << w), dtype=np.complex128)
            lib.qsf_op_matrix(h, i, u)
            ops.append(Op("u", tuple(int(q) for q in qbuf[:w]), u))
        return ops
    finally:
        lib.qsf_destroy(h)
