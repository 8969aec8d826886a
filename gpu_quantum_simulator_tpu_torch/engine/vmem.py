"""The ``vmem`` strategy: the whole circuit in chunks of fused ops, one
kernel launch per chunk, the state held on chip between ops.

A port of the JAX package's ``engine/vmem.py``.  Its op model is the wide
engine's: every fused block acts on the 7 lane qubits plus kh <= 2 row
qubits and is one (2^n / D, D) @ (D, D) complex product between row
shuffles (engine/wide.py ``_op_spec``).  The ops are cut into chunks of
``CHUNK_OPS``, as the JAX package cuts them, and each chunk is one launch
of kernel 8 (kernels/vmem.py, csrc/vmem_chunk.cu): a cooperative kernel
whose ops are separated by a grid-wide barrier, the state ping-ponging
between two buffer pairs in the 50 MB L2 where the TPU kept it in VMEM.
The tables go to the device once per program.

``VMEM_MAX_QUBITS`` is the JAX package's (n <= 19, set by a TPU's VMEM);
the precision rung is not read: the products are IEEE fp32, as the JAX
kernel's ``Precision.HIGHEST``.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..ir.oplist import Op, ops_digest
from ..kernels.vmem import VmemTables, vmem_chunk, vmem_tables
from ..ops.apply import resolve_device
from .wide import LANE_QUBITS, LANES, _op_spec

VMEM_MAX_QUBITS = 19

# ops per chunk, the JAX package's (one launch each here)
CHUNK_OPS = 96


class VmemProgram:
    """A circuit's chunks with their device tables.

    Calling it maps a flat (2^n,) state pair through every chunk and
    returns the new pair; the input pair is handed over (the kernel writes
    into it)."""

    def __init__(self, ops: Sequence[Op], num_qubits: int, device="cuda",
                 chunk_ops: int = CHUNK_OPS):
        n = num_qubits
        if not LANE_QUBITS < n <= VMEM_MAX_QUBITS:
            raise ValueError(f"the vmem program needs {LANE_QUBITS} < n <= "
                             f"{VMEM_MAX_QUBITS}, got n = {n}")
        device = resolve_device(device)
        specs = []
        for op in ops:
            kh, row_bits, _, bre, bim = _op_spec(op, n)
            if kh > 2:
                raise ValueError(
                    "vmem program requires blocks with <= 2 high qubits")
            specs.append((row_bits, bre, bim))
        self.num_qubits = n
        self.num_ops = len(ops)
        self.chunks: List[VmemTables] = [
            vmem_tables(specs[i : i + chunk_ops], n, device)
            for i in range(0, len(specs), chunk_ops)]

    @property
    def ops_by_D(self) -> dict:
        """Fused ops counted by their matrix width D."""
        out: dict = {}
        for ch in self.chunks:
            for _, _, D in ch.steps:
                out[D] = out.get(D, 0) + 1
        return out

    def __call__(self, re: torch.Tensor, im: torch.Tensor):
        R = 1 << (self.num_qubits - LANE_QUBITS)
        pair = (re.reshape(R, LANES), im.reshape(R, LANES))
        spare = None
        for tables in self.chunks:
            out = vmem_chunk(*pair, tables, scratch=spare)
            if out[0] is not pair[0]:
                spare, pair = pair, out
        return pair[0].reshape(-1), pair[1].reshape(-1)


def build_vmem_program(ops: Sequence[Op], num_qubits: int, device="cuda",
                       chunk_ops: int = CHUNK_OPS) -> VmemProgram:
    return VmemProgram(ops, num_qubits, device=device, chunk_ops=chunk_ops)


_CACHE: dict = {}
_CACHE_LIMIT = 16


def build_vmem_program_cached(ops: Sequence[Op], num_qubits: int,
                              device="cuda") -> VmemProgram:
    """``build_vmem_program`` cached by the op list's fingerprint."""
    device = resolve_device(device)
    key = ops_digest(ops, f"v|{num_qubits}|float32|{device}")
    prog = _CACHE.get(key)
    if prog is None:
        prog = build_vmem_program(ops, num_qubits, device=device)
        if len(_CACHE) >= _CACHE_LIMIT:
            _CACHE.pop(next(iter(_CACHE)))
        _CACHE[key] = prog
    return prog
