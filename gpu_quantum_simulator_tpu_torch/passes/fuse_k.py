"""k-qubit greedy gate fusion — the TPU-native generalization of "4x4".

The reference stops at 4x4 blocks because a CUDA thread gathers 4 amplitudes
(quantum_simulator_4x4.cu:119-122).  On TPU the sweet spot is much wider: a
fused block over k=7 qubits is a 128x128 dense matrix, exactly one MXU tile,
applied as ``(128,128) @ (128, 2^(n-7))`` — so we fuse as wide as allowed.

Greedy chain algorithm: maintain an open block (qubit set + accumulated
unitary).  Each incoming op joins the block if the union stays within
``max_qubits``; otherwise the block is emitted and a new one opened.  A
commutation-aware scheduler can beat this (future pass); greedy already
collapses deep circuits by ~10-100x.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..ir import gates as G
from ..ir.circuit import Circuit
from ..ir.oplist import Op, circuit_to_ops, compose, op_matrix


def fuse_k(
    source: "Circuit | Sequence[Op]",
    max_qubits: int = 7,
    *,
    max_high: Optional[int] = None,
    high_threshold: int = 7,
    max_low: Optional[int] = None,
) -> List[Op]:
    """Fuse a circuit (or op list) into dense blocks of <= max_qubits qubits.

    ``max_high``: if set, a block may contain at most this many qubits >=
    ``high_threshold``.  The engines map the low 7 qubits to the TPU lane
    dimension; a block with kh high qubits becomes a 2^(7+kh)-wide matmul
    whose only data movement is a row shuffle — so capping kh caps both the
    matrix size and keeps every op off the pathological bit-transpose path.

    ``max_low``: if set, cap low (< high_threshold) qubits by this instead
    of capping the TOTAL width by max_qubits — the wide engine expands each
    block over the full lane superset, so a block may hold max_low low plus
    max_high high qubits at the cost of its kh class alone.
    """
    if isinstance(source, Circuit):
        ops = circuit_to_ops(source)
    else:
        ops = list(source)

    def ok(union) -> bool:
        low = sum(1 for q in union if q < high_threshold)
        if max_low is not None:
            if low > max_low:
                return False
        elif len(union) > max_qubits:
            return False
        return max_high is None or len(union) - low <= max_high

    out: List[Op] = []
    block: Optional[Op] = None

    for op in ops:
        qs = set(op.qubits)
        if block is None:
            block = op if op.kind == "u" else _materialize(op)
            continue
        union = qs | set(block.qubits)
        if ok(union):
            block = compose(op, block)
        else:
            _emit(out, block)
            block = op if op.kind == "u" else _materialize(op)
    if block is not None:
        _emit(out, block)
    return out


def _materialize(op: Op) -> Op:
    u, qs = op_matrix(op)
    return Op("u", qs, u)


def _emit(out: List[Op], block: Op) -> None:
    if not G.is_identity(block.u, tol=1e-12):
        out.append(block)
