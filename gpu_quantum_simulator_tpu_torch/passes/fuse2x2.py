"""2x2 gate-fusion pass — the reference "preproces" strategy, done right.

A copy of the JAX package's ``passes/fuse2x2.py`` (host code).  Per-qubit
2x2 accumulators absorb consecutive single-qubit gates; a CNOT touching a
qubit forces that qubit's accumulator to flush as one fused gate (ref:
fuse/flush loop quantum_simulator_preproces.cu:215-255, final flush
:257-269, identity-skip :160-163).  Unlike the reference's 3in1 variant we
never double-apply an accumulator (ref defect #1, SURVEY §2.4).
"""

from __future__ import annotations

from typing import List

from ..ir import gates as G
from ..ir.circuit import Circuit
from ..ir.oplist import Op


def fuse_2x2(circuit: Circuit, *, keep_identity: bool = False) -> List[Op]:
    """Lower a circuit to fused 1q ops + structural CNOTs."""
    n = circuit.num_qubits
    acc = [None] * n  # None == identity (skip flush, like isIdentity)
    ops: List[Op] = []

    def flush(q: int) -> None:
        a = acc[q]
        if a is None:
            return
        if keep_identity or not G.is_identity(a):
            ops.append(Op("u", (q,), a))
        acc[q] = None

    for g in circuit.gates:
        if g.is_cx:
            c, t = g.qubits
            flush(c)
            flush(t)
            ops.append(Op("cx", (c, t)))
        else:
            q = g.qubits[0]
            m = g.matrix()
            acc[q] = m if acc[q] is None else m @ acc[q]

    for q in range(n):
        flush(q)
    return ops
