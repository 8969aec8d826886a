"""4x4 two-qubit fusion — the reference's fastest ablation, generalized.

The reference's "4x4" variant promotes a CNOT plus its surrounding 1q gates
into a per-qubit-pair 4x4 accumulator tracked by a pairing state machine
(quantum_simulator_4x4.cu:327-469: pair-new :336-350, same-pair :351-365,
break-pair :366-468), raising arithmetic intensity 3.5 -> 7.5 FLOP/B
(Slides.pptx slide 14).

This pass reproduces that fusion semantically with two simplifications that
make it strictly stronger:
  * 1q gates on a paired qubit fold into the 4x4 immediately (the reference
    parks them in a 2x2 side-accumulator and folds at the next flush —
    same math, fewer states);
  * pending 2x2 accumulators of an unpaired operand are absorbed into the
    new pair's initial 4x4 (reference does the same via tensorProd,
    quantum_simulator_4x4.cu:336-350).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..ir import gates as G
from ..ir.circuit import Circuit
from ..ir.oplist import Op, expand_unitary

_I2 = np.eye(2, dtype=np.complex128)


def fuse_4x4(circuit: Circuit) -> List[Op]:
    """Lower a circuit to fused 4x4 pair ops (+ leftover fused 1q ops)."""
    n = circuit.num_qubits
    acc1: List[Optional[np.ndarray]] = [None] * n  # unpaired 2x2 accumulators
    partner: List[Optional[int]] = [None] * n
    acc4: Dict[tuple, np.ndarray] = {}  # key: (lo, hi) sorted pair
    ops: List[Op] = []

    def pair_key(a: int, b: int) -> tuple:
        return (a, b) if a < b else (b, a)

    def flush_single(q: int) -> None:
        a = acc1[q]
        if a is not None and not G.is_identity(a):
            ops.append(Op("u", (q,), a))
        acc1[q] = None

    def flush_pair(q: int) -> None:
        p = partner[q]
        if p is None:
            return
        key = pair_key(q, p)
        u = acc4.pop(key)
        if not G.is_identity(u, tol=1e-12):
            ops.append(Op("u", key, u))
        partner[q] = partner[p] = None

    def fold_1q(q: int, m: np.ndarray) -> None:
        p = partner[q]
        if p is None:
            acc1[q] = m if acc1[q] is None else m @ acc1[q]
        else:
            key = pair_key(q, p)
            acc4[key] = expand_unitary(m, (q,), key) @ acc4[key]

    for g in circuit.gates:
        if not g.is_cx:
            fold_1q(g.qubits[0], g.matrix())
            continue

        c, t = g.qubits
        key = pair_key(c, t)
        cnot4 = G.cnot_matrix(c, t)

        if partner[c] == t:
            # same pair again (ref :351-365)
            acc4[key] = cnot4 @ acc4[key]
            continue

        # pair break: flush any existing pairs involving c or t (ref :366-468)
        flush_pair(c)
        flush_pair(t)

        # new pair: seed with pending 2x2 accumulators, then the CNOT
        lo, hi = key
        u_lo = acc1[lo] if acc1[lo] is not None else _I2
        u_hi = acc1[hi] if acc1[hi] is not None else _I2
        acc1[lo] = acc1[hi] = None
        acc4[key] = cnot4 @ G.tensor_1q_pair(u_lo, u_hi)
        partner[c], partner[t] = t, c

    for q in range(n):
        if partner[q] is not None:
            flush_pair(q)
        flush_single(q)
    return ops
