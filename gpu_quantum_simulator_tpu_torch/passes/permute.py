"""Qubit-permutation (relabeling) pass.

The reference relabels qubits so the most-used ones occupy the lowest bit
positions for coalesced global-memory access
(quantum_simulator_preproces_permute.cu:388-413).  On TPU the motivation is
sharper: the ``mxu`` engine applies fused blocks on qubits 0..6 as one
128x128 right-matmul over the (2^(n-7), 128) state matrix, and the sharded
engine keeps the top qubits on mesh axes — so "hot qubits low" directly
converts gates into MXU work and avoids ICI collectives.

This is the CORRECT version: the reference's constant-variant histogram reads
one element past its op list (defect #5, …permute.cu:396-401), its final
flushes bypass the permutation (defect #6), and it never un-permutes the
output (defect #7).  Here the histogram is exact, relabeling covers every op,
and ``unpermute_state`` restores the original basis.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..ir.circuit import Circuit
from ..ir.oplist import Op


def plan_permutation(circuit: Circuit) -> np.ndarray:
    """perm[q] = new label of original qubit q; hot qubits -> low labels.

    Stable sort by descending usage (ties keep original order, matching the
    determinism a quicksort-based reference run lacks).
    """
    hist = circuit.qubit_usage()
    order = np.argsort(-hist, kind="stable")  # original labels, hottest first
    perm = np.empty(circuit.num_qubits, dtype=np.int64)
    perm[order] = np.arange(circuit.num_qubits)
    return perm


def apply_permutation_to_ops(ops: Sequence[Op], perm: np.ndarray) -> list:
    """Relabel every op; u-op qubit tuples are re-sorted with the matrix
    basis permuted to match (ir.oplist keeps u-ops sorted-ascending)."""
    from ..ir.oplist import permute_basis

    out = []
    for op in ops:
        new_q = tuple(int(perm[q]) for q in op.qubits)
        if op.kind == "cx":
            out.append(Op("cx", new_q))
            continue
        order = np.argsort(new_q)
        sorted_q = tuple(int(new_q[i]) for i in order)
        if sorted_q == new_q:
            out.append(Op("u", new_q, op.u))
        else:
            # old basis bit j holds (relabeled) qubit new_q[j]; re-sort bits
            u = permute_basis(op.u, list(new_q), list(sorted_q))
            out.append(Op("u", sorted_q, u))
    return out


def unpermute_state(state: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """Map a state computed in the relabeled basis back to the original one.

    The relabeled state's bit perm[q] is original qubit q.  (The reference
    never does this — defect #7 — so its permute variants return amplitudes
    in a scrambled basis.)
    """
    n = len(perm)
    t = np.asarray(state).reshape((2,) * n)
    # axis j of the reshape is relabeled bit n-1-j == original qubit
    # inv[n-1-j] where inv = argsort(perm).
    inv = np.argsort(perm)
    src_axis_of_orig = {int(inv[b]): n - 1 - b for b in range(n)}
    axes = [src_axis_of_orig[n - 1 - j] for j in range(n)]
    return t.transpose(axes).reshape(-1)
