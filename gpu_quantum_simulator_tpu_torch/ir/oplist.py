"""Fused op-list IR + dense unitary algebra helpers.

The fusion passes lower a Circuit (gate stream) to a list of ``Op`` records:
dense unitaries over 1..k qubits plus structural CNOTs.  This is the analog
of the reference's fused ``VecGate_r/i / VecTarg / VecArg`` arrays
(quantum_simulator_preproces_constant.cu:244-246,288-369) — except ops carry
arbitrary-width blocks, not just 2x2/4x4.

Basis convention for an Op over sorted qubits (q_0 < ... < q_{k-1}):
matrix index = sum_j bit(q_j) << j  (little-endian over the sorted tuple).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import gates as G
from .circuit import Circuit, Gate


@dataclass(frozen=True)
class Op:
    """One fused operation.

    kind   : "u"  — dense unitary over ``qubits`` (sorted ascending)
             "cx" — structural CNOT, qubits = (control, target), u is None
    """

    kind: str
    qubits: Tuple[int, ...]
    u: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.kind == "u":
            k = len(self.qubits)
            assert self.u is not None and self.u.shape == (1 << k, 1 << k)
            assert tuple(sorted(self.qubits)) == self.qubits, "u-op qubits must be sorted"
        elif self.kind == "cx":
            assert len(self.qubits) == 2 and self.u is None
        else:
            raise ValueError(f"bad op kind {self.kind!r}")

    @property
    def width(self) -> int:
        return len(self.qubits)


def ops_digest(ops: Sequence[Op], header: str) -> str:
    """sha256 over ``header`` and every op's kind, qubits and matrix: the
    key of the engines' program caches (the JAX package's op fingerprint)."""
    h = hashlib.sha256(header.encode())
    for op in ops:
        h.update(op.kind.encode())
        h.update(np.asarray(op.qubits, dtype=np.int64).tobytes())
        if op.u is not None:
            h.update(np.ascontiguousarray(op.u).tobytes())
    return h.hexdigest()


def permute_basis(mat: np.ndarray, src: Sequence[int], dst: Sequence[int]) -> np.ndarray:
    """Reorder a 2^k x 2^k matrix between qubit-label orderings.

    ``src``/``dst`` list the qubit label occupying each bit position (LSB
    first) of the matrix index before/after.  Must contain the same labels.
    """
    k = len(src)
    assert sorted(src) == sorted(dst)
    if list(src) == list(dst):
        return mat
    # axis j of a (2,)*k reshape is bit k-1-j (MSB first).  Build the transpose
    # sending src-bit axes to dst-bit axes.
    src_axis = {label: k - 1 - bit for bit, label in enumerate(src)}
    perm = [src_axis[label] for bit, label in [(b, dst[k - 1 - b]) for b in range(k)]]
    t = mat.reshape((2,) * k + (2,) * k)
    t = t.transpose(perm + [k + p for p in perm])
    return t.reshape(mat.shape)


def expand_unitary(
    u: np.ndarray, qubits: Sequence[int], superset: Sequence[int]
) -> np.ndarray:
    """Embed a unitary over ``qubits`` (sorted) into ``superset`` (sorted).

    The k-qubit generalization of the reference's tensorProd promotion
    (quantum_simulator_4x4.cu:220-233).
    """
    qubits = list(qubits)
    superset = list(superset)
    assert set(qubits) <= set(superset)
    extra = [q for q in superset if q not in qubits]
    if not extra:
        return u
    big = np.kron(np.eye(1 << len(extra), dtype=u.dtype), u)
    # big's basis ordering (LSB first): qubits..., extra...
    return permute_basis(big, qubits + extra, superset)


def gate_op(gate: Gate) -> Op:
    """Lower a Gate to an Op (cx stays structural)."""
    if gate.is_cx:
        return Op("cx", gate.qubits)
    return Op("u", gate.qubits, gate.matrix())


def op_matrix(op: Op) -> Tuple[np.ndarray, Tuple[int, ...]]:
    """(dense matrix, sorted qubits) for any op — cx is materialized."""
    if op.kind == "cx":
        c, t = op.qubits
        lo, hi = (c, t) if c < t else (t, c)
        return G.cnot_matrix(c, t), (lo, hi)
    return op.u, op.qubits


def compose(later: Op, earlier: Op) -> Op:
    """The op equal to applying ``earlier`` then ``later`` (matrix product
    later @ earlier over the union qubit set)."""
    u1, q1 = op_matrix(earlier)
    u2, q2 = op_matrix(later)
    union = tuple(sorted(set(q1) | set(q2)))
    a = expand_unitary(u1, q1, union)
    return Op("u", union, absorb(a, union, u2, q2))


def absorb(block: np.ndarray, block_qubits: Sequence[int],
           u: np.ndarray, qubits: Sequence[int]) -> np.ndarray:
    """expand_unitary(u, qubits, block_qubits) @ block, without the expansion.

    Contracts the small gate directly onto the block's output axes:
    O(2^m · 4^k / 2^m... ) ~ 2^(2k+m) flops instead of the 2^(3k) dense
    product — the difference between 0.3 s and 0.05 s of host preprocessing
    per benchmark run when k = 7.  ``qubits`` ⊆ ``block_qubits``, both sorted.
    """
    k = len(block_qubits)
    m = len(qubits)
    assert set(qubits) <= set(block_qubits)
    pos = {q: i for i, q in enumerate(block_qubits)}
    # block out-axes: axis j <-> out bit k-1-j <-> qubit block_qubits[k-1-j]
    bt = block.reshape((2,) * k + (1 << k,))
    ut = u.reshape((2,) * (2 * m))
    # ut in-axis m + j <-> gate in bit m-1-j <-> qubit qubits[m-1-j]
    u_in_axes = [m + j for j in range(m)]
    b_out_axes = [k - 1 - pos[qubits[m - 1 - j]] for j in range(m)]
    t = np.tensordot(ut, bt, axes=(u_in_axes, b_out_axes))
    # result: m new out axes (axis j <-> qubit qubits[m-1-j]) then the
    # remaining block axes in original order; move new axes home.
    dest = [k - 1 - pos[qubits[m - 1 - j]] for j in range(m)]
    t = np.moveaxis(t, list(range(m)), dest)
    return t.reshape(1 << k, 1 << k)


def oplist_to_circuit_matrix(ops: Sequence[Op], num_qubits: int) -> np.ndarray:
    """Dense 2^n unitary of an op list (tests only; exponential)."""
    full = np.eye(1 << num_qubits, dtype=np.complex128)
    all_q = tuple(range(num_qubits))
    for op in ops:
        u, qs = op_matrix(op)
        full = expand_unitary(u, qs, all_q) @ full
    return full


def circuit_to_ops(circuit: Circuit) -> List[Op]:
    return [gate_op(g) for g in circuit.gates]


def circuit_unitary(circuit: Circuit, max_qubits: int = 12) -> np.ndarray:
    """The dense 2^n x 2^n complex128 unitary of a small circuit.

    Exact (f64 matrix products, little-endian basis — qubit k = bit k).
    Exponential in n, guarded at ``max_qubits``; for verification,
    decomposition checks and textbook-scale algebra, not simulation."""
    n = circuit.num_qubits
    if n > max_qubits:
        raise ValueError(
            f"circuit_unitary is dense (4^n): n = {n} > max_qubits = "
            f"{max_qubits}; raise max_qubits explicitly if you mean it")
    return oplist_to_circuit_matrix(circuit_to_ops(circuit), n)
