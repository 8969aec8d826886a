"""Circuit IR: an ordered gate stream over n qubits.

The reference parses circuits into parallel SoA arrays (4 floats re + 4 floats
im per gate, char target, char cnot_arg with sentinel 127 — see
quantum_simulator_naive.cu:224-402).  Here the front-end IR is a list of
``Gate`` records; dense SoA op-tables for device execution are produced by
``ir.oplist`` / the fusion passes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, List, Tuple

import numpy as np

from . import gates as G


@dataclass(frozen=True)
class Gate:
    """One gate application.

    name   : lowercase gate name from ir.gates.ALL_GATES
    qubits : (target,) for 1q gates; (control, target) for cx
    params : (theta,) for rz, else ()
    """

    name: str
    qubits: Tuple[int, ...]
    params: Tuple[float, ...] = ()

    def __post_init__(self):
        if self.name not in G.ALL_GATES:
            raise ValueError(f"unknown gate {self.name!r}")
        arity = 2 if self.name in G.TWO_QUBIT_GATES else 1
        if len(self.qubits) != arity:
            raise ValueError(
                f"gate {self.name} expects {arity} qubit(s), got {self.qubits}"
            )
        if self.name == "cx" and self.qubits[0] == self.qubits[1]:
            raise ValueError("cx control and target must differ")

    @property
    def is_cx(self) -> bool:
        return self.name == "cx"

    def matrix(self) -> np.ndarray:
        """Dense complex128 matrix (2x2 for 1q; 4x4 little-endian pair for cx)."""
        if self.is_cx:
            return G.cnot_matrix(*self.qubits)
        return G.matrix_1q(self.name, self.params)


@dataclass
class Circuit:
    """An n-qubit circuit as an ordered gate list."""

    num_qubits: int
    gates: List[Gate] = field(default_factory=list)

    def __post_init__(self):
        if self.num_qubits < 1:
            raise ValueError("num_qubits must be >= 1")
        for g in self.gates:
            self._check(g)

    def _check(self, g: Gate) -> None:
        for q in g.qubits:
            if not (0 <= q < self.num_qubits):
                raise ValueError(
                    f"gate {g} addresses qubit {q} outside [0, {self.num_qubits})"
                )

    # -- construction helpers -------------------------------------------------
    def append(self, name: str, *qubits: int, params: Iterable[float] = ()) -> "Circuit":
        g = Gate(name, tuple(qubits), tuple(params))
        self._check(g)
        self.gates.append(g)
        return self

    def h(self, q: int):
        return self.append("h", q)

    def x(self, q: int):
        return self.append("x", q)

    def sx(self, q: int):
        return self.append("sx", q)

    def sxdg(self, q: int):
        return self.append("sxdg", q)

    def id(self, q: int):
        return self.append("id", q)

    def z(self, q: int):
        return self.append("z", q)

    def s(self, q: int):
        return self.append("s", q)

    def sdg(self, q: int):
        return self.append("sdg", q)

    def t(self, q: int):
        return self.append("t", q)

    def tdg(self, q: int):
        return self.append("tdg", q)

    def rz(self, theta: float, q: int):
        return self.append("rz", q, params=(theta,))

    def rx(self, theta: float, q: int):
        return self.append("rx", q, params=(theta,))

    def ry(self, theta: float, q: int):
        return self.append("ry", q, params=(theta,))

    def p(self, theta: float, q: int):
        return self.append("p", q, params=(theta,))

    def y(self, q: int):
        return self.append("y", q)

    def u(self, theta: float, phi: float, lam: float, q: int):
        return self.append("u", q, params=(theta, phi, lam))

    def cx(self, control: int, target: int):
        return self.append("cx", control, target)

    def initialize(self, vec, *qubits: int):
        """Append gates preparing the given amplitude vector from |0...0>
        on ``qubits`` (default: the whole register) — the Mottonen
        uniformly-controlled-rotation cascade, exact including global
        phase (ir.decompose.emit_state_prep).  Unlike the engines'
        ``initial=`` fast path this is a real circuit: portable,
        invertible, exportable to QASM."""
        from .decompose import emit_state_prep

        emit_state_prep(self, vec, qubits or tuple(range(self.num_qubits)))
        return self

    def pauli_rot(self, theta: float, pauli: str):
        """Append exp(-i theta/2 P) for an arbitrary Pauli string P (exact,
        global phase included) — the Hamiltonian-simulation primitive.

        ``pauli``: dense ("IXZY", qubit 0 leftmost) or sparse ("X0 Z3 Y5")
        — the observables module's format.  Lowering: X factors conjugate
        with h, Y with rx(pi/2) (both map Z into place), a cx parity
        ladder folds the string onto its last qubit, rz(theta) rotates,
        and the p-x-p-x pair supplies the e^{-i theta/2} this library's
        rz = diag(1, e^{i theta}) convention leaves over.  An all-identity
        string is the pure global phase e^{-i theta/2}."""
        import math

        from ..observables import _parse_pauli

        ops = _parse_pauli(pauli, self.num_qubits)
        qs = sorted(ops)
        # the rz below contributes e^{+i theta/2} relative to the exact
        # exponential; cancel it here (on qubit 0 for the identity string)
        anchor = qs[-1] if qs else 0
        self.p(-theta / 2, anchor)
        self.x(anchor)
        self.p(-theta / 2, anchor)
        self.x(anchor)
        if not qs:
            return self
        for q in qs:
            if ops[q] == "X":
                self.h(q)
            elif ops[q] == "Y":
                self.rx(math.pi / 2, q)
        for a, b in zip(qs, qs[1:]):
            self.cx(a, b)
        self.rz(theta, qs[-1])
        for a, b in reversed(list(zip(qs, qs[1:]))):
            self.cx(a, b)
        for q in qs:
            if ops[q] == "X":
                self.h(q)
            elif ops[q] == "Y":
                self.rx(-math.pi / 2, q)
        return self

    def unitary(self, u, *qubits: int):
        """Append an arbitrary unitary matrix on 1-6 qubits as native
        gates (exact, global phase included): 2q via the KAK
        decomposition, 3q+ via the quantum Shannon decomposition
        (ir.decompose.emit_unitary / emit_unitary_k).  Matrix basis:
        index bit i = qubits[i] — little-endian over the operand order."""
        from .decompose import emit_unitary

        emit_unitary(self, u, qubits)
        return self

    # -- queries ---------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.gates)

    def __iter__(self):
        return iter(self.gates)

    def to_soa(self):
        """SoA gate-stream arrays (cached): the reference parse_circuit layout
        (quantum_simulator_naive.cu:224-402) — 4 complex entries per 1q gate
        split re/im, target, control (-1 for non-cx).

        Cached on the instance: repeated simulation of the same circuit (the
        benchmark's 5-run protocol) pays the Python gate loop once.
        """
        cached = getattr(self, "_soa_cache", None)
        if cached is not None and cached[0] == len(self.gates):
            return cached[1]
        m = len(self.gates)
        u_re = np.zeros((m, 4), dtype=np.float64)
        u_im = np.zeros((m, 4), dtype=np.float64)
        target = np.empty(m, dtype=np.int32)
        control = np.full(m, -1, dtype=np.int32)
        for j, g in enumerate(self.gates):
            if g.is_cx:
                control[j], target[j] = g.qubits
            else:
                target[j] = g.qubits[0]
                u = g.matrix().reshape(-1)
                u_re[j] = u.real
                u_im[j] = u.imag
        soa = (u_re, u_im, target, control)
        self._soa_cache = (m, soa)
        return soa

    def gate_counts(self) -> dict:
        out: dict = {}
        for g in self.gates:
            out[g.name] = out.get(g.name, 0) + 1
        return out

    def qubit_usage(self) -> np.ndarray:
        """Per-qubit op-touch histogram (the permute pass's sort key).

        Correct version of the reference's histogram (whose constant-variant
        indexes one past the op list, quantum_simulator_preproces_permute.cu:396-401).
        """
        hist = np.zeros(self.num_qubits, dtype=np.int64)
        for g in self.gates:
            for q in g.qubits:
                hist[q] += 1
        return hist

    _DAGGER = {"s": "sdg", "sdg": "s", "t": "tdg", "tdg": "t",
               "sx": "sxdg", "sxdg": "sx"}

    def inverse(self) -> "Circuit":
        """The exact unitary inverse: gates reversed, each daggered.

        The gate set is dagger-closed (id/x/y/z/h/cx self-inverse;
        s/t/sx pair with their dg forms; rotations negate; u(t,p,l)
        dagger = u(-t,-l,-p)), so no decomposition or global-phase slip
        is involved — running ``c`` then ``c.inverse()`` restores any
        state exactly."""
        out = Circuit(self.num_qubits)
        for g in reversed(self.gates):
            name, params = g.name, g.params
            if name in ("rz", "rx", "ry", "p"):
                params = (-params[0],)
            elif name == "u":
                t, p, l = params
                params = (-t, -l, -p)
            else:
                name = self._DAGGER.get(name, name)
            out.append(name, *g.qubits, params=params)
        return out

    def compose(self, other: "Circuit", qubits=None) -> "Circuit":
        """Append ``other``'s gates, mapping its qubit k to ``qubits[k]``
        (identity mapping by default).  Mutates and returns self."""
        if qubits is None:
            qubits = range(other.num_qubits)
        qmap = [int(q) for q in qubits]
        if len(qmap) != other.num_qubits:
            raise ValueError(
                f"need {other.num_qubits} target qubits, got {len(qmap)}")
        for q in qmap:
            if not 0 <= q < self.num_qubits:
                raise ValueError(f"target qubit {q} out of range")
        if len(set(qmap)) != len(qmap):
            raise ValueError("target qubits must be distinct")
        # snapshot: ``other`` may be ``self`` (c.compose(c) doubles a
        # circuit); iterating the live list while append() extends it
        # would never terminate
        for g in list(other.gates):
            self.append(g.name, *(qmap[q] for q in g.qubits), params=g.params)
        return self

    def relabeled(self, perm: "np.ndarray") -> "Circuit":
        """Return a copy with qubit q relabeled to perm[q]."""
        perm = np.asarray(perm)
        if sorted(perm.tolist()) != list(range(self.num_qubits)):
            raise ValueError("perm must be a permutation of range(num_qubits)")
        out = Circuit(self.num_qubits)
        for g in self.gates:
            out.append(g.name, *(int(perm[q]) for q in g.qubits), params=g.params)
        return out

    def to_qasm(self) -> str:
        """Serialize to the OpenQASM-3 subset the front-end accepts."""
        lines = [
            "OPENQASM 3.0;",
            'include "stdgates.inc";',
            f"qubit[{self.num_qubits}] q;",
        ]
        for g in self.gates:
            if g.params:
                head = f"{g.name}({', '.join(repr(p) for p in g.params)})"
            else:
                head = g.name
            args = ", ".join(f"q[{q}]" for q in g.qubits)
            lines.append(f"{head} {args};")
        return "\n".join(lines) + "\n"
