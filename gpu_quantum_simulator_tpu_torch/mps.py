"""Matrix-product-state engine: low-entanglement circuits past 2^n.

The JAX package's ``mps.py`` copied: host numpy, no JAX and no torch.

The dense engines stop at n = 30 (one chip) because memory is 2^n; an
MPS stores the state as n site tensors A_i (chi x 2 x chi) and costs
O(n chi^3) per two-qubit gate — hundreds of qubits when entanglement
stays bounded (GHZ/W/product-ish states, shallow dynamics, Trotter
circuits before the entanglement front saturates).  The CUDA reference
has no analog; mainstream simulator stacks ship one, so this closes the
"everything a user expects" gap from the other side of the memory wall.

Design: canonical-center MPS (QR moves, SVD truncation at each 2q gate
with max_bond/cutoff), non-adjacent gates routed by swap chains, exact
amplitude/sampling/Pauli-expectation contractions.  Host numpy
complex128 — this is a capability/ground-truth engine like ref/cpu.py
and ref/stabilizer.py, not the device hot path (the dense engines own
that); the contractions are small-matrix BLAS where a chip buys
nothing below chi ~ 1000.

Truncation error is tracked: ``truncation_error`` accumulates the sum
of discarded squared singular values — 0.0 means the run was EXACT.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .ir.circuit import Circuit


class MPS:
    """Canonical-center matrix product state over n qubits.

    Site tensor i has shape (chi_left, 2, chi_right); qubit i = site i
    (little-endian basis indices everywhere, the library convention)."""

    def __init__(self, num_qubits: int, max_bond: int = 64,
                 cutoff: float = 1e-12):
        n = int(num_qubits)
        if n < 1:
            raise ValueError("num_qubits must be >= 1")
        if max_bond < 1:
            raise ValueError("max_bond must be >= 1")
        self.n = n
        self.max_bond = int(max_bond)
        self.cutoff = float(cutoff)
        self.tensors: List[np.ndarray] = []
        for _ in range(n):
            t = np.zeros((1, 2, 1), dtype=np.complex128)
            t[0, 0, 0] = 1.0
            self.tensors.append(t)
        self.center = 0                  # orthogonality center site
        self.truncation_error = 0.0

    # ------------------------------------------------------ canonical form
    def _move_center_right(self) -> None:
        i = self.center
        t = self.tensors[i]
        cl, _, cr = t.shape
        q, r = np.linalg.qr(t.reshape(cl * 2, cr))
        self.tensors[i] = q.reshape(cl, 2, q.shape[1])
        nxt = self.tensors[i + 1]
        self.tensors[i + 1] = np.einsum("ab,bpc->apc", r, nxt)
        self.center = i + 1

    def _move_center_left(self) -> None:
        i = self.center
        t = self.tensors[i]
        cl, _, cr = t.shape
        # LQ via QR of the transpose
        q, r = np.linalg.qr(t.reshape(cl, 2 * cr).conj().T)
        self.tensors[i] = q.conj().T.reshape(q.shape[1], 2, cr)
        prv = self.tensors[i - 1]
        self.tensors[i - 1] = np.einsum("apb,bc->apc", prv, r.conj().T)
        self.center = i - 1

    def _center_to(self, pos: int) -> None:
        while self.center < pos:
            self._move_center_right()
        while self.center > pos:
            self._move_center_left()

    # ------------------------------------------------------------- gates
    def apply_1q(self, u: np.ndarray, q: int) -> None:
        self.tensors[q] = np.einsum(
            "st,atb->asb", np.asarray(u, dtype=np.complex128),
            self.tensors[q])

    def apply_2q(self, u4: np.ndarray, q: int) -> None:
        """Two-qubit gate on adjacent sites (q, q+1); u4 basis little-
        endian: index = bit(q+1)*2 + bit(q)."""
        self._center_to(q)
        a, b = self.tensors[q], self.tensors[q + 1]
        cl = a.shape[0]
        cr = b.shape[2]
        theta = np.einsum("asb,btc->astc", a, b)       # (cl, s, t, cr)
        u = np.asarray(u4, dtype=np.complex128).reshape(2, 2, 2, 2)
        # u[(t's')(ts)] with index = t*2 + s -> axes (t_out, s_out, t, s)
        theta = np.einsum("TSts,astc->aSTc", u, theta)
        m = theta.reshape(cl * 2, 2 * cr)
        uu, ss, vh = np.linalg.svd(m, full_matrices=False)
        keep = int(np.sum(ss > self.cutoff * (ss[0] if ss.size else 1.0)))
        keep = max(1, min(keep, self.max_bond))
        if keep < ss.size:
            self.truncation_error += float(np.sum(ss[keep:] ** 2))
        ss = ss[:keep]
        self.tensors[q] = uu[:, :keep].reshape(cl, 2, keep)
        self.tensors[q + 1] = (ss[:, None] * vh[:keep]).reshape(keep, 2, cr)
        self.center = q + 1

    def apply_gate(self, name: str, qubits: Sequence[int],
                   params: Sequence[float] = ()) -> None:
        from .ir.circuit import Gate

        g = Gate(name, tuple(qubits), tuple(params))
        if len(qubits) == 1:
            self.apply_1q(g.matrix(), qubits[0])
            return
        if len(qubits) != 2:
            raise ValueError("MPS applies 1q and 2q gates")
        a, b = qubits
        if g.is_cx:
            u4 = np.eye(4, dtype=np.complex128)
            # basis index = bit(high)*2 + bit(low) over sorted (low, high)
            lo, hi = min(a, b), max(a, b)
            cbit = 0 if a == lo else 1
            for col in range(4):
                if (col >> cbit) & 1:
                    u4[:, col] = 0
                    u4[col ^ (1 << (1 - cbit)), col] = 1
        else:
            u4 = np.asarray(g.matrix(), dtype=np.complex128)
            lo, hi = min(a, b), max(a, b)
            if (a, b) != (lo, hi):
                raise ValueError(
                    "2q u-op matrices use sorted qubit order")  # engines' rule
        self._apply_2q_routed(u4, lo, hi)

    def _apply_2q_routed(self, u4: np.ndarray, lo: int, hi: int) -> None:
        """Route a (lo, hi) gate through adjacent swaps: bring hi next to
        lo, apply, swap back (each swap is itself an adjacent 2q gate)."""
        SWAP = np.eye(4, dtype=np.complex128)[[0, 2, 1, 3]]
        pos = hi
        while pos > lo + 1:
            self.apply_2q(SWAP, pos - 1)
            pos -= 1
        self.apply_2q(u4, lo)
        while pos < hi:
            self.apply_2q(SWAP, pos)
            pos += 1

    def run_circuit(self, circuit: Circuit) -> "MPS":
        for g in circuit.gates:
            self.apply_gate(g.name, g.qubits, g.params)
        return self

    @classmethod
    def from_circuit(cls, circuit: Circuit, max_bond: int = 64,
                     cutoff: float = 1e-12) -> "MPS":
        return cls(circuit.num_qubits, max_bond, cutoff).run_circuit(circuit)

    # ----------------------------------------------------------- outputs
    def amplitude(self, basis_index: int) -> complex:
        """<basis_index|psi> (little-endian bits = sites)."""
        v = np.ones((1,), dtype=np.complex128)
        for i in range(self.n):
            bit = (basis_index >> i) & 1
            v = np.einsum("a,ab->b", v, self.tensors[i][:, bit, :])
        return complex(v[0])

    def norm(self) -> float:
        e = np.ones((1, 1), dtype=np.complex128)
        for t in self.tensors:
            e = np.einsum("ab,apc,bpd->cd", e, t.conj(), t)
        return float(np.real(e[0, 0]))

    def to_statevector(self) -> np.ndarray:
        if self.n > 20:
            raise ValueError("to_statevector materializes 2^n: n <= 20")
        # contract right-to-left so site i lands on basis bit i
        # (little-endian, the library convention)
        v = np.ones((1, 1), dtype=np.complex128)   # (basis-suffix, chi)
        for t in reversed(self.tensors):
            v = np.einsum("apb,kb->kpa", t, v).reshape(-1, t.shape[0])
        return v[:, 0]

    def sample(self, num_samples: int, seed: int = 0) -> List[int]:
        """Sequential conditional sampling (exact given the MPS).  Returns
        python ints (basis indices can exceed 64 bits past n = 63)."""
        self._center_to(0)
        rng = np.random.default_rng(seed)
        out: List[int] = []
        for _ in range(num_samples):
            v = np.ones((1,), dtype=np.complex128)
            idx = 0
            for i in range(self.n):
                t = self.tensors[i]
                # site marginals conditioned on the chosen prefix.  With
                # the center at 0 every site right of i is RIGHT-isometric,
                # so the conditional probability is the local norm.
                w0 = np.einsum("a,ab->b", v, t[:, 0, :])
                w1 = np.einsum("a,ab->b", v, t[:, 1, :])
                p0 = float(np.real(np.vdot(w0, w0)))
                p1 = float(np.real(np.vdot(w1, w1)))
                tot = p0 + p1
                bit = int(rng.random() * tot >= p0)
                idx |= bit << i
                v = (w1 if bit else w0) / np.sqrt(p1 if bit else p0)
            out.append(idx)
        return out

    def expectation_pauli(self, pauli: str) -> float:
        """<P> for a Pauli string (dense "IXZY" or sparse "X0 Z3" spec)."""
        from .observables import _parse_pauli

        ops = _parse_pauli(pauli, self.n)
        P1 = {"X": np.array([[0, 1], [1, 0]], dtype=np.complex128),
              "Y": np.array([[0, -1j], [1j, 0]], dtype=np.complex128),
              "Z": np.diag([1.0, -1.0]).astype(np.complex128)}
        e = np.ones((1, 1), dtype=np.complex128)
        for i, t in enumerate(self.tensors):
            if i in ops:
                tp = np.einsum("st,atb->asb", P1[ops[i]], t)
            else:
                tp = t
            e = np.einsum("ab,apc,bpd->cd", e, t.conj(), tp)
        val = complex(e[0, 0]) / self.norm()
        return float(np.real(val))

    def entanglement_entropy(self, cut: int, base: float = 2.0) -> float:
        """Von Neumann entropy of qubits [0, cut) — one SVD at the cut."""
        if not 0 < cut < self.n:
            raise ValueError(f"cut must be in (0, {self.n})")
        self._center_to(cut)
        t = self.tensors[cut]
        cl = t.shape[0]
        s = np.linalg.svd(t.reshape(cl, -1), compute_uv=False)
        p = s ** 2
        p = p[p > 1e-15]
        p = p / p.sum()
        return float(-(p * (np.log(p) / np.log(base))).sum())

    def max_bond_dim(self) -> int:
        return max(t.shape[2] for t in self.tensors)


def run_mps(circuit: Circuit, max_bond: int = 64, cutoff: float = 1e-12):
    """Convenience: circuit -> MPS (see class docs for outputs)."""
    return MPS.from_circuit(circuit, max_bond=max_bond, cutoff=cutoff)
