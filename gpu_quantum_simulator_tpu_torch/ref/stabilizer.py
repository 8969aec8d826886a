"""CHP stabilizer-tableau reference engine (Aaronson-Gottesman 2004).

The JAX package's ``ref/stabilizer.py`` copied: host numpy only.

An INDEPENDENT correctness oracle that scales where the f64 state-vector
reference (ref/cpu.py, 2^n memory) cannot: a Clifford circuit at n = 30
simulates in milliseconds on a (2n x 2n+1)-bit tableau, so the large-n
split-state engines' samples can be validated against exact stabilizer
predictions — deterministic Z-parity constraints, <Z...Z> expectations,
and full CHP measurement sampling — with no 2^30 anything host-side.

The reference repo has no analog (its correctness story was eyeballed
amplitude dumps, quantum_simulator_naive.cu:207-216); this plays the
role its missing ground-truth harness should have played, at widths
beyond any dense method.

Supported gates: h, s, sdg, x, y, z, cx + the Clifford composites the
front-end lowers through them (cz, swap via cx) and rz/p at multiples of
pi/2.  ``from_circuit`` raises on anything non-Clifford.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..ir.circuit import Circuit

_HALF_PI_NAMES = {0: None, 1: "s", 2: "z", 3: "sdg"}


class StabilizerState:
    """Tableau rows 0..n-1 = destabilizers, n..2n-1 = stabilizers."""

    def __init__(self, num_qubits: int):
        n = int(num_qubits)
        if n < 1:
            raise ValueError("num_qubits must be >= 1")
        self.n = n
        self.x = np.zeros((2 * n, n), dtype=bool)
        self.z = np.zeros((2 * n, n), dtype=bool)
        self.r = np.zeros(2 * n, dtype=bool)
        self.x[np.arange(n), np.arange(n)] = True          # destab X_i
        self.z[np.arange(n, 2 * n), np.arange(n)] = True   # stab Z_i

    # ---------------------------------------------------------- gates
    def h(self, q: int):
        self.r ^= self.x[:, q] & self.z[:, q]
        self.x[:, q], self.z[:, q] = (self.z[:, q].copy(),
                                      self.x[:, q].copy())
        return self

    def s(self, q: int):
        self.r ^= self.x[:, q] & self.z[:, q]
        self.z[:, q] ^= self.x[:, q]
        return self

    def z_(self, q: int):
        self.r ^= self.x[:, q]
        return self

    def x_(self, q: int):
        self.r ^= self.z[:, q]
        return self

    def y_(self, q: int):
        self.r ^= self.x[:, q] ^ self.z[:, q]
        return self

    def sdg(self, q: int):
        return self.z_(q).s(q)

    def cx(self, c: int, t: int):
        self.r ^= (self.x[:, c] & self.z[:, t]
                   & (self.x[:, t] ^ self.z[:, c] ^ True))
        self.x[:, t] ^= self.x[:, c]
        self.z[:, c] ^= self.z[:, t]
        return self

    def apply(self, name: str, qubits: Sequence[int],
              params: Sequence[float] = ()) -> "StabilizerState":
        name = name.lower()
        if name == "h":
            return self.h(qubits[0])
        if name == "s":
            return self.s(qubits[0])
        if name == "sdg":
            return self.sdg(qubits[0])
        if name == "x":
            return self.x_(qubits[0])
        if name == "y":
            return self.y_(qubits[0])
        if name == "z":
            return self.z_(qubits[0])
        if name == "id":
            return self
        if name == "cx":
            return self.cx(*qubits)
        if name in ("rz", "p", "u1"):
            k = (params[0] / (math.pi / 2)) % 4
            if abs(k - round(k)) > 1e-9:
                raise ValueError(
                    f"{name}({params[0]}) is not Clifford (needs a "
                    "multiple of pi/2)")
            sub = _HALF_PI_NAMES[int(round(k)) % 4]
            # rz = diag(1, e^{i theta}): equals S/Z/Sdg up to global phase
            return self if sub is None else self.apply(sub, qubits)
        if name == "sx":
            # sx = h s h  exactly ((1/2)[[1+i,1-i],[1-i,1+i]])
            return self.h(qubits[0]).s(qubits[0]).h(qubits[0])
        if name == "sxdg":
            return self.h(qubits[0]).sdg(qubits[0]).h(qubits[0])
        raise ValueError(f"gate {name!r} is not Clifford-trackable")

    @classmethod
    def from_circuit(cls, circuit: Circuit) -> "StabilizerState":
        st = cls(circuit.num_qubits)
        for g in circuit.gates:
            st.apply(g.name, g.qubits, g.params)
        return st

    # ------------------------------------------------------ internals
    def _rowsum(self, h: int, i: int) -> None:
        """Row h *= row i (Pauli product with phase tracking)."""
        x1, z1 = self.x[i], self.z[i]
        x2, z2 = self.x[h], self.z[h]
        # per-qubit phase exponent g in {-1, 0, 1} (Aaronson-Gottesman)
        g = np.zeros(self.n, dtype=np.int64)
        both = x1 & z1
        g[both] = (z2[both].astype(np.int64) - x2[both].astype(np.int64))
        only_x = x1 & ~z1
        g[only_x] = (z2[only_x].astype(np.int64)
                     * (2 * x2[only_x].astype(np.int64) - 1))
        only_z = ~x1 & z1
        g[only_z] = (x2[only_z].astype(np.int64)
                     * (1 - 2 * z2[only_z].astype(np.int64)))
        tot = (2 * int(self.r[h]) + 2 * int(self.r[i]) + int(g.sum())) % 4
        self.r[h] = bool(tot // 2)
        self.x[h] ^= x1
        self.z[h] ^= z1

    # ----------------------------------------------------- measurement
    def measure(self, q: int, rng: np.random.Generator) -> int:
        """Measure qubit q in the computational basis (collapses)."""
        n = self.n
        ps = np.nonzero(self.x[n:, q])[0]
        if ps.size:                      # random outcome
            p = int(ps[0]) + n
            for i in range(2 * n):
                if i != p and self.x[i, q]:
                    self._rowsum(i, p)
            self.x[p - n] = self.x[p]
            self.z[p - n] = self.z[p]
            self.r[p - n] = self.r[p]
            self.x[p] = False
            self.z[p] = False
            self.z[p, q] = True
            out = int(rng.integers(0, 2))
            self.r[p] = bool(out)
            return out
        # deterministic: accumulate into a scratch row
        sx, sz, sr = self.x, self.z, self.r
        self.x = np.vstack([sx, np.zeros((1, n), dtype=bool)])
        self.z = np.vstack([sz, np.zeros((1, n), dtype=bool)])
        self.r = np.append(sr, False)
        for i in range(n):
            if self.x[i, q]:
                self._rowsum(2 * n, i + n)
        out = int(self.r[2 * n])
        self.x, self.z, self.r = self.x[:-1], self.z[:-1], self.r[:-1]
        return out

    def sample(self, num_samples: int, seed: int = 0) -> np.ndarray:
        """CHP measurement sampling: basis indices (little-endian, qubit
        k = bit k — the library convention)."""
        rng = np.random.default_rng(seed)
        out = np.empty(num_samples, dtype=np.int64)
        base = self
        for s in range(num_samples):
            st = base.copy()
            v = 0
            for q in range(self.n):
                v |= st.measure(q, rng) << q
            out[s] = v
        return out

    def copy(self) -> "StabilizerState":
        st = StabilizerState.__new__(StabilizerState)
        st.n = self.n
        st.x = self.x.copy()
        st.z = self.z.copy()
        st.r = self.r.copy()
        return st

    # ----------------------------------------------------- observables
    def expectation_z(self, qubits: Iterable[int]) -> int:
        """<Z_{q1} Z_{q2} ...> — exactly -1, 0, or +1 for a stabilizer
        state.  0 unless the Z-product is (+/-) a stabilizer, decided by
        Gaussian elimination over the stabilizer group."""
        n = self.n
        target_z = np.zeros(n, dtype=bool)
        for q in qubits:
            target_z[q] ^= True
        # accumulate a product of stabilizer rows whose X-part is zero
        # and Z-part equals target: use destabilizer trick — the product
        # of stabilizers S_i for which the DEStabilizer anticommutes with
        # the target... simplest correct route: scratch-row reduction as
        # in deterministic measurement, but for the full Z-string.
        # The Z-string is deterministic iff its support avoids every
        # stabilizer X (i.e. commutes with all stabilizers).
        for p in range(n, 2 * n):
            # anticommutes iff |x_p AND target_z| is odd
            if bool(np.logical_and(self.x[p], target_z).sum() % 2):
                return 0
        st = self.copy()
        st.x = np.vstack([st.x, np.zeros((1, n), dtype=bool)])
        st.z = np.vstack([st.z, np.zeros((1, n), dtype=bool)])
        st.r = np.append(st.r, False)
        for i in range(n):
            # destabilizer i anticommutes with target iff x_i overlaps
            if bool(np.logical_and(self.x[i], target_z).sum() % 2):
                st._rowsum(2 * n, i + n)
        if (st.x[2 * n].any() or (st.z[2 * n] != target_z).any()):
            return 0  # pragma: no cover - commuting implies representable
        return -1 if st.r[2 * n] else 1

    def z_parity_constraints(self) -> List[Tuple[int, int]]:
        """Deterministic Z-parity checks as (mask, parity) pairs: every
        ideal computational-basis sample v satisfies
        popcount(v & mask) % 2 == parity.  These are the Z-only elements
        of the stabilizer group (Gaussian elimination over F2)."""
        n = self.n
        # stack stabilizer rows as [X | Z | r] and eliminate X columns
        X = self.x[n:].copy()
        Z = self.z[n:].copy()
        R = self.r[n:].copy()
        row = 0
        for col in range(n):
            piv = None
            for i in range(row, n):
                if X[i, col]:
                    piv = i
                    break
            if piv is None:
                continue
            if piv != row:
                X[[row, piv]] = X[[piv, row]]
                Z[[row, piv]] = Z[[piv, row]]
                R[[row, piv]] = R[[piv, row]]
            for i in range(n):
                if i != row and X[i, col]:
                    # multiply row i by row row — phases need the full
                    # rowsum; do it through a scratch tableau product
                    ph = _pauli_product_phase(X[row], Z[row], X[i], Z[i])
                    X[i] ^= X[row]
                    Z[i] ^= Z[row]
                    R[i] ^= R[row] ^ ph
            row += 1
        out = []
        for i in range(n):
            if not X[i].any() and Z[i].any():
                mask = 0
                for q in np.nonzero(Z[i])[0]:
                    mask |= 1 << int(q)
                out.append((mask, int(R[i])))
        return out


def _pauli_product_phase(x1, z1, x2, z2) -> bool:
    """r-bit correction when multiplying Pauli (x1,z1) INTO (x2,z2):
    True iff the product picks up a -1 (i-powers sum to 2 mod 4)."""
    g = np.zeros(x1.shape, dtype=np.int64)
    both = x1 & z1
    g[both] = z2[both].astype(np.int64) - x2[both].astype(np.int64)
    ox = x1 & ~z1
    g[ox] = z2[ox].astype(np.int64) * (2 * x2[ox].astype(np.int64) - 1)
    oz = ~x1 & z1
    g[oz] = x2[oz].astype(np.int64) * (1 - 2 * z2[oz].astype(np.int64))
    return bool((int(g.sum()) % 4) // 2)


def is_clifford_circuit(circuit: Circuit) -> bool:
    """True when every gate is Clifford-trackable by StabilizerState."""
    try:
        st = StabilizerState(circuit.num_qubits)
        for g in circuit.gates:
            st.apply(g.name, g.qubits, g.params)
        return True
    except ValueError:
        return False


def random_clifford_circuit(num_qubits: int, num_gates: int,
                            seed: int = 0) -> Circuit:
    """Uniform-ish random Clifford circuit over {h, s, sdg, x, z, cx}."""
    rng = np.random.default_rng(seed)
    c = Circuit(num_qubits)
    names_1q = ["h", "s", "sdg", "x", "z"]
    for _ in range(num_gates):
        if num_qubits > 1 and rng.random() < 0.4:
            a, b = rng.choice(num_qubits, size=2, replace=False)
            c.cx(int(a), int(b))
        else:
            c.append(str(rng.choice(names_1q)), int(rng.integers(num_qubits)))
    return c
