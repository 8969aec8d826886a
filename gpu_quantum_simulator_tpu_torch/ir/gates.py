"""Gate definitions for the reference gate set.

The supported set mirrors the reference front-end exactly
(ref: quantum_simulator.c:13-23 name macros, :182-211 matrix construction):
``cx, x, sx, z, s, sdg, t, tdg, rz(theta), h`` plus identity.

Two semantic notes, both matching the reference:

* ``rz(theta)`` here is the *phase gate* diag(1, e^{i theta}) — NOT the
  textbook R_z = diag(e^{-i theta/2}, e^{+i theta/2}).  The reference builds
  ``U = {1, 0, 0, cexp(I*arg)}`` (quantum_simulator.c:205-208); circuits in
  the wild (grover_3_18.qasm) were generated against that convention, so we
  reproduce it.  The two differ only by a global phase per gate, which IS
  observable in amplitude-parity tests, hence we match the reference.

* The reference's butterfly applies the TRANSPOSE of its row-major U
  (``v[i] = tmp0*U[0] + tmp1*U[2]`` at quantum_simulator.c:88-89).  Every
  matrix in this gate set is symmetric, so standard column-convention
  ``v_new = U @ v_old`` (used here) is bit-identical.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

# Gate names with a 2x2 matrix (single-qubit). "cx" is handled structurally.
# The reference set is the first ten + cx; y/ry/rx/u/p are front-end
# extensions (engines are matrix-driven, so they cost nothing).
SINGLE_QUBIT_GATES = (
    "id", "x", "sx", "z", "s", "sdg", "t", "tdg", "rz", "h",
    "y", "ry", "rx", "u", "p", "sxdg",
)
TWO_QUBIT_GATES = ("cx",)
ALL_GATES = SINGLE_QUBIT_GATES + TWO_QUBIT_GATES

_SQRT1_2 = 1.0 / math.sqrt(2.0)

_FIXED: Dict[str, np.ndarray] = {
    "id": np.array([[1, 0], [0, 1]], dtype=np.complex128),
    "x": np.array([[0, 1], [1, 0]], dtype=np.complex128),
    "sx": np.array(
        [[0.5 + 0.5j, 0.5 - 0.5j], [0.5 - 0.5j, 0.5 + 0.5j]], dtype=np.complex128
    ),
    "sxdg": np.array(
        [[0.5 - 0.5j, 0.5 + 0.5j], [0.5 + 0.5j, 0.5 - 0.5j]], dtype=np.complex128
    ),
    "z": np.array([[1, 0], [0, -1]], dtype=np.complex128),
    "s": np.array([[1, 0], [0, 1j]], dtype=np.complex128),
    "sdg": np.array([[1, 0], [0, -1j]], dtype=np.complex128),
    "t": np.array([[1, 0], [0, np.exp(1j * math.pi / 4)]], dtype=np.complex128),
    "tdg": np.array([[1, 0], [0, np.exp(-1j * math.pi / 4)]], dtype=np.complex128),
    "h": np.array([[_SQRT1_2, _SQRT1_2], [_SQRT1_2, -_SQRT1_2]], dtype=np.complex128),
    "y": np.array([[0, -1j], [1j, 0]], dtype=np.complex128),
}

# The 4x4 CNOT in little-endian bit order for qubit pair (control=c, target=t):
# basis index within the pair is (bit_t_value)*? -- we define pair basis as
# |b_hi b_lo> with value 2*b_hi + b_lo where (lo, hi) are the two qubit labels
# sorted ascending.  Helpers below build the right matrix for either ordering.
CNOT_CONTROL_LOW = np.array(
    # control = low bit, target = high bit: flips hi when lo==1
    # basis order |hi lo>: 00,01,10,11 -> 00,11,10,01
    [[1, 0, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0], [0, 1, 0, 0]],
    dtype=np.complex128,
)
CNOT_CONTROL_HIGH = np.array(
    # control = high bit, target = low bit: flips lo when hi==1
    # basis order: 00,01,10,11 -> 00,01,11,10
    [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]],
    dtype=np.complex128,
)


def matrix_1q(name: str, params: tuple = ()) -> np.ndarray:
    """Return the 2x2 complex128 matrix for a single-qubit gate."""
    if name in ("rz", "p"):
        # reference phase convention: diag(1, e^{i theta})
        (theta,) = params
        return np.array([[1, 0], [0, np.exp(1j * theta)]], dtype=np.complex128)
    if name == "ry":
        (theta,) = params
        c, s = math.cos(theta / 2), math.sin(theta / 2)
        return np.array([[c, -s], [s, c]], dtype=np.complex128)
    if name == "rx":
        (theta,) = params
        c, s = math.cos(theta / 2), math.sin(theta / 2)
        return np.array([[c, -1j * s], [-1j * s, c]], dtype=np.complex128)
    if name == "u":
        theta, phi, lam = params
        c, s = math.cos(theta / 2), math.sin(theta / 2)
        return np.array(
            [
                [c, -np.exp(1j * lam) * s],
                [np.exp(1j * phi) * s, np.exp(1j * (phi + lam)) * c],
            ],
            dtype=np.complex128,
        )
    try:
        return _FIXED[name]
    except KeyError:
        raise ValueError(f"unknown single-qubit gate: {name!r}") from None


def cnot_matrix(control: int, target: int) -> np.ndarray:
    """4x4 CNOT on the (min,max)-ordered qubit pair, little-endian pair basis.

    Pair basis index = bit(max_qubit)*2 + bit(min_qubit), mirroring the
    reference's 4x4 promotion (quantum_simulator_4x4.cu:189-217 cnotTo4x4).
    """
    if control == target:
        raise ValueError("cx control and target must differ")
    return CNOT_CONTROL_LOW if control < target else CNOT_CONTROL_HIGH


def tensor_1q_pair(u_low: np.ndarray, u_high: np.ndarray) -> np.ndarray:
    """(U_high ⊗ U_low) on the pair basis |b_hi b_lo>.

    Matches the reference's tensorProd promotion of two 2x2 accumulators into
    a 4x4 (quantum_simulator_4x4.cu:220-233).
    """
    return np.kron(u_high, u_low)


def is_identity(u: np.ndarray, tol: float = 1e-12) -> bool:
    """True if u is the identity (up to tol).

    The reference uses tol=1e-3 (quantum_simulator_preproces.cu:160-163) to
    skip no-op flushes; we use an exact-ish tolerance since float64 host math
    keeps accumulators clean.
    """
    return bool(np.allclose(u, np.eye(u.shape[0]), atol=tol))
