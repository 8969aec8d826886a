"""Composite-gate decompositions into the native set {1q matrices, cx}.

Engines never see these names — the front-end lowers them here, so every
strategy (including the fused/MXU paths) gets them for free.

The parameterized family follows the standard qelib1.inc bodies EXACTLY
(including global phase: every identity is written in terms of
u1 = diag(1, e^{i lambda}) — the repo's rz/p convention — and the standard
u3, so lowering a qiskit-exported circuit reproduces its amplitudes
bit-for-bit, not merely up to phase).

The port's JAX-free copy of ``gpu_quantum_simulator_tpu/ir/decompose.py``
(host numpy and scipy), held to the original gate for gate by
tests/test_torch_decompose.py.
"""

from __future__ import annotations

import math

from .circuit import Circuit

# name -> (arity, number of parameters)
COMPOSITE_GATES = {
    "cz": (2, 0), "swap": (2, 0), "ccx": (3, 0), "ccz": (3, 0),
    "cy": (2, 0), "ch": (2, 0), "cswap": (3, 0),
    "u1": (1, 1), "u2": (1, 2), "u3": (1, 3),
    "crz": (2, 1), "cp": (2, 1), "cu1": (2, 1), "cu3": (2, 3),
    "crx": (2, 1), "cry": (2, 1),
    "rzz": (2, 1), "rxx": (2, 1), "ryy": (2, 1),
}


def emit_cz(c: Circuit, a: int, b: int) -> None:
    c.h(b)
    c.cx(a, b)
    c.h(b)


def emit_swap(c: Circuit, a: int, b: int) -> None:
    c.cx(a, b)
    c.cx(b, a)
    c.cx(a, b)


def emit_ccz(c: Circuit, a: int, b: int, t: int) -> None:
    """Standard T-depth CCZ (no Hadamard conjugation)."""
    c.cx(b, t)
    c.tdg(t)
    c.cx(a, t)
    c.t(t)
    c.cx(b, t)
    c.tdg(t)
    c.cx(a, t)
    c.t(b)
    c.t(t)
    c.cx(a, b)
    c.tdg(b)
    c.cx(a, b)
    c.t(a)


def emit_ccx(c: Circuit, a: int, b: int, t: int) -> None:
    c.h(t)
    emit_ccz(c, a, b, t)
    c.h(t)


def emit_cy(c: Circuit, a: int, b: int) -> None:
    c.sdg(b)
    c.cx(a, b)
    c.s(b)


def emit_ch(c: Circuit, a: int, b: int) -> None:
    # H = Ry(pi/4) Z Ry(-pi/4) (both are reflections), so controlled-H
    # conjugates an exact CZ — no global-phase slack anywhere.  Circuit
    # order is left-to-right: apply Ry(-pi/4) first.
    c.ry(-math.pi / 4, b)
    emit_cz(c, a, b)
    c.ry(math.pi / 4, b)


def emit_cswap(c: Circuit, ctl: int, a: int, b: int) -> None:
    c.cx(b, a)
    emit_ccx(c, ctl, a, b)
    c.cx(b, a)


def _u1(c: Circuit, lam: float, q: int) -> None:
    c.append("p", q, params=(lam,))


def _u3(c: Circuit, theta: float, phi: float, lam: float, q: int) -> None:
    c.append("u", q, params=(theta, phi, lam))


def emit_composite(c: Circuit, name: str, qubits, params=()) -> None:
    arity, nparams = COMPOSITE_GATES[name]
    if len(qubits) != arity or len(set(qubits)) != arity:
        raise ValueError(f"{name} expects {arity} distinct qubits")
    if len(params) != nparams:
        raise ValueError(f"{name} expects {nparams} parameter(s), "
                         f"got {len(params)}")
    if name == "cz":
        emit_cz(c, *qubits)
    elif name == "swap":
        emit_swap(c, *qubits)
    elif name == "ccx":
        emit_ccx(c, *qubits)
    elif name == "ccz":
        emit_ccz(c, *qubits)
    elif name == "cy":
        emit_cy(c, *qubits)
    elif name == "ch":
        emit_ch(c, *qubits)
    elif name == "cswap":
        emit_cswap(c, *qubits)
    elif name == "u1":
        _u1(c, params[0], qubits[0])
    elif name == "u2":
        _u3(c, math.pi / 2, params[0], params[1], qubits[0])
    elif name == "u3":
        _u3(c, *params, qubits[0])
    elif name == "crz":
        (lam,), (a, b) = params, qubits
        _u1(c, lam / 2, b)
        c.cx(a, b)
        _u1(c, -lam / 2, b)
        c.cx(a, b)
    elif name in ("cp", "cu1"):
        (lam,), (a, b) = params, qubits
        _u1(c, lam / 2, a)
        c.cx(a, b)
        _u1(c, -lam / 2, b)
        c.cx(a, b)
        _u1(c, lam / 2, b)
    elif name == "cu3":
        (theta, phi, lam), (a, b) = params, qubits
        _u1(c, (lam + phi) / 2, a)
        _u1(c, (lam - phi) / 2, b)
        c.cx(a, b)
        _u3(c, -theta / 2, 0.0, -(phi + lam) / 2, b)
        c.cx(a, b)
        _u3(c, theta / 2, phi, 0.0, b)
    elif name == "crx":
        (lam,), (a, b) = params, qubits
        _u1(c, math.pi / 2, b)
        c.cx(a, b)
        _u3(c, -lam / 2, 0.0, 0.0, b)
        c.cx(a, b)
        _u3(c, lam / 2, -math.pi / 2, 0.0, b)
    elif name == "cry":
        (lam,), (a, b) = params, qubits
        _u3(c, lam / 2, 0.0, 0.0, b)
        c.cx(a, b)
        _u3(c, -lam / 2, 0.0, 0.0, b)
        c.cx(a, b)
    elif name == "rzz":
        (theta,), (a, b) = params, qubits
        c.cx(a, b)
        _u1(c, theta, b)
        c.cx(a, b)
    elif name == "rxx":
        (theta,), (a, b) = params, qubits
        _u3(c, math.pi / 2, theta, 0.0, a)
        c.h(b)
        c.cx(a, b)
        _u1(c, -theta, b)
        c.cx(a, b)
        c.h(b)
        c.append("u", a, params=(math.pi / 2, -math.pi, math.pi - theta))
    elif name == "ryy":
        # exact exp(-i theta/2 YY) (qiskit's convention; qelib1 has no
        # ryy): conjugate the cx-rz-cx core by rx(pi/2) on both qubits
        # (rx maps Z -> Y).  The core is e^{i theta/2} exp(-i theta/2 ZZ)
        # in this library's rz = diag(1, e^{i theta}) convention, so the
        # leading p-x-p-x pair contributes the compensating e^{-i theta/2}
        (theta,), (a, b) = params, qubits
        c.p(-theta / 2, a)
        c.x(a)
        c.p(-theta / 2, a)
        c.x(a)
        c.rx(math.pi / 2, a)
        c.rx(math.pi / 2, b)
        c.cx(a, b)
        c.rz(theta, b)
        c.cx(a, b)
        c.rx(-math.pi / 2, a)
        c.rx(-math.pi / 2, b)
    else:  # pragma: no cover
        raise ValueError(name)


def zyz_angles(u):
    """(theta, phi, lam, gamma) with u = e^{i gamma} * u3(theta, phi, lam).

    The controlled-gate lowering for ARBITRARY 1q unitaries (QASM3
    ``ctrl @``): controlled-u = p(gamma) on the control (the phase fires
    exactly when the control is 1) followed by cu3(theta, phi, lam)."""
    import cmath

    import numpy as np

    u = np.asarray(u, dtype=complex)
    a, b, c_, d = u[0, 0], u[0, 1], u[1, 0], u[1, 1]
    theta = 2.0 * math.atan2(abs(c_), abs(a))
    if abs(a) < 1e-12:              # theta = pi: top-left column vanishes
        gamma = cmath.phase(c_)
        phi = 0.0
        lam = cmath.phase(-b) - gamma
    elif abs(c_) < 1e-12:           # theta = 0: diagonal
        gamma = cmath.phase(a)
        phi = 0.0
        lam = cmath.phase(d) - gamma
    else:
        gamma = cmath.phase(a)
        phi = cmath.phase(c_) - gamma
        lam = cmath.phase(-b) - gamma
    return theta, phi, lam, gamma


# ---------------------------------------------------------------- KAK / 2q
# Cartan decomposition of an arbitrary two-qubit unitary into native gates:
# U = e^{i phi} (A1 (x) A0) exp(i (a XX + b YY + c ZZ)) (B1 (x) B0).
# The middle factors into the COMMUTING pair products Rxx Ryy Rzz (XX, YY,
# ZZ mutually commute), each a library composite, and the 1q factors lower
# through zyz_angles.  A simulator-oriented choice: exactness over cx
# count — the fusion passes collapse the whole sequence into one dense
# 4x4 block anyway, so the canonical 3-cx circuit would buy nothing here.

_MAGIC = None


def _magic():
    import numpy as np

    global _MAGIC
    if _MAGIC is None:
        s = 2.0 ** -0.5
        _MAGIC = s * np.array(
            [[1, 0, 0, 1j],
             [0, 1j, 1, 0],
             [0, 1j, -1, 0],
             [1, 0, 0, -1j]], dtype=complex)
    return _MAGIC


def _factor_kron(m):
    """(v1, v0) with m = kron(v1, v0) for an exactly-separable 4x4 (rank-1
    nearest-Kronecker via the reshuffled SVD), each factor unitarized."""
    import numpy as np

    r = np.asarray(m, dtype=complex).reshape(2, 2, 2, 2)
    r = r.transpose(0, 2, 1, 3).reshape(4, 4)    # (i1 j1, i0 j0)
    u, s, vh = np.linalg.svd(r)
    if s[1] > 1e-8 * s[0]:
        raise ValueError("matrix is not a Kronecker product")
    v1 = (u[:, 0] * np.sqrt(s[0])).reshape(2, 2)
    v0 = (vh[0] * np.sqrt(s[0])).reshape(2, 2)
    # unitarize each factor (split the scale/phase slack evenly)
    d1 = np.linalg.det(v1).astype(complex)
    d0 = np.linalg.det(v0).astype(complex)
    v1 = v1 / np.sqrt(d1)
    v0 = v0 * np.sqrt(d1)
    del d0
    return v1, v0


def kak_decompose(u):
    """(phase, A1, A0, (a, b, c), B1, B0) with, as matrices over the basis
    index = bit1*2 + bit0,

        u = e^{i phase} kron(A1, A0) @ expm(i (a XX + b YY + c ZZ))
            @ kron(B1, B0)

    Robust over the degenerate classes (CNOT, SWAP, identity, kron
    products): the complex-symmetric Gram matrix in the magic basis is
    jointly diagonalized through a randomized real-combination retry loop.
    """
    import numpy as np

    u = np.asarray(u, dtype=complex)
    if u.shape != (4, 4):
        raise ValueError(f"kak_decompose needs a 4x4 unitary, got {u.shape}")
    if np.max(np.abs(u @ u.conj().T - np.eye(4))) > 1e-8:
        raise ValueError("kak_decompose needs a unitary matrix")
    E = _magic()
    su = u / np.linalg.det(u).astype(complex) ** 0.25
    m = E.conj().T @ su @ E
    gram = m.T @ m

    gr, gi = gram.real, gram.imag
    rng = np.random.default_rng(7)
    Q = None
    for _ in range(24):
        t = rng.standard_normal()
        _, q = np.linalg.eigh(gr + t * gi)
        d = q.T @ gram @ q
        if np.max(np.abs(d - np.diag(np.diag(d)))) < 1e-9:
            Q = q
            break
    if Q is None:  # pragma: no cover - the retry loop converges in practice
        raise ValueError("failed to diagonalize the magic-basis Gram matrix")
    if np.linalg.det(Q) < 0:
        Q[:, 0] = -Q[:, 0]

    two_theta = np.angle(np.diag(Q.T @ gram @ Q))
    theta = two_theta / 2.0
    # branch selection: det(gamma) = 1 makes sum(theta) = j*pi for integer
    # j; the angle system below needs sum(theta) EXACTLY 0.  Shifting any
    # theta_k by pi leaves Lambda_k = exp(2i theta_k) unchanged (it only
    # flips the sign of D_k, i.e. of one real column of O1), so walk j to 0
    j = int(round(np.sum(theta) / np.pi))
    i = 0
    while j != 0:
        step = 1 if j > 0 else -1
        theta[i % 4] -= np.pi * step
        j -= step
        i += 1
    D = np.exp(1j * theta)
    O2 = Q.T
    O1 = m @ Q @ np.diag(1.0 / D)
    if np.max(np.abs(O1.imag)) > 1e-7:  # pragma: no cover
        raise ValueError("KAK left factor failed to be real orthogonal")
    O1 = O1.real

    # canonical coefficients: XX/YY/ZZ are diagonal in the magic basis
    X = np.array([[0, 1], [1, 0]], dtype=complex)
    Y = np.array([[0, -1j], [1j, 0]], dtype=complex)
    Z = np.array([[1, 0], [0, -1]], dtype=complex)
    cols = []
    for P in (X, Y, Z):
        PP = np.kron(P, P)
        cols.append(np.real(np.diag(E.conj().T @ PP @ E)))
    A = np.stack(cols, axis=1)                       # (4, 3)
    abc, *_ = np.linalg.lstsq(A, theta, rcond=None)
    if np.max(np.abs(A @ abc - theta)) > 1e-8:  # pragma: no cover
        raise ValueError("KAK angle system inconsistent")

    L = E @ O1 @ E.conj().T
    R = E @ O2 @ E.conj().T
    A1, A0 = _factor_kron(L)
    B1, B0 = _factor_kron(R)
    # the middle reconstructs exactly; fold every leftover phase into one
    mid = _canonical_matrix(*abc)
    recon = np.kron(A1, A0) @ mid @ np.kron(B1, B0)
    ratio = (u @ np.linalg.inv(recon)).astype(complex)
    phase = np.angle(np.trace(ratio) / 4.0)
    if np.max(np.abs(ratio - np.exp(1j * phase) * np.eye(4))) > 1e-8:
        raise ValueError("KAK reconstruction failed")  # pragma: no cover
    return phase, A1, A0, tuple(float(v) for v in abc), B1, B0


def _canonical_matrix(a, b, c):
    """expm(i (a XX + b YY + c ZZ)) — product of the commuting factors."""
    import numpy as np

    X = np.array([[0, 1], [1, 0]], dtype=complex)
    Y = np.array([[0, -1j], [1j, 0]], dtype=complex)
    Z = np.array([[1, 0], [0, -1]], dtype=complex)
    out = np.eye(4, dtype=complex)
    for coef, P in ((a, X), (b, Y), (c, Z)):
        PP = np.kron(P, P)
        out = out @ (np.cos(coef) * np.eye(4) + 1j * np.sin(coef) * PP)
    return out


def emit_unitary(c: Circuit, u, qubits) -> None:
    """Append an arbitrary 1q or 2q unitary as native gates (exact, global
    phase included).  2q matrix basis: index = bit(qubits[1])*2 +
    bit(qubits[0]) — little-endian over the operand order, the library's
    convention (qubit k = bit k of the basis index)."""
    import numpy as np

    qubits = tuple(qubits)
    u = np.asarray(u, dtype=complex)
    if len(qubits) == 1:
        if u.shape != (2, 2):
            raise ValueError("1-qubit emit_unitary needs a 2x2 matrix")
        theta, phi, lam, gamma = zyz_angles(u)
        q = qubits[0]
        if abs(gamma) > 1e-12:
            c.p(gamma, q)
            c.x(q)
            c.p(gamma, q)
            c.x(q)
        c.append("u", q, params=(theta, phi, lam))
        return
    if len(qubits) > 2:
        emit_unitary_k(c, u, qubits)
        return
    if len(qubits) != 2 or qubits[0] == qubits[1]:
        raise ValueError("emit_unitary takes distinct qubits")
    q0, q1 = qubits
    phase, A1, A0, (a, b, cz), B1, B0 = kak_decompose(u)
    start = len(c.gates)
    emit_unitary(c, B0, (q0,))
    emit_unitary(c, B1, (q1,))
    # exp(i k PP) = Rpp(-2k) with Rpp(t) = exp(-i t/2 PP)
    emit_composite(c, "rxx", (q0, q1), (-2.0 * a,))
    emit_composite(c, "ryy", (q0, q1), (-2.0 * b,))
    emit_composite(c, "rzz", (q0, q1), (-2.0 * cz,))
    emit_unitary(c, A0, (q0,))
    emit_unitary(c, A1, (q1,))
    # the composites carry known global-phase slack (e.g. qelib1's rzz);
    # measure the residual on the emitted tail (a cheap 4x4 product) and
    # cancel it exactly
    resid = _emitted_phase_residual(c, u, (q0, q1), start)
    if abs(resid) > 1e-12:
        c.p(resid, q0)
        c.x(q0)
        c.p(resid, q0)
        c.x(q0)


def _emitted_phase_residual(c: Circuit, u, qubits, start: int):
    """Phase phi with u = e^{i phi} * (unitary of c.gates[start:])."""
    import numpy as np

    q0, q1 = qubits
    total = np.eye(4, dtype=complex)
    for g in c.gates[start:]:
        total = _gate_matrix_2q(g, q0, q1) @ total
    ratio = np.asarray(u, dtype=complex) @ np.linalg.inv(total)
    phase = float(np.angle(np.trace(ratio) / 4.0))
    if np.max(np.abs(ratio - np.exp(1j * phase) * np.eye(4))) > 1e-8:
        raise AssertionError("emit_unitary tail mismatch")  # pragma: no cover
    return phase


def _gate_matrix_2q(g, q0: int, q1: int):
    """The 4x4 of a native gate over (q0, q1), basis bit1*2 + bit0."""
    import numpy as np

    if g.name == "cx":
        ctl, tgt = g.qubits
        cbit = 0 if ctl == q0 else 1
        m = np.eye(4, dtype=complex)
        for col in range(4):
            if (col >> cbit) & 1:
                m[:, col] = 0
                m[col ^ (1 << (1 - cbit)), col] = 1
        return m
    u = g.matrix()
    if g.qubits[0] == q0:
        return np.kron(np.eye(2, dtype=complex), u)
    return np.kron(u, np.eye(2, dtype=complex))


# ----------------------------------------------------- quantum Shannon / kq
# Recursive synthesis of k-qubit unitaries (k >= 3): the cosine-sine
# decomposition splits U over the top qubit into two block-diagonal
# multiplexers around one uniformly-controlled Ry; each multiplexer
# demultiplexes into smaller unitaries around a uniformly-controlled Rz
# (Shende-Bullock-Markov).  Uniformly-controlled rotations lower by the
# Gray-code construction (Mottonen et al.): 2^m rotations + 2^m cx, with
# the angle transform theta -> phi solved from the (-1)^{popcount(gray(j)
# & s)} sign system.  All phase slack (this library's rz = diag(1, e^{i
# theta}) convention) is SCALAR, so one numeric correction at the top
# restores the matrix exactly, global phase included.

_QSD_MAX_QUBITS = 6


def _gray(j: int) -> int:
    return j ^ (j >> 1)


def _emit_mux_rot(c: Circuit, thetas, controls, target: int,
                  kind: str) -> None:
    """Uniformly-controlled rotation: for control state s apply
    R_kind(thetas[s]) to the target (s = little-endian over ``controls``).
    kind='ry' is exact; kind='rz' emits this library's rz (equal to the
    symmetric Rz times a control-independent scalar — corrected at the
    synthesis top level)."""
    import numpy as np

    m = len(controls)
    rot = (lambda th: c.ry(th, target)) if kind == "ry" else \
        (lambda th: c.rz(th, target))
    if m == 0:
        rot(float(thetas[0]))
        return
    size = 1 << m
    M = np.empty((size, size))
    for s in range(size):
        for j in range(size):
            M[s, j] = -1.0 if bin(_gray(j) & s).count("1") % 2 else 1.0
    phi = np.linalg.solve(M, np.asarray(thetas, dtype=np.float64))
    for j in range(size):
        rot(float(phi[j]))
        if j + 1 < size:
            ctrl = ((j + 1) & -(j + 1)).bit_length() - 1
        else:
            ctrl = m - 1
        c.cx(controls[ctrl], target)


def _emit_demux(c: Circuit, A, B, qs) -> None:
    """Block-diagonal multiplexer [A 0; 0 B] over the top qubit qs[-1]
    (A for bit 0): (I x V) . mux-Rz . (I x W) with A = V D W,
    B = V D^dagger W from the Schur form of A B^dagger."""
    import numpy as np
    import scipy.linalg

    X = A @ B.conj().T
    T, V = scipy.linalg.schur(X, output="complex")
    if np.max(np.abs(T - np.diag(np.diag(T)))) > 1e-9:  # pragma: no cover
        raise ValueError("demultiplexer Schur form is not diagonal")
    d = np.sqrt(np.diag(T).astype(complex))
    W = np.diag(d.conj()) @ V.conj().T @ A
    _emit_qsd(c, W, qs[:-1])
    _emit_mux_rot(c, -2.0 * np.angle(d), qs[:-1], qs[-1], "rz")
    _emit_qsd(c, V, qs[:-1])


def _emit_qsd(c: Circuit, u, qs) -> None:
    import numpy as np

    k = len(qs)
    if k == 1:
        theta, phi, lam, _ = zyz_angles(u)   # scalar slack fixed at top
        c.append("u", qs[0], params=(theta, phi, lam))
        return
    if k == 2:
        # reuse the KAK path (its internal phase fix keeps it exact;
        # harmless under the top-level scalar correction)
        _emit_kak_body(c, np.asarray(u, dtype=complex), qs)
        return
    from scipy.linalg import cossin

    half = 1 << (k - 1)
    (u1, u2), theta, (v1h, v2h) = cossin(
        np.asarray(u, dtype=complex), p=half, q=half, separate=True)
    _emit_demux(c, v1h, v2h, qs)
    _emit_mux_rot(c, 2.0 * np.asarray(theta), qs[:-1], qs[-1], "ry")
    _emit_demux(c, u1, u2, qs)


def _emit_kak_body(c: Circuit, u, qs) -> None:
    """KAK emission without its own trailing phase fix (the QSD top level
    corrects the scalar once for the whole synthesis)."""
    q0, q1 = qs
    _, A1, A0, (a, b, cz), B1, B0 = kak_decompose(u)
    for mat, q in ((B0, q0), (B1, q1)):
        theta, phi, lam, _ = zyz_angles(mat)
        c.append("u", q, params=(theta, phi, lam))
    emit_composite(c, "rxx", (q0, q1), (-2.0 * a,))
    emit_composite(c, "ryy", (q0, q1), (-2.0 * b,))
    emit_composite(c, "rzz", (q0, q1), (-2.0 * cz,))
    for mat, q in ((A0, q0), (A1, q1)):
        theta, phi, lam, _ = zyz_angles(mat)
        c.append("u", q, params=(theta, phi, lam))


def _dense_of_gates(gates, k: int):
    """2^k x 2^k matrix of a native gate list over qubits 0..k-1."""
    import numpy as np

    from ..ref.cpu import apply_gate_numpy

    size = 1 << k
    cols = np.eye(size, dtype=complex)
    for g in gates:
        for i in range(size):
            cols[:, i] = apply_gate_numpy(cols[:, i], k, g)
    return cols


def emit_unitary_k(c: Circuit, u, qubits) -> None:
    """Append a k-qubit unitary (3 <= k <= 6) as native gates via the
    quantum Shannon decomposition; exact including global phase.  Basis:
    index bit i = qubits[i] (little-endian over the operand order)."""
    import numpy as np

    qubits = tuple(qubits)
    k = len(qubits)
    u = np.asarray(u, dtype=complex)
    if u.shape != (1 << k, 1 << k):
        raise ValueError(
            f"emit_unitary_k: got a {u.shape} matrix for {k} qubits")
    if np.max(np.abs(u @ u.conj().T - np.eye(1 << k))) > 1e-8:
        raise ValueError("emit_unitary_k needs a unitary matrix")
    if len(set(qubits)) != k:
        raise ValueError("duplicate qubits")
    if k > _QSD_MAX_QUBITS:
        raise ValueError(
            f"unitary synthesis supports up to {_QSD_MAX_QUBITS} qubits "
            f"(got {k}) — split the operator or supply a circuit")
    scratch = Circuit(k)
    _emit_qsd(scratch, u, list(range(k)))
    dense = _dense_of_gates(scratch.gates, k)
    ratio = u @ np.linalg.inv(dense)
    phase = float(np.angle(np.trace(ratio) / (1 << k)))
    if np.max(np.abs(ratio - np.exp(1j * phase) * np.eye(1 << k))) > 1e-7:
        raise AssertionError("QSD reconstruction failed")  # pragma: no cover
    if abs(phase) > 1e-12:
        scratch.p(phase, 0)
        scratch.x(0)
        scratch.p(phase, 0)
        scratch.x(0)
    for g in scratch.gates:
        c.append(g.name, *(qubits[q] for q in g.qubits), params=g.params)


# ------------------------------------------------------------- state prep
def emit_state_prep(c: Circuit, vec, qubits) -> None:
    """Append gates mapping |0...0> (on ``qubits``) to the given amplitude
    vector (Mottonen et al.): for each qubit from the top down, one
    uniformly-controlled Rz aligns the phases and one uniformly-controlled
    Ry splits the magnitudes.  Exact including global phase; basis: index
    bit i = qubits[i].  The vector is normalized if needed.

    Builds the REVERSE walk (state -> |0>) and appends its inverse, which
    keeps every angle a simple two-amplitude atan2/phase read."""
    import numpy as np

    qubits = tuple(qubits)
    k = len(qubits)
    v = np.asarray(vec, dtype=complex).reshape(-1)
    if v.shape != (1 << k,):
        raise ValueError(
            f"state vector length {v.size} != 2^{k} for {k} qubits")
    norm = np.linalg.norm(v)
    if norm < 1e-12:
        raise ValueError("state vector is zero")
    v = v / norm

    scratch = Circuit(k)
    work = v.copy()
    for q in range(k - 1, -1, -1):
        # fold qubit q (the current top): pairs (a0, a1) over control
        # state s of the remaining low qubits
        half = 1 << q
        a0, a1 = work[:half].copy(), work[half:].copy()
        mags0, mags1 = np.abs(a0), np.abs(a1)
        ry_angles = -2.0 * np.arctan2(mags1, mags0)   # rotate a1 into a0
        ph0 = np.where(mags0 > 1e-12, np.angle(a0), 0.0)
        ph1 = np.where(mags1 > 1e-12, np.angle(a1), 0.0)
        # symmetric Rz(t): phases (+t/2, -t/2); choose t to equalize
        rz_angles = ph0 - ph1
        _emit_mux_rot(scratch, rz_angles, list(range(q)), q, "rz")
        _emit_mux_rot(scratch, ry_angles, list(range(q)), q, "ry")
        r0 = np.exp(1j * (ph0 + ph1) / 2)
        work = r0 * np.sqrt(mags0 ** 2 + mags1 ** 2)
    # work is now a single global phase on |0...0>
    dense = _dense_of_gates(scratch.gates, k)
    final = dense @ v
    if abs(abs(final[0]) - 1.0) > 1e-8:  # pragma: no cover
        raise AssertionError("state-prep reverse walk failed")
    phase = float(np.angle(final[0]))
    inv = scratch.inverse()
    if abs(phase) > 1e-12:
        # scratch maps v -> e^{i phase}|0>, so its inverse lands at
        # e^{-i phase} v: prepend the compensating scalar (it commutes)
        c.append("p", qubits[0], params=(phase,))
        c.x(qubits[0])
        c.append("p", qubits[0], params=(phase,))
        c.x(qubits[0])
    for g in inv.gates:
        c.append(g.name, *(qubits[q] for q in g.qubits), params=g.params)
