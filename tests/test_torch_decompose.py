"""The port's ``ir/decompose.py`` against the JAX package's (mirrors
tests/test_kak.py).

Seeded Haar unitaries (numpy) go through both packages' synthesis: the
emitted gate lists agree in names and qubits, and in params within 1e-12
(both are float64 numpy on the same host); the port's gates reproduce the
unitary within 1e-10, global phase included; and both packages refuse
non-unitary input with the same error.
"""

import numpy as np
import pytest

from gpu_quantum_simulator_tpu.ir import decompose as JD
from gpu_quantum_simulator_tpu.ir.circuit import Circuit as JCircuit

from gpu_quantum_simulator_tpu_torch.ir import decompose as TD
from gpu_quantum_simulator_tpu_torch.ir.circuit import Circuit
from gpu_quantum_simulator_tpu_torch.ir.oplist import circuit_unitary

PARAM_TOL = 1e-12     # float64 host arithmetic, the same code on both sides
UNITARY_TOL = 1e-10   # reconstruction, global phase included


def _haar(rng, k):
    d = 1 << k
    z = rng.standard_normal((d, d)) + 1j * rng.standard_normal((d, d))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


def assert_same_gates(got, want):
    assert [g.name for g in got] == [g.name for g in want]
    assert [tuple(g.qubits) for g in got] == [tuple(g.qubits) for g in want]
    for g, w in zip(got, want):
        assert len(g.params) == len(w.params)
        assert np.allclose(g.params, w.params, rtol=0, atol=PARAM_TOL), (
            g, w)


def _both(emit, *args, n):
    t, j = Circuit(n), JCircuit(n)
    getattr(TD, emit)(t, *args)
    getattr(JD, emit)(j, *args)
    assert_same_gates(t.gates, j.gates)
    return t


@pytest.mark.parametrize("k,qubits", [(1, (2,)), (2, (0, 1)), (2, (3, 1)),
                                      (3, (0, 2, 4)), (4, (4, 0, 3, 1))])
def test_emit_unitary_matches_jax_and_reproduces(k, qubits):
    rng = np.random.default_rng(100 + k)
    u = _haar(rng, k)
    c = _both("emit_unitary", u, qubits, n=5)
    # the emitted gates on the operand qubits, as a matrix over them
    sub = Circuit(k)
    pos = {q: i for i, q in enumerate(qubits)}
    for g in c.gates:
        sub.append(g.name, *(pos[q] for q in g.qubits), params=g.params)
    assert np.max(np.abs(circuit_unitary(sub) - u)) < UNITARY_TOL


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kak_decompose_matches_jax_and_reproduces(seed):
    u = _haar(np.random.default_rng(seed), 2)
    got, want = TD.kak_decompose(u), JD.kak_decompose(u)
    assert abs(got[0] - want[0]) < PARAM_TOL
    for a, b in zip(got[1:3] + got[4:], want[1:3] + want[4:]):
        assert np.max(np.abs(a - b)) < PARAM_TOL
    assert np.allclose(got[3], want[3], rtol=0, atol=PARAM_TOL)
    phase, A1, A0, abc, B1, B0 = got
    recon = (np.exp(1j * phase) * np.kron(A1, A0)
             @ TD._canonical_matrix(*abc) @ np.kron(B1, B0))
    assert np.max(np.abs(recon - u)) < UNITARY_TOL


def test_kak_degenerate_classes_match_jax():
    CNOT = np.eye(4, dtype=complex)[[0, 3, 2, 1]]
    SWAP = np.eye(4, dtype=complex)[[0, 2, 1, 3]]
    iSWAP = np.array([[1, 0, 0, 0], [0, 0, 1j, 0],
                      [0, 1j, 0, 0], [0, 0, 0, 1]], dtype=complex)
    for m in (np.eye(4, dtype=complex), CNOT, SWAP, iSWAP,
              np.diag([1.0, 1, 1, -1]).astype(complex)):
        c = _both("emit_unitary", m, (0, 1), n=2)
        assert np.max(np.abs(circuit_unitary(c) - m)) < UNITARY_TOL


@pytest.mark.parametrize("k", [3, 4])
def test_emit_unitary_k_matches_jax_and_reproduces(k):
    u = _haar(np.random.default_rng(7 * k), k)
    c = _both("emit_unitary_k", u, tuple(range(k)), n=k)
    assert np.max(np.abs(circuit_unitary(c) - u)) < UNITARY_TOL


@pytest.mark.parametrize("name", sorted(JD.COMPOSITE_GATES))
def test_composites_match_jax(name):
    arity, nparams = JD.COMPOSITE_GATES[name]
    params = tuple(0.3 + 0.4 * i for i in range(nparams))
    _both("emit_composite", name, tuple(range(arity)), params, n=3)


def test_state_prep_and_circuit_methods_match_jax():
    rng = np.random.default_rng(5)
    v = rng.standard_normal(16) + 1j * rng.standard_normal(16)
    _both("emit_state_prep", v, (3, 0, 2, 1), n=4)
    u = _haar(rng, 2)
    t = Circuit(4).initialize(v).unitary(u, 2, 0).pauli_rot(0.7, "X0 Y2 Z3")
    j = JCircuit(4).initialize(v).unitary(u, 2, 0).pauli_rot(0.7, "X0 Y2 Z3")
    assert_same_gates(t.gates, j.gates)
    prep = circuit_unitary(Circuit(4).initialize(v))[:, 0]
    assert np.max(np.abs(prep - v / np.linalg.norm(v))) < UNITARY_TOL


@pytest.mark.parametrize("call,match", [
    (lambda D: D.kak_decompose(np.ones((4, 4))), "unitary"),
    (lambda D: D.kak_decompose(np.eye(3)), "4x4"),
    (lambda D: D.emit_unitary_k(Circuit(3), np.ones((8, 8)), (0, 1, 2)),
     "unitary"),
    (lambda D: D.emit_unitary(Circuit(2), np.eye(4), (1, 1)), "distinct"),
    (lambda D: D.emit_state_prep(Circuit(2), np.zeros(4), (0, 1)), "zero"),
])
def test_rejections_match_jax(call, match):
    with pytest.raises(ValueError, match=match) as got:
        call(TD)
    with pytest.raises(ValueError, match=match) as want:
        call(JD)
    assert str(got.value) == str(want.value)
