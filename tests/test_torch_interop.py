"""The port's ``interop.py`` (a host copy) against the JAX package's, on
the CPU, through a duck-typed stand-in for qiskit's QuantumCircuit (qiskit
is an optional dependency, absent here and on the card machine): equal
circuits and dynamic items, the same errors (the measure error names each
package's own ``DynamicCircuit``)."""

import numpy as np
import pytest

from gpu_quantum_simulator_tpu import interop as JI

from gpu_quantum_simulator_tpu_torch import interop as TI
from gpu_quantum_simulator_tpu_torch.ref.cpu import simulate_reference


class _Op:
    def __init__(self, name, params=()):
        self.name = name
        self.params = list(params)


class _Bit:
    def __init__(self, index):
        self.index = index


class _Inst:
    def __init__(self, op, qubits, clbits=()):
        self.operation = op
        self.qubits = qubits
        self.clbits = clbits


class _FakeQC:
    """The qiskit >= 1.0 QuantumCircuit surface that from_qiskit reads."""

    def __init__(self, n, m=0):
        self.num_qubits = n
        self.num_clbits = m
        self.data = []
        self._bits = [_Bit(i) for i in range(n)]
        self._cbits = [_Bit(i) for i in range(m)]

    def find_bit(self, q):
        class _Loc:
            def __init__(self, index):
                self.index = index
        return _Loc(q.index)

    def add(self, name, *qubits, params=()):
        self.data.append(_Inst(_Op(name, params),
                               [self._bits[q] for q in qubits]))

    def add_measure(self, q, c):
        self.data.append(_Inst(_Op("measure"), [self._bits[q]],
                               [self._cbits[c]]))

    def add_reset(self, q):
        self.data.append(_Inst(_Op("reset"), [self._bits[q]]))

    def add_cond(self, name, q, clbit, value, params=()):
        op = _Op(name, params)
        op.condition = (self._cbits[clbit], value)
        self.data.append(_Inst(op, [self._bits[q]]))


def _gates(c):
    return [(g.name, g.qubits, tuple(g.params)) for g in c.gates]


def _items(dc):
    out = []
    for i in dc.items:
        kind = type(i).__name__
        if kind == "Gate":
            out.append((kind, i.name, i.qubits, tuple(i.params)))
        elif kind == "CondGate":
            out.append((kind, i.gate.name, i.gate.qubits, i.clbit, i.value))
        else:
            out.append((kind,) + tuple(vars(i).values()))
    return out


def _gate_zoo():
    qc = _FakeQC(4)
    for name, qs, ps in (
            ("h", (0,), ()), ("cx", (0, 1), ()), ("rz", (2,), (0.7,)),
            ("sx", (3,), ()), ("swap", (1, 2), ()), ("barrier", (0,), ()),
            ("u", (3,), (0.1, 0.2, 0.3)), ("ccx", (0, 1, 2), ()),
            ("crz", (3, 0), (0.4,)), ("rzz", (1, 3), (0.9,)),
            ("u3", (2,), (0.3, 0.2, 0.1)), ("u1", (1,), (0.5,)),
            ("cy", (2, 0), ()), ("delay", (1,), ()), ("id", (2,), ()),
            ("u2", (0,), (0.3, 0.6)), ("cswap", (0, 2, 3), ())):
        qc.add(name, *qs, params=ps)
    return qc


def test_from_qiskit_matches_jax():
    got = TI.from_qiskit(_gate_zoo())
    want = JI.from_qiskit(_gate_zoo())
    assert got.num_qubits == want.num_qubits == 4
    assert _gates(got) == _gates(want)
    assert simulate_reference(got).shape == (16,)


def test_unitary_instructions_match_jax():
    rng = np.random.default_rng(5)
    u2q, _ = np.linalg.qr(rng.standard_normal((4, 4))
                          + 1j * rng.standard_normal((4, 4)))
    u1q, _ = np.linalg.qr(rng.standard_normal((2, 2))
                          + 1j * rng.standard_normal((2, 2)))
    qc = _FakeQC(3)
    qc.add("h", 0)
    qc.add("unitary", 1, params=(u1q,))
    qc.add("unitary", 0, 1, params=(u2q,))
    ccx = np.eye(8, dtype=complex)
    ccx[[3, 7], :] = ccx[[7, 3], :]
    qc.add("unitary", 0, 1, 2, params=(ccx,))
    got, want = TI.from_qiskit(qc), JI.from_qiskit(qc)
    assert _gates(got) == _gates(want)
    qc7 = _FakeQC(7)
    qc7.add("unitary", *range(7), params=(np.eye(128, dtype=complex),))
    drops = ([], [])
    TI.from_qiskit(qc7, strict=False, dropped=drops[0])
    JI.from_qiskit(qc7, strict=False, dropped=drops[1])
    assert drops[0] == drops[1] == ["unitary"]


def _same_error(call, exc=ValueError):
    with pytest.raises(exc) as got:
        call(TI)
    with pytest.raises(exc) as want:
        call(JI)
    return str(got.value), str(want.value)


def test_errors_match_jax():
    def frob(I):
        qc = _FakeQC(2)
        qc.add("h", 0)
        qc.add("frobnicate", 1)
        I.from_qiskit(qc)

    a, b = _same_error(frob)
    assert a == b
    a, b = _same_error(lambda I: I.from_qiskit(object()), TypeError)
    assert a == b

    def measured(I):
        qc = _FakeQC(1, 1)
        qc.add_measure(0, 0)
        I.from_qiskit(qc)

    a, b = _same_error(measured)
    assert a == b.replace("gpu_quantum_simulator_tpu.",
                          "gpu_quantum_simulator_tpu_torch.")
    dropped = []
    qc = _FakeQC(2)
    qc.add("h", 0)
    qc.add("frobnicate", 1)
    assert len(TI.from_qiskit(qc, strict=False, dropped=dropped).gates) == 1
    assert dropped == ["frobnicate"]


def _teleport_qc():
    qc = _FakeQC(3, 2)
    qc.add("h", 1)
    qc.add("cx", 1, 2)
    qc.add("cx", 0, 1)
    qc.add("h", 0)
    qc.add_measure(0, 0)
    qc.add_measure(1, 1)
    qc.add_cond("x", 2, 1, 1)
    qc.add_cond("z", 2, 0, 1)
    qc.add_reset(0)
    return qc


def test_from_qiskit_dynamic_matches_jax():
    from gpu_quantum_simulator_tpu_torch.dynamic import DynamicCircuit

    got = TI.from_qiskit_dynamic(_teleport_qc())
    want = JI.from_qiskit_dynamic(_teleport_qc())
    assert isinstance(got, DynamicCircuit)
    assert (got.num_qubits, got.num_clbits) == (want.num_qubits,
                                                want.num_clbits)
    assert _items(got) == _items(want)
    assert got.to_qasm() == want.to_qasm()


def test_from_qiskit_dynamic_conditions_and_control_flow():
    class _Reg(list):
        pass

    def register(width):
        qc = _FakeQC(1, width)
        op = _Op("x")
        op.condition = (_Reg(qc._cbits), 1)
        qc.data.append(_Inst(op, [qc._bits[0]]))
        return qc

    assert _items(TI.from_qiskit_dynamic(register(1))) == \
        _items(JI.from_qiskit_dynamic(register(1)))
    a, b = _same_error(lambda I: I.from_qiskit_dynamic(register(2)))
    assert a == b

    def flow():
        qc = _FakeQC(1, 1)
        qc.data.append(_Inst(_Op("if_else"), [qc._bits[0]]))
        return qc

    a, b = _same_error(lambda I: I.from_qiskit_dynamic(flow()))
    assert a == b
    dropped = []
    dc = TI.from_qiskit_dynamic(flow(), strict=False, dropped=dropped)
    assert dropped == ["if_else"] and not dc.items
