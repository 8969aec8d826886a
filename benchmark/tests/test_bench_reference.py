"""The plain reference and the frozen circuit family."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from bench_support import ROOT

HERE = os.path.join(ROOT, "benchmark")


def _module(*parts):
    path = os.path.join(HERE, *parts)
    spec = importlib.util.spec_from_file_location(
        "t_" + parts[-1][:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _module("references", "statevector.py")
FAMILY = _module("families", "grover_like.py")


def _dense(gates, n):
    """The circuit's unitary applied to |0>, built from Kronecker products
    of each gate's full 2^n x 2^n matrix."""
    eye = np.eye(2)
    psi = np.zeros(1 << n, complex)
    psi[0] = 1
    for name, qubits, params in gates:
        if name == "cx":
            c, t = qubits
            full = np.zeros((1 << n, 1 << n))
            for i in range(1 << n):
                j = i ^ (1 << t) if (i >> c) & 1 else i
                full[j, i] = 1
        else:
            full = np.array([[1.0]])
            u = np.array(REF.matrix(name, params), complex)
            for q in reversed(range(n)):   # bit q of the index: qubit q
                full = np.kron(full, u if q == qubits[0] else eye)
        psi = full @ psi
    return psi


@pytest.mark.parametrize("n", [2, 3, 5, 8])
def test_reference_matches_the_dense_build(n):
    rng = np.random.default_rng(n)
    names = ["cx", "x", "sx", "z", "s", "sdg", "t", "tdg", "rz", "h", "id"]
    gates = []
    for _ in range(60):
        name = names[rng.integers(len(names))]
        if name == "cx":
            a, b = rng.choice(n, 2, replace=False)
            gates.append(("cx", (int(a), int(b)), ()))
        else:
            params = (float(rng.uniform(-6, 6)),) if name == "rz" else ()
            gates.append((name, (int(rng.integers(n)),), params))
    want = _dense(gates, n)
    # a block of 4 amplitudes makes every gate run in many blocks
    for block in (4, REF.BLOCK):
        got = REF.simulate(gates, n, block=block).numpy()
        np.testing.assert_allclose(got, want, atol=1e-13)


def test_reference_rejects_gates_outside_its_set():
    with pytest.raises(ValueError):
        REF.simulate([("ry", (0,), (0.3,))], 2)


def test_family_is_the_ports_generator_gate_for_gate():
    from gpu_quantum_simulator_tpu_torch import models

    for n, g, seed in ((6, 2445, 318), (28, 300, 2**31 + 11)):
        want = [(x.name, tuple(x.qubits), tuple(x.params))
                for x in models.grover_like(n, g, seed).gates]
        assert FAMILY.grover_like(n, g, seed) == want


def _config(n, count, structure):
    return {"num_qubits": n, "num_gates": count, "structure_seed": structure}


def test_seed_draws_angles_and_keeps_the_structure():
    a = FAMILY.gates(_config(12, 400, 318), [7, 0])
    b = FAMILY.gates(_config(12, 400, 318), [8, 0])
    base = FAMILY.grover_like(12, 400, 318)
    assert [(x[0], x[1]) for x in a] == [(x[0], x[1]) for x in base]
    assert [(x[0], x[1]) for x in b] == [(x[0], x[1]) for x in base]
    ra = [x[2] for x in a if x[0] == "rz"]
    assert ra != [x[2] for x in b if x[0] == "rz"]
    assert a == FAMILY.gates(_config(12, 400, 318), [7, 0])
    assert all(-2 * np.pi <= t[0] < 2 * np.pi for t in ra)


def test_a_null_structure_seed_draws_a_structure_a_request():
    """``structure_seed`` null: the whole circuit is drawn from the run's
    seed and the request's tags, as ``grover_like`` draws it."""
    big = 2**31 + 11
    a = FAMILY.gates(_config(12, 400, None), [big, 1, 0])
    b = FAMILY.gates(_config(12, 400, None), [big, 1, 1])
    assert a == FAMILY.grover_like(12, 400, [big, 1, 0])
    assert [(x[0], x[1]) for x in a] != [(x[0], x[1]) for x in b]
    assert a == FAMILY.gates(_config(12, 400, None), [big, 1, 0])


def test_reference_agrees_with_the_ports_f64_engine():
    """A second witness: the port's host reference strategy (numpy
    complex128) on the same gate list."""
    from gpu_quantum_simulator_tpu_torch import Simulator, SimulatorConfig
    from benchmark.harness import to_circuit

    gates = FAMILY.gates(_config(10, 2445, 318), [3, 0])
    got = REF.simulate(gates, 10).numpy()
    want = Simulator(SimulatorConfig(strategy="reference"),
                     device="cpu").run(to_circuit(gates, 10))
    np.testing.assert_allclose(got, want, atol=1e-12)
    assert abs(np.vdot(got, got) - 1) < 1e-12
    assert got.dtype == np.complex128
    assert torch.is_tensor(REF.simulate(gates[:3], 10))
