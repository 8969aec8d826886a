"""The port's ``mps.py`` (a host numpy copy) against the JAX package's,
on the CPU: the same circuits give the same amplitudes (1e-10), samples,
entropies, Pauli expectations and truncation records, and the same
errors."""

import numpy as np
import pytest

from gpu_quantum_simulator_tpu import mps as JP
from gpu_quantum_simulator_tpu import models as JM

from gpu_quantum_simulator_tpu_torch import models as TM
from gpu_quantum_simulator_tpu_torch import mps as TP
from gpu_quantum_simulator_tpu_torch.ref.cpu import simulate_reference

TOL = 1e-10


@pytest.mark.parametrize("trial", range(4))
def test_random_circuits_match_jax_and_the_reference(trial):
    rng = np.random.default_rng(trial)
    n = int(rng.integers(3, 9))
    g = int(rng.integers(20, 120))
    got = TP.run_mps(TM.random_circuit(n, g, seed=trial), max_bond=256)
    want = JP.run_mps(JM.random_circuit(n, g, seed=trial), max_bond=256)
    np.testing.assert_allclose(got.to_statevector(), want.to_statevector(),
                               atol=TOL)
    np.testing.assert_allclose(
        got.to_statevector(),
        simulate_reference(TM.random_circuit(n, g, seed=trial)), atol=TOL)


def test_truncated_qv_matches_jax():
    got = TP.run_mps(TM.quantum_volume(8, depth=4, seed=0), max_bond=4)
    want = JP.run_mps(JM.quantum_volume(8, depth=4, seed=0), max_bond=4)
    assert abs(got.truncation_error - want.truncation_error) < TOL
    assert abs(got.norm() - want.norm()) < TOL
    assert got.max_bond_dim() == want.max_bond_dim()
    np.testing.assert_allclose(got.to_statevector(), want.to_statevector(),
                               atol=TOL)


def test_ghz_100_outputs_match_jax():
    got = TP.run_mps(TM.ghz(100), max_bond=4)
    want = JP.run_mps(JM.ghz(100), max_bond=4)
    for idx in (0, (1 << 100) - 1, 12345):
        assert abs(got.amplitude(idx) - want.amplitude(idx)) < TOL
    assert abs(got.entanglement_entropy(50)
               - want.entanglement_entropy(50)) < TOL
    assert abs(got.expectation_pauli("Z0 Z99")
               - want.expectation_pauli("Z0 Z99")) < TOL
    assert list(got.sample(60, seed=1)) == list(want.sample(60, seed=1))


def test_pauli_expectations_match_jax():
    got = TP.run_mps(TM.random_circuit(8, 80, seed=5), max_bond=256)
    want = JP.run_mps(JM.random_circuit(8, 80, seed=5), max_bond=256)
    for p in ("X0 Z3 Y6", "Z1", "Y2 Y7", "IIIIXXXX"):
        assert abs(got.expectation_pauli(p) - want.expectation_pauli(p)) < TOL


@pytest.mark.parametrize("call", [
    lambda P, M: P.run_mps(M.ghz(24), max_bond=4).to_statevector(),
    lambda P, M: P.run_mps(M.ghz(4)).entanglement_entropy(0),
    lambda P, M: P.MPS(3, max_bond=0),
    lambda P, M: P.MPS(0),
])
def test_errors_match_jax(call):
    with pytest.raises(ValueError) as got:
        call(TP, TM)
    with pytest.raises(ValueError) as want:
        call(JP, JM)
    assert str(got.value) == str(want.value)
