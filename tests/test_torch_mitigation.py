"""The port's ``mitigation.py`` against the JAX package's, on the CPU.

``folded``, ``readout_confusion_1q``, ``mitigate_readout`` and
``mitigate_readout_expectation_z`` are host numpy copies: equal results,
equal errors.  ``zne_expectation`` runs the port's noisy ensembles (seeded
torch generators): its raw ladder is held to the DensitySimulator's exact
noisy values within 4 standard errors and to the JAX package's ladder
within 6, and the mitigated value beats the raw one as in the JAX test.
"""

import numpy as np
import pytest

from gpu_quantum_simulator_tpu import mitigation as JMit
from gpu_quantum_simulator_tpu import models as JM

import gpu_quantum_simulator_tpu_torch as T
from gpu_quantum_simulator_tpu_torch import mitigation as TMit
from gpu_quantum_simulator_tpu_torch import models as TM


def _ansatz(M, n=4, seed=2):
    rng = np.random.default_rng(seed)
    c = M.random_circuit(n, 0, seed=0)
    for q in range(n):
        c.ry(rng.uniform(-0.9, 0.9), q)
    for q in range(n - 1):
        c.cx(q, q + 1)
    for q in range(n):
        c.rz(rng.uniform(-0.9, 0.9), q)
    return c


def _gates(c):
    return [(g.name, g.qubits, g.params) for g in c.gates]


@pytest.mark.parametrize("scale", [1, 3, 5])
def test_folded_matches_jax(scale):
    got = TMit.folded(_ansatz(TM), scale)
    assert _gates(got) == _gates(JMit.folded(_ansatz(JM), scale))
    assert np.max(np.abs(T.circuit_unitary(got)
                         - T.circuit_unitary(_ansatz(TM)))) < 1e-10


def _same_error(call):
    with pytest.raises(ValueError) as got:
        call(TMit, TM)
    with pytest.raises(ValueError) as want:
        call(JMit, JM)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("call", [
    lambda Mi, M: Mi.folded(_ansatz(M), 2),
    lambda Mi, M: Mi.folded(_ansatz(M), -1),
    lambda Mi, M: Mi.zne_expectation(_ansatz(M), [(1.0, "Z0")], scales=(1,),
                                     order=1),
    lambda Mi, M: Mi.mitigate_readout([0], 21, 0.01),
    lambda Mi, M: Mi.mitigate_readout([0, 1], 1, 0.6),
    lambda Mi, M: Mi.mitigate_readout({}, 2, 0.01),
    lambda Mi, M: Mi.mitigate_readout_expectation_z(0.5, 2, 0.5),
])
def test_errors_match_jax(call):
    _same_error(call)


def test_mitigate_readout_matches_jax():
    rng = np.random.default_rng(0)
    samples = rng.integers(0, 8, size=5000)
    for p01, p10 in ((0.08, None), ([0.02, 0.05, 0.1], [0.04, 0.01, 0.07])):
        np.testing.assert_array_equal(
            TMit.mitigate_readout(samples, 3, p01, p10),
            JMit.mitigate_readout(samples, 3, p01, p10))
    cnt = {"101": 7, 3: 11, "000": 2}
    np.testing.assert_array_equal(TMit.mitigate_readout(cnt, 3, 0.05),
                                  JMit.mitigate_readout(cnt, 3, 0.05))
    np.testing.assert_array_equal(TMit.readout_confusion_1q(0.1, 0.2),
                                  JMit.readout_confusion_1q(0.1, 0.2))
    assert TMit.mitigate_readout_expectation_z(0.5, 2, 0.1) == \
        JMit.mitigate_readout_expectation_z(0.5, 2, 0.1)


def test_readout_mitigation_of_noisy_ghz_samples():
    n, p = 4, 0.08
    s = T.dynamic.sample_noisy(TM.ghz(n), 40000, readout_error=p, seed=3,
                               device="cpu")
    raw = np.bincount(s, minlength=1 << n) / len(s)
    mit = T.mitigate_readout(s, n, p)
    ideal = np.zeros(1 << n)
    ideal[0] = ideal[-1] = 0.5
    assert np.max(np.abs(mit - ideal)) < 0.01
    assert np.max(np.abs(mit - ideal)) < 0.3 * np.max(np.abs(raw - ideal))
    from gpu_quantum_simulator_tpu_torch.sampling import counts

    np.testing.assert_allclose(T.mitigate_readout(counts(s, n), n, p), mit,
                               atol=1e-12)


def test_zne_ladder_matches_density_and_jax():
    from gpu_quantum_simulator_tpu_torch import density as TD
    from gpu_quantum_simulator_tpu_torch import dynamic as TY

    n, shots, p1 = 4, 4096, 0.02
    terms = [(-1.0, f"Z{i} Z{i + 1}") for i in range(n - 1)]
    terms += [(-0.6, f"X{i}") for i in range(n)]
    exact = T.expectation_pauli_sum(_ansatz(TM), terms, device="cpu")
    got, scales, raw = TMit.zne_expectation(
        _ansatz(TM), terms, shots=shots, p1=p1, seed=5, scales=(1, 3, 5),
        return_fits=True, device="cpu")
    _, _, jraw = JMit.zne_expectation(
        _ansatz(JM), terms, shots=shots, p1=p1, seed=5, scales=(1, 3, 5),
        return_fits=True)
    assert scales == [1, 3, 5]
    sum_c = sum(abs(c) for c, _ in terms)
    for c, value, jvalue in zip(scales, raw, jraw):
        # the exact noisy value: the folded circuit's density matrix
        nc = TD.NoisyCircuit(n)
        for item in TY.with_noise(TMit.folded(_ansatz(TM), c), p1=p1).items:
            if isinstance(item, TY.Noise):
                nc.channel("depolarizing", item.qubit, p=item.p)
            else:
                nc.items.append(item)
        rho = TD.DensitySimulator(device="cpu").run(nc).matrix()
        want = sum(coeff * float(np.real(np.trace(rho @ _pauli(spec, n))))
                   for coeff, spec in terms)
        s = sum_c / np.sqrt(shots)         # each term's error <= |c|/sqrt(N)
        assert abs(value - want) < 4 * s, (c, value, want)
        assert abs(value - jvalue) < 6 * np.sqrt(2) * s, (c, value, jvalue)
    assert abs(raw[2] - exact) > abs(raw[0] - exact)
    assert abs(got - exact) < abs(raw[0] - exact)


def _pauli(spec, n):
    P = {"X": np.array([[0, 1], [1, 0]], complex),
         "Z": np.diag([1.0, -1.0]).astype(complex)}
    ops = {int(t[1:]): t[0] for t in spec.split()}
    full = np.eye(1)
    for q in reversed(range(n)):
        full = np.kron(full, P[ops[q]] if q in ops else np.eye(2))
    return full


def test_cuda_request_without_a_card_raises(monkeypatch):
    import torch

    from gpu_quantum_simulator_tpu_torch import dynamic as TY

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c = _ansatz(TM)
    for call in (lambda: TMit.zne_expectation(c, [(1.0, "Z0")], shots=8),
                 lambda: TY.expectation_noisy(c, [(1.0, "Z0")], shots=8),
                 lambda: TY.sample_noisy(c, 8, p1=0.1)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
