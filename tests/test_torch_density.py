"""The port's ``density.py`` against the JAX package's, on the CPU.

The same noisy circuits go through each package's ``DensitySimulator``
at n <= 5, so every route runs: the megakernel arm (2n <= 7), the wide
engine (2n = 8), the prefetch engine (2n >= 9) flat and in place.  Bars:
probabilities, purities and matrices at 1e-6 (float32 engines, sums in
another order); the complex128 route at 1e-12 against dense float64
superoperator algebra on the host (the JAX package runs it in float32
when x64 is off, as in these tests); channels, superoperators and the
doubled op lists exactly; the validation errors word for word.
"""

import numpy as np
import pytest

from gpu_quantum_simulator_tpu import density as JD
from gpu_quantum_simulator_tpu import models as JM
from gpu_quantum_simulator_tpu.config import SimulatorConfig as JConfig

import gpu_quantum_simulator_tpu_torch as T
from gpu_quantum_simulator_tpu_torch import density as TD
from gpu_quantum_simulator_tpu_torch import models as TM
from gpu_quantum_simulator_tpu_torch.config import SimulatorConfig as TConfig
from gpu_quantum_simulator_tpu_torch.ir.oplist import (circuit_to_ops,
                                                       expand_unitary,
                                                       op_matrix)

TOL = 1e-6
F64_TOL = 1e-12


def _noisy(D, M, n, seed=3, gates=40):
    pure = M.grover_like(n, num_gates=gates, seed=seed) if n >= 2 else None
    nc = D.NoisyCircuit(n, items=list(pure.gates) if pure else [])
    nc.sx(0)
    nc.channel("depolarizing", n - 1, p=0.3)
    nc.channel("amplitude_damping", 0, gamma=0.2)
    if n >= 2:
        nc.channel("depolarizing2", 1, 0, p=0.25)     # unsorted pair
    nc.h(0).rz(0.4, n - 1)
    nc.channel("thermal", 0, t1=10.0, t2=8.0, time=3.0)
    return nc


def _pair(n, **kw):
    return _noisy(JD, JM, n, **kw), _noisy(TD, TM, n, **kw)


def _dense(nc) -> np.ndarray:
    """rho by direct float64 algebra on the host."""
    n = nc.num_qubits
    rho = np.zeros((1 << n, 1 << n), dtype=complex)
    rho[0, 0] = 1.0
    full = tuple(range(n))
    for item in nc.items:
        if isinstance(item, TD.Channel):
            acc = np.zeros_like(rho)
            for k in item.kraus:
                big = expand_unitary(k, item.qubits, full)
                acc += big @ rho @ big.conj().T
            rho = acc
            continue
        for op in circuit_to_ops(T.Circuit(n, [item])):
            u, qs = op_matrix(op)
            big = expand_unitary(u, qs, full)
            rho = big @ rho @ big.conj().T
    return rho


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_probabilities_purity_matrix_match_jax(n):
    jnc, tnc = _pair(n)
    want = JD.DensitySimulator().run(jnc)
    got = TD.DensitySimulator(device="cpu").run(tnc)
    assert got.halves is None
    np.testing.assert_allclose(got.probabilities(), want.probabilities(),
                               atol=TOL)
    assert abs(got.purity() - want.purity()) < TOL
    np.testing.assert_allclose(got.matrix(), want.matrix(), atol=TOL)
    assert abs(got.expectation_z([0]) - want.expectation_z([0])) < TOL
    assert abs(got.probabilities().sum() - 1.0) < 1e-5


def test_inplace_halves_route_matches_jax_and_flat():
    jnc, tnc = _pair(5)
    cfg = dict(prefetch_inplace=True)
    want = JD.DensitySimulator(JConfig(**cfg)).run(jnc)
    got = TD.DensitySimulator(TConfig(**cfg), device="cpu").run(tnc)
    flat = TD.DensitySimulator(TConfig(prefetch_inplace=False),
                               device="cpu").run(tnc)
    assert got.halves is not None and got.re is None
    for other in (want, flat):
        np.testing.assert_allclose(got.probabilities(), other.probabilities(),
                                   atol=TOL)
        assert abs(got.purity() - other.purity()) < TOL
        np.testing.assert_allclose(got.matrix(), other.matrix(), atol=TOL)


@pytest.mark.parametrize("n", [1, 3, 5])
def test_complex128_route_is_exact(n):
    _, tnc = _pair(n)
    got = TD.DensitySimulator(TConfig(dtype="complex128"),
                              device="cpu").run(tnc)
    assert got.re.dtype.is_floating_point and got.re.element_size() == 8
    rho = _dense(tnc)
    np.testing.assert_allclose(got.matrix(), rho, atol=F64_TOL)
    np.testing.assert_allclose(got.probabilities(), np.diag(rho).real,
                               atol=F64_TOL)


def test_samples_match_jax():
    jnc, tnc = _pair(3)
    want = JD.DensitySimulator().run(jnc).sample(500, seed=4)
    got = TD.DensitySimulator(device="cpu").run(tnc).sample(500, seed=4)
    np.testing.assert_array_equal(got, want)


def test_channels_and_doubled_ops_match_jax():
    for name, kw in (("depolarizing", {"p": 0.3}), ("dephasing", {"p": 0.6}),
                     ("bit_flip", {"p": 0.2}),
                     ("amplitude_damping", {"gamma": 0.45}),
                     ("depolarizing2", {"p": 0.5}),
                     ("thermal", {"t1": 10.0, "t2": 12.0, "time": 4.0})):
        want = JD.NAMED_CHANNELS[name](**kw)
        got = TD.NAMED_CHANNELS[name](**kw)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(TD.superoperator(got),
                                      JD.superoperator(want))
    jnc, tnc = _pair(3)
    jops = JD.DensitySimulator()._doubled_ops(jnc)
    tops = TD.DensitySimulator(device="cpu")._doubled_ops(tnc)
    assert [(o.kind, o.qubits) for o in tops] == \
        [(o.kind, o.qubits) for o in jops]
    for a, b in zip(tops, jops):
        np.testing.assert_array_equal(a.u, b.u)


def _same_error(call):
    with pytest.raises(ValueError) as got:
        call(TD, {"device": "cpu"})
    with pytest.raises(ValueError) as want:
        call(JD, {})
    assert str(got.value) == str(want.value)


def test_validation_errors_match_jax():
    _same_error(lambda D, kw: D.DensitySimulator(**kw).run(
        D.NoisyCircuit(16)))
    _same_error(lambda D, kw: D.DensitySimulator(
        (TConfig if D is TD else JConfig)(dtype="complex128"), **kw).run(
        D.NoisyCircuit(15)))
    _same_error(lambda D, kw: D.NoisyCircuit(1).channel([np.eye(2) * 0.5],
                                                       0))
    _same_error(lambda D, kw: D.NoisyCircuit(2).channel("depolarizing", 0, 1,
                                                       p=0.1))
    _same_error(lambda D, kw: D.NoisyCircuit(1).append("h", 3))
    _same_error(lambda D, kw: D.kraus_thermal(1.0, 2.5, 0.1))


def test_cuda_request_without_a_card_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        TD.DensitySimulator()
