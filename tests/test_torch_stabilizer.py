"""The port's CHP stabilizer engine (``ref/stabilizer.py``, a host numpy
copy) against the JAX package's, on the CPU: equal tableaux, equal
predictions and samples, the same errors; and the port's own samplers
checked against the tableau's exact constraints."""

import numpy as np
import pytest

from gpu_quantum_simulator_tpu.ref import stabilizer as JS
from gpu_quantum_simulator_tpu import models as JM

from gpu_quantum_simulator_tpu_torch import models as TM
from gpu_quantum_simulator_tpu_torch.config import SimulatorConfig
from gpu_quantum_simulator_tpu_torch.engine.simulator import Simulator
from gpu_quantum_simulator_tpu_torch.ref import stabilizer as TS


def _tableau(st):
    return st.x.copy(), st.z.copy(), st.r.copy()


@pytest.mark.parametrize("trial", range(6))
def test_tableaux_and_predictions_match_jax(trial):
    rng = np.random.default_rng(trial)
    n = int(rng.integers(2, 9))
    g = int(rng.integers(10, 80))
    tc = TS.random_clifford_circuit(n, g, seed=trial)
    jc = JS.random_clifford_circuit(n, g, seed=trial)
    assert [(x.name, x.qubits, x.params) for x in tc.gates] == \
        [(x.name, x.qubits, x.params) for x in jc.gates]
    got, want = TS.StabilizerState.from_circuit(tc), \
        JS.StabilizerState.from_circuit(jc)
    for a, b in zip(_tableau(got), _tableau(want)):
        np.testing.assert_array_equal(a, b)
    assert got.z_parity_constraints() == want.z_parity_constraints()
    for k in range(1, n + 1):
        qs = list(range(k))
        assert got.expectation_z(qs) == want.expectation_z(qs)
    np.testing.assert_array_equal(got.sample(200, seed=trial),
                                  want.sample(200, seed=trial))


def test_clifford_gate_set_and_rejection_match_jax():
    def build(M):
        c = M.random_circuit(2, 0, seed=0)
        c.h(0).s(0).sdg(1).x(0).y(1).z(0).sx(0).sxdg(1).cx(0, 1)
        c.rz(np.pi / 2, 0)
        c.append("p", 1, params=(-np.pi,))
        return c

    tc, jc = build(TM), build(JM)
    assert TS.is_clifford_circuit(tc) and JS.is_clifford_circuit(jc)
    for a, b in zip(_tableau(TS.StabilizerState.from_circuit(tc)),
                    _tableau(JS.StabilizerState.from_circuit(jc))):
        np.testing.assert_array_equal(a, b)
    tc.rz(0.3, 0)
    jc.rz(0.3, 0)
    assert not TS.is_clifford_circuit(tc)
    with pytest.raises(ValueError) as got:
        TS.StabilizerState.from_circuit(tc)
    with pytest.raises(ValueError) as want:
        JS.StabilizerState.from_circuit(jc)
    assert str(got.value) == str(want.value)


def test_ghz_predictions():
    n = 6
    st = TS.StabilizerState.from_circuit(TM.ghz(n))
    assert st.expectation_z([0]) == 0 and st.expectation_z([0, 3]) == 1
    cons = st.z_parity_constraints()
    assert len(cons) == n - 1 and all(p == 0 for _, p in cons)


@pytest.mark.parametrize("strategy", ["mxu", "prefetch"])
def test_port_sampler_obeys_the_tableau(strategy):
    c = TS.random_clifford_circuit(9, 120, seed=7)
    st = TS.StabilizerState.from_circuit(c)
    s = Simulator(SimulatorConfig(strategy=strategy), device="cpu").sample(
        c, 3000, seed=2)
    for mask, parity in st.z_parity_constraints():
        pc = np.array([bin(int(v) & mask).count("1") % 2 for v in s])
        assert np.all(pc == parity)
    for q in range(9):
        ez = st.expectation_z([q])
        p1 = float(np.mean((s >> q) & 1))
        assert abs(p1 - (1 - ez) / 2) < 0.04, (q, ez, p1)
