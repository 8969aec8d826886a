"""The port's ``run_dynamic`` (per-shot trajectories) against the JAX
package's, on the CPU.

Both packages draw each trajectory's uniforms from the same
``np.random.default_rng(seed)`` in the same order, so the classical bits
must be EQUAL shot for shot and the final states agree within 2e-5
(float32 engines, 1e-5 where a state is a basis state).  The circuit model
(items, helpers, QASM text, validation errors) is the JAX package's, held
exactly.
"""

import numpy as np
import pytest

from gpu_quantum_simulator_tpu import dynamic as JY
from gpu_quantum_simulator_tpu import models as JM
from gpu_quantum_simulator_tpu.config import SimulatorConfig as JConfig

import torch

import gpu_quantum_simulator_tpu_torch as T
from gpu_quantum_simulator_tpu_torch import dynamic as TY
from gpu_quantum_simulator_tpu_torch import models as TM
from gpu_quantum_simulator_tpu_torch.config import SimulatorConfig as TConfig

STATE_TOL = 2e-5


def _teleport(Y):
    theta, phi = 1.234, 0.567
    dc = Y.DynamicCircuit(3, num_clbits=2)
    dc.rz(theta, 0)
    dc.sx(0)
    dc.rz(phi, 0)
    dc.h(1).cx(1, 2)
    dc.cx(0, 1).h(0)
    dc.measure(0, 0)
    dc.measure(1, 1)
    dc.c_if(1, "x", 2)
    dc.c_if(0, "z", 2)
    return dc


def _mixed(Y, n=9):
    """Gates, measurements, reset, conditions, every noise kind and a
    Kraus event, on 9 qubits (the engines' widths)."""
    from gpu_quantum_simulator_tpu import density as JD

    dc = Y.DynamicCircuit(n, num_clbits=3)
    rng = np.random.default_rng(0)
    for _ in range(30):
        q = int(rng.integers(n))
        dc.rz(float(rng.uniform(0, 6.28)), q)
        dc.sx(q)
    dc.cx(0, 5)
    dc.measure(4, 0)
    dc.noise("depolarizing", 2, 0.4)
    dc.noise("amplitude_damping", 8, 0.5)
    dc.noise("depolarizing2", 1, 0.6, qubit2=7)
    dc.noise("dephasing", 3, 0.5)
    dc.noise("bit_flip", 6, 0.3)
    dc.noise_kraus(JD.kraus_thermal(10.0, 12.0, 4.0), 0)
    dc.reset(5)
    dc.c_if(0, "x", 2)
    dc.h(0)
    dc.measure(2, 1)
    dc.measure(0, 2)
    return dc


def _run_both(build, strategy=None, **kw):
    jcfg = JConfig(strategy=strategy) if strategy else None
    tcfg = TConfig(strategy=strategy) if strategy else None
    want = JY.run_dynamic(build(JY), jcfg, **kw)
    got = TY.run_dynamic(build(TY), tcfg, device="cpu", **kw)
    return got, want


@pytest.mark.parametrize("build,shots,seed", [
    (_teleport, 12, 7), (_mixed, 6, 5), (_mixed, 6, 11)])
@pytest.mark.parametrize("strategy", ["mxu", "prefetch"])
def test_trajectories_match_jax(build, shots, seed, strategy):
    got, want = _run_both(build, strategy, shots=shots, seed=seed,
                          return_states=True)
    assert [r.clbits for r in got] == [r.clbits for r in want]
    for a, b in zip(got, want):
        assert a.state.dtype == np.complex64
        np.testing.assert_allclose(a.state, b.state, atol=STATE_TOL)


def test_bell_correlation_and_collapse_match_jax():
    def bell(Y):
        dc = Y.DynamicCircuit(2, num_clbits=2)
        dc.h(0).cx(0, 1)
        dc.measure(0, 0)
        dc.measure(1, 1)
        return dc

    got, want = _run_both(bell, shots=40, seed=3, return_states=True)
    assert [r.clbits for r in got] == [r.clbits for r in want]
    assert all(a == b for a, b in (r.clbits for r in got))
    for r in got:
        idx = 3 * r.clbits[0]
        assert abs(abs(r.state[idx]) - 1.0) < 1e-5


def test_reset_and_value_zero_condition_match_jax():
    def prog(Y):
        dc = Y.DynamicCircuit(1, num_clbits=1)
        dc.x(0)
        dc.reset(0)
        dc.measure(0, 0)                    # |0> -> outcome always 0
        dc.c_if(0, "x", 0, value=0)         # fires on 0
        return dc

    got, want = _run_both(prog, shots=3, seed=0, return_states=True)
    for a, b in zip(got, want):
        assert a.clbits == b.clbits == (0,)
        assert abs(abs(a.state[1]) - 1.0) < 1e-5


def test_teleported_state_is_the_message():
    msg = T.Circuit(1)
    msg.rz(1.234, 0)
    msg.sx(0)
    msg.rz(0.567, 0)
    want = T.Simulator(TConfig(strategy="reference"), device="cpu").run(msg)
    for r in TY.run_dynamic(_teleport(TY), shots=6, seed=7,
                            return_states=True, device="cpu"):
        m0, m1 = r.clbits
        base = m0 | (m1 << 1)
        got = np.array([r.state[base], r.state[base | 4]])
        k = np.argmax(np.abs(want))
        got = got * (want[k] / got[k]) * (abs(got[k]) / abs(want[k]))
        assert np.max(np.abs(got - want)) < 1e-5


def test_split_segments_match_jax():
    jd, td = _mixed(JY), _mixed(TY)
    jseg, tseg = JY._split_segments(jd, 11), TY._split_segments(td, 11)
    assert [k for k, _ in tseg] == [k for k, _ in jseg]
    for (k, a), (_, b) in zip(tseg, jseg):
        if k == "circuit":
            assert a.num_qubits == b.num_qubits == 11
            assert [(g.name, g.qubits, g.params) for g in a.gates] == \
                [(g.name, g.qubits, g.params) for g in b.gates]
        else:
            assert type(a).__name__ == type(b).__name__


def test_to_qasm_and_gate_helpers_match_jax():
    def prog(Y):
        dc = Y.DynamicCircuit(2, 1)
        dc.rx(0.3, 0).ry(0.2, 1).y(0).p(0.1, 1).u(0.1, 0.2, 0.3, 0)
        dc.sxdg(1).id(0)
        dc.measure(1, 0).reset(0).c_if(0, "rz", 1, params=(0.25,))
        return dc

    assert prog(TY).to_qasm() == prog(JY).to_qasm()
    assert [type(i).__name__ for i in prog(TY).items] == \
        [type(i).__name__ for i in prog(JY).items]


def _same_error(call):
    with pytest.raises(ValueError) as got:
        call(TY)
    with pytest.raises(ValueError) as want:
        call(JY)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("call", [
    lambda Y: Y.DynamicCircuit(2).noise("thermal", 0, 0.1),
    lambda Y: Y.DynamicCircuit(2).noise("dephasing", 0, 1.5),
    lambda Y: Y.DynamicCircuit(2).noise("dephasing", 5, 0.1),
    lambda Y: Y.DynamicCircuit(3).noise("depolarizing2", 0, 0.1),
    lambda Y: Y.DynamicCircuit(3).noise("depolarizing", 0, 0.1, qubit2=1),
    lambda Y: Y.DynamicCircuit(3).noise("depolarizing2", 1, 0.1, qubit2=1),
    lambda Y: Y.DynamicCircuit(3).noise("depolarizing2", 0, 0.1, qubit2=7),
    lambda Y: Y.DynamicCircuit(2).noise_kraus([np.eye(2) * 2], 0),
    lambda Y: Y.DynamicCircuit(2).noise_kraus([np.eye(4)], 0),
    lambda Y: Y.DynamicCircuit(2).noise_kraus([np.eye(2)], 0, 0),
    lambda Y: Y.DynamicCircuit(2).noise_kraus([np.eye(2)], 5),
    lambda Y: Y.DynamicCircuit(2).noise_kraus([np.eye(2)], 1).to_qasm(),
    lambda Y: Y.DynamicCircuit(2).measure(0, 0),
    lambda Y: Y.DynamicCircuit(2, 1).c_if(0, "x", 4),
    lambda Y: Y.DynamicCircuit(2).thermal(0, 1.0, 2.5, 0.1),
])
def test_validation_errors_match_jax(call):
    _same_error(call)


def test_complex128_and_missing_card_raise():
    """complex128 runs now, as in the JAX package: float64 trajectories
    (the default config's mxu at n = 9 and the megakernel arm below), the
    JAX package's classical bits for a seed and its complex128 states
    within 1e-12; the batched ensemble is float64 and normalised too.  (A
    missing card still raises: test_cuda_request_without_a_card_raises.)"""
    got = TY.run_dynamic(_mixed(TY), TConfig(dtype="complex128"), shots=2,
                         seed=5, return_states=True, device="cpu")
    want = JY.run_dynamic(_mixed(JY), JConfig(dtype="complex128"), shots=2,
                          seed=5, return_states=True)
    for a, b in zip(got, want):
        assert a.clbits == b.clbits and a.state.dtype == np.complex128
        assert np.max(np.abs(a.state - np.asarray(b.state))) <= 1e-12
    batch = TY.run_dynamic_batched(_teleport(TY), TConfig(dtype="complex128"),
                                   shots=4, return_states=True, device="cpu")
    assert len(batch) == 4
    for r in batch:
        assert r.state.dtype == np.complex128
        assert abs(np.linalg.norm(r.state) - 1.0) <= 1e-12


def test_cuda_request_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (TY.run_dynamic, TY.run_dynamic_batched):
        with pytest.raises(RuntimeError, match="cuda"):
            fn(_teleport(TY))
