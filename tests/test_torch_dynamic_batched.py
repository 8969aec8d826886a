"""The port's batched trajectory ensembles (``run_dynamic_batched``)
against the JAX package's, on the CPU.

The port draws the ensemble's uniforms from a seeded ``torch.Generator``
and the JAX package from ``jax.random``, so the two agree in
distribution, not shot for shot.  Physics holds exactly in every shot
(correlations, collapse, reset, teleportation, the state of each shot
block); frequencies are held to the exact answer within 4 standard errors
and to the JAX package's estimate at the same shot count within 6 (the
standard error of the difference), at fixed seeds.
"""

import numpy as np
import pytest
import torch

from gpu_quantum_simulator_tpu import dynamic as JY
from gpu_quantum_simulator_tpu.config import SimulatorConfig as JConfig

import gpu_quantum_simulator_tpu_torch as T
from gpu_quantum_simulator_tpu_torch import dynamic as TY
from gpu_quantum_simulator_tpu_torch.config import SimulatorConfig as TConfig


def _sigma(p, shots):
    return np.sqrt(max(p * (1 - p), 1.0 / shots) / shots)


def _check_frequency(got, want_exact, jax_est, shots):
    s = _sigma(want_exact, shots)
    assert abs(got - want_exact) < 4 * s, (got, want_exact, s)
    assert abs(got - jax_est) < 6 * np.sqrt(2) * s, (got, jax_est, s)


def _bell(Y):
    dc = Y.DynamicCircuit(2, num_clbits=2)
    dc.h(0).cx(0, 1)
    dc.measure(0, 0)
    dc.measure(1, 1)
    return dc


def test_bell_correlation_batched():
    shots = 256
    got = TY.run_dynamic_batched(_bell(TY), shots=shots, seed=3,
                                 device="cpu")
    want = JY.run_dynamic_batched(_bell(JY), shots=shots, seed=3)
    assert len(got) == shots
    assert all(a == b for a, b in (r.clbits for r in got))
    _check_frequency(np.mean([r.clbits[0] for r in got]), 0.5,
                     np.mean([r.clbits[0] for r in want]), shots)


def test_collapse_and_reset_batched_states():
    dc = TY.DynamicCircuit(2, num_clbits=1)
    dc.h(0).cx(0, 1)
    dc.measure(1, 0)
    dc.reset(0)                      # entangled, then wipe qubit 0
    for r in TY.run_dynamic_batched(dc, shots=32, seed=1,
                                    return_states=True, device="cpu"):
        p = np.abs(r.state) ** 2
        assert abs(p.sum() - 1.0) < 1e-5
        assert abs(p[2 * r.clbits[0]] - 1.0) < 1e-5


def test_teleportation_batched():
    msg = T.Circuit(1)
    msg.rz(1.234, 0)
    msg.sx(0)
    msg.rz(0.567, 0)
    want = T.Simulator(TConfig(strategy="reference"), device="cpu").run(msg)
    dc = TY.DynamicCircuit(3, num_clbits=2)
    dc.rz(1.234, 0)
    dc.sx(0)
    dc.rz(0.567, 0)
    dc.h(1).cx(1, 2)
    dc.cx(0, 1).h(0)
    dc.measure(0, 0)
    dc.measure(1, 1)
    dc.c_if(1, "x", 2)
    dc.c_if(0, "z", 2)
    seen = set()
    for r in TY.run_dynamic_batched(dc, shots=32, seed=7,
                                    return_states=True, device="cpu"):
        m0, m1 = r.clbits
        seen.add((m0, m1))
        base = m0 | (m1 << 1)
        got = np.array([r.state[base], r.state[base | 4]])
        k = np.argmax(np.abs(want))
        got = got * (want[k] / got[k]) * (abs(got[k]) / abs(want[k]))
        assert np.max(np.abs(got - want)) < 1e-5
    assert len(seen) >= 3


def test_conditional_value_zero_batched():
    dc = TY.DynamicCircuit(1, num_clbits=1)
    dc.measure(0, 0)
    dc.c_if(0, "x", 0, value=0)
    for t in TY.run_dynamic_batched(dc, shots=4, seed=0,
                                    return_states=True, device="cpu"):
        assert t.clbits == (0,)
        assert abs(abs(t.state[1]) - 1.0) < 1e-5


def _coin(Y):
    dc = Y.DynamicCircuit(3, num_clbits=1)
    dc.rz(0.9, 0)
    dc.sx(0)
    dc.cx(0, 2)
    dc.measure(2, 0)
    return dc


def test_biased_coin_distribution_matches_exact_and_jax():
    # the JAX test's circuit; its exact P(1) from the host reference
    c = T.Circuit(3)
    c.rz(0.9, 0)
    c.sx(0)
    c.cx(0, 2)
    p = np.abs(T.Simulator(TConfig(strategy="reference"),
                           device="cpu").run(c)) ** 2
    exact = float(p[4:].sum())
    shots = 512
    got = TY.run_dynamic_batched(_coin(TY), shots=shots, seed=12,
                                 device="cpu")
    want = JY.run_dynamic_batched(_coin(JY), shots=shots, seed=12)
    _check_frequency(np.mean([r.clbits[0] for r in got]), exact,
                     np.mean([r.clbits[0] for r in want]), shots)
    per_shot = TY.run_dynamic(_coin(TY), shots=64, seed=11, device="cpu")
    assert abs(np.mean([r.clbits[0] for r in per_shot]) - exact) < \
        4 * _sigma(exact, 64)


def test_non_power_of_two_shots_and_width_cap():
    dc = TY.DynamicCircuit(1, num_clbits=1)
    dc.h(0)
    dc.measure(0, 0)
    assert len(TY.run_dynamic_batched(dc, shots=37, seed=5,
                                      device="cpu")) == 37
    dc = TY.DynamicCircuit(3, num_clbits=1)
    dc.h(0).cx(0, 1)
    dc.measure(0, 0)
    # max_width 6 -> chunks of 2^3 = 8 shots; 20 shots = 3 chunks
    res = TY.run_dynamic_batched(dc, shots=20, seed=2, max_width=6,
                                 device="cpu")
    assert len(res) == 20
    assert 0 < sum(r.clbits[0] for r in res) < 20
    with pytest.raises(ValueError) as got:
        TY.run_dynamic_batched(dc, shots=4, max_width=3, device="cpu")
    with pytest.raises(ValueError) as want:
        JY.run_dynamic_batched(JY.DynamicCircuit(3, num_clbits=1), shots=4,
                               max_width=3)
    assert str(got.value) == str(want.value)


def test_batched_strategies_agree():
    def prog(Y):
        dc = Y.DynamicCircuit(8, num_clbits=1)
        rng = np.random.default_rng(0)
        for _ in range(30):
            q = int(rng.integers(8))
            dc.rz(float(rng.uniform(0, 6.28)), q)
            dc.sx(q)
        dc.measure(3, 0)
        dc.h(0)
        return dc

    outs = {}
    for strat in ("mxu", "prefetch", "megakernel"):
        outs[strat] = TY.run_dynamic_batched(
            prog(TY), TConfig(strategy=strat), shots=8, seed=5,
            return_states=True, device="cpu")
    for other in ("prefetch", "megakernel"):
        for a, b in zip(outs["mxu"], outs[other]):
            assert a.clbits == b.clbits
            assert np.max(np.abs(a.state - b.state)) < 2e-5
    # each shot block is the JAX package's per-outcome state
    want = JY.run_dynamic_batched(prog(JY), JConfig(strategy="mxu"),
                                  shots=8, seed=5, return_states=True)
    by_bit = {r.clbits: r.state for r in want}
    for r in outs["mxu"]:
        if r.clbits in by_bit:
            assert np.max(np.abs(r.state - by_bit[r.clbits])) < 2e-5


def test_segments_hand_over_or_copy_alike():
    """The ensemble's segments run on the pair they are handed; through
    ``run_device_parts`` (which copies first) the result is the same."""
    dc = _coin(TY)
    dc.items.extend(T.models.random_circuit(3, 20, seed=4).gates)
    dc.noise("depolarizing", 1, 0.3)
    dc.items.extend(T.models.random_circuit(3, 10, seed=5).gates)
    sim = T.Simulator(device="cpu")
    a = TY._run_ensemble(dc, sim, 4, 3)
    b = TY._run_ensemble(dc, sim, 4, 3, copy_segments=True)
    for x, y in zip(a[:2], b[:2]):
        assert torch.equal(x, y)
    assert torch.equal(a[2][0], b[2][0])


def test_seeds_reproduce_and_differ():
    a = TY.run_dynamic_batched(_bell(TY), shots=64, seed=9, device="cpu")
    b = TY.run_dynamic_batched(_bell(TY), shots=64, seed=9, device="cpu")
    c = TY.run_dynamic_batched(_bell(TY), shots=64, seed=10, device="cpu")
    assert [r.clbits for r in a] == [r.clbits for r in b]
    assert [r.clbits for r in a] != [r.clbits for r in c]
