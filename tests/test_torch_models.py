"""The port's ``models/circuits.py`` against the JAX package's: every
circuit family, for fixed arguments, emits the same gate list (names and
qubits equal, params within 1e-12: both are float64 host arithmetic), and
the term builders and classical post-processing helpers return the same
values.  ``load_reference_circuit`` parses through the port's QASM
front-end."""

import math

import numpy as np
import pytest

from gpu_quantum_simulator_tpu import models as JM
from gpu_quantum_simulator_tpu.ir.circuit import Circuit as JCircuit

import gpu_quantum_simulator_tpu_torch as T
from gpu_quantum_simulator_tpu_torch import models as TM
from gpu_quantum_simulator_tpu_torch.ir.circuit import Circuit

PARAM_TOL = 1e-12

FAMILIES = [
    ("bell", ()),
    ("ghz", (6,)),
    ("qft", (5,)),
    ("random_circuit", (6, 80, 3)),
    ("grover_like", (9, 300, 318)),
    ("grover", (4, 11)),
    ("grover_parts", (5, 19, 3)),
    ("w_state", (5,)),
    ("bernstein_vazirani", (0b1011, 5)),
    ("simon", (0b101, 3)),
    ("deutsch_jozsa", (5, True, 0b10110)),
    ("deutsch_jozsa", (4, False)),
    ("phase_estimation", (5, 2 * math.pi * 0.3125)),
    ("shor_order_finding", (7, 4)),
    ("qaoa_maxcut", (6, None, (0.7, 0.2), (0.4, 0.9))),
    ("qaoa_maxcut_parts", (6, [(0, 2), (1, 4), (3, 5)], 0.3, 0.8, 2)),
    ("qaoa_maxcut_tied", (6,)),
    ("trotter_tfim", (6, 0.05, 1.0, 0.7, 3, True, 2)),
    ("trotter_tfim_parts", (6, 0.05, 1.0, 0.7, 4)),
    ("trotter_heisenberg", (5, 0.1, 1.0, 0.5, 0.3, 0.2, 2, True)),
    ("trotter_heisenberg_parts", (5, 0.1)),
    ("quantum_volume", (4, 3, 11)),
    ("pauli_evolution", (4, [(0.5, "X0 Z1"), (-0.3, "YYII"), (0.2, "I0")],
                         0.8, 3, 2)),
    ("pauli_evolution_parts", (4, [(0.5, "X0 Z1"), (-0.3, "Y2 Y3")], 0.1)),
    ("maxcut_cost_terms", (5,)),
    ("tfim_terms", (5, 1.0, 0.5, True)),
    ("heisenberg_terms", (4, 1.0, 0.5, 0.2, 0.1, True)),
    ("ring_edges", (5,)),
]


def assert_same(got, want):
    """Circuits gate for gate; tuples and lists item for item; numbers
    within PARAM_TOL; anything else equal."""
    if isinstance(want, JCircuit):
        assert isinstance(got, Circuit) and got.num_qubits == want.num_qubits
        assert [g.name for g in got.gates] == [g.name for g in want.gates]
        assert [g.qubits for g in got.gates] == [g.qubits for g in want.gates]
        for g, w in zip(got.gates, want.gates):
            assert np.allclose(g.params, w.params, rtol=0, atol=PARAM_TOL)
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert_same(a, b)
    elif isinstance(want, float):
        assert abs(got - want) <= PARAM_TOL
    else:
        assert got == want


@pytest.mark.parametrize("name,args", FAMILIES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(FAMILIES)])
def test_family_matches_jax(name, args):
    assert_same(getattr(TM, name)(*args), getattr(JM, name)(*args))


def test_every_family_is_held_and_exported():
    held = {name for name, _ in FAMILIES}
    helpers = {"GROVER_3_18_PROFILE", "load_reference_circuit",
               "simon_secret_from_samples", "shor_factors_from_index"}
    assert set(TM.__all__) == set(JM.__all__)
    assert set(TM.__all__) == held | helpers
    assert TM.GROVER_3_18_PROFILE == JM.GROVER_3_18_PROFILE


def test_post_processing_helpers_match_jax():
    rng = np.random.default_rng(3)
    samples = [int(s) for s in rng.integers(0, 8, 12)
               if bin(int(s) & 0b101).count("1") % 2 == 0]
    assert (TM.simon_secret_from_samples(samples, 3)
            == JM.simon_secret_from_samples(samples, 3))
    for index in (0, 64, 128, 192):
        assert (TM.shor_factors_from_index(index, 8, 7)
                == JM.shor_factors_from_index(index, 8, 7))


def test_models_run_like_the_jax_package():
    """A family through the port's Simulator on the CPU lands where the JAX
    package's reference does (grover's marked state, 1e-6 "highest")."""
    from gpu_quantum_simulator_tpu.ref.cpu import simulate_reference

    c = TM.grover(5, 19)
    got = T.Simulator(T.SimulatorConfig(strategy="mxu"), device="cpu").run(c)
    want = simulate_reference(JM.grover(5, 19))
    assert np.max(np.abs(got - want)) < 1e-6
    assert int(np.argmax(np.abs(got[:32]) ** 2)) == 19


def test_load_reference_circuit_parses_through_the_port(tmp_path,
                                                        monkeypatch):
    """load_reference_circuit reads ``<name>.qasm`` from the reference
    directory through the port's parser; a missing file is an OSError."""
    from gpu_quantum_simulator_tpu_torch.models import circuits as TC

    c = TM.grover_like(6, 120, 3)
    (tmp_path / "grover_like.qasm").write_text(c.to_qasm())
    monkeypatch.setattr(TC, "_REFERENCE_DIR", str(tmp_path))
    for name in ("grover_like", "grover_like.qasm"):
        got = TM.load_reference_circuit(name)
        assert got.num_qubits == 6
        assert [(g.name, g.qubits, g.params) for g in got.gates] == \
            [(g.name, g.qubits, g.params) for g in c.gates]
    with pytest.raises(OSError):
        TM.load_reference_circuit("grover_3_18")
