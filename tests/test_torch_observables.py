"""The port's ``observables.py`` against the JAX package's, on the CPU.

The same seeded numpy states (flat pairs, and the four (R2, 128) column
halves of the in-place layout) go through each package's function, and
the same circuits through each package's Simulator.  Bars: 1e-6 for
expectations, overlaps and marginals (float32 sums in another order),
1e-5 for entropies (eigenvalues of a float32-formed density matrix); the
host parts (``_parse_pauli``, ``qwc_groups``, ``pauli_decompose``'s
terms, the Pauli maps of ``apply_pauli_parts``) and the errors are
exact.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from gpu_quantum_simulator_tpu import models as JM
from gpu_quantum_simulator_tpu import observables as JO
from gpu_quantum_simulator_tpu.config import SimulatorConfig as JConfig

import torch

import gpu_quantum_simulator_tpu_torch as T
from gpu_quantum_simulator_tpu_torch import models as TM
from gpu_quantum_simulator_tpu_torch import observables as TO

EXP_TOL = 1e-6        # expectations, overlaps, marginals
ENTROPY_TOL = 1e-5
N = 8


def _flat(seed, n=N):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    v /= np.linalg.norm(v)
    return v.real.astype(np.float32), v.imag.astype(np.float32)


def _halves(seed, n=N + 2):
    """The four (R2, 128) column halves (re0, re1, im0, im1) of a seeded
    normalized state, as numpy arrays."""
    re, im = _flat(seed, n)
    rows = 1 << (n - 8)
    r, i = re.reshape(rows, 256), im.reshape(rows, 256)
    return tuple(np.ascontiguousarray(x) for x in
                 (r[:, :128], r[:, 128:], i[:, :128], i[:, 128:]))


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _same_error(call, exc=ValueError):
    with pytest.raises(exc) as got:
        call(TO)
    with pytest.raises(exc) as want:
        call(JO)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------- host parts
@pytest.mark.parametrize("spec,n", [
    ("IXZY", 4), ("X0 Z3 Y5", 6), ("  z1  x0 ", 3), ("I0", 2), ("IIII", 4),
    ("Y2 I1", 3)])
def test_parse_pauli_matches_jax(spec, n):
    assert TO._parse_pauli(spec, n) == JO._parse_pauli(spec, n)


@pytest.mark.parametrize("spec,n", [("ZZ", 3), ("Q0", 2), ("X5", 3),
                                    ("IXQ", 3), ("Z0 W1", 2)])
def test_parse_pauli_errors_match_jax(spec, n):
    _same_error(lambda O: O._parse_pauli(spec, n))


def test_qwc_groups_match_jax():
    rng = np.random.default_rng(4)
    terms = TM.tfim_terms(6, 0.9, 0.4, True) + TM.heisenberg_terms(5, h=0.3)
    terms += [(float(rng.standard_normal()),
               " ".join(f"{'XYZ'[int(rng.integers(3))]}{q}"
                        for q in sorted(rng.choice(6, 2, replace=False))))
              for _ in range(12)]
    parsed = [(c, TO._parse_pauli(p, 6)) for c, p in terms]
    assert TO.qwc_groups(parsed) == JO.qwc_groups(parsed)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_pauli_decompose_matches_jax(k):
    rng = np.random.default_rng(10 + k)
    a = rng.standard_normal((1 << k, 1 << k)) \
        + 1j * rng.standard_normal((1 << k, 1 << k))
    h = a + a.conj().T
    labels = tuple(range(2 * k, 3 * k))
    assert TO.pauli_decompose(h, labels) == JO.pauli_decompose(h, labels)
    assert TO.pauli_decompose(h) == JO.pauli_decompose(h)


@pytest.mark.parametrize("case", ["shape", "wide", "hermitian", "labels"])
def test_pauli_decompose_errors_match_jax(case):
    m = {"shape": np.eye(3), "wide": np.eye(128), "labels": np.eye(4),
         "hermitian": np.array([[0, 1], [0, 0]])}[case]
    labels = (0,) if case == "labels" else None
    _same_error(lambda O: O.pauli_decompose(m, labels))


# ------------------------------------------------------- state functions
@pytest.mark.parametrize("spec", ["X0", "Y3", "Z7", "X1 Y4 Z6", "Y0 Y7",
                                  "Z2 Z5 X3"])
def test_apply_pauli_parts_matches_jax(spec):
    re, im = _flat(1)
    ops = TO._parse_pauli(spec, N)
    got = TO.apply_pauli_parts(*_t(re, im), ops, N)
    want = JO.apply_pauli_parts(*_j(re, im), ops, N)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))   # exact maps
    assert not torch.equal(got[0], torch.from_numpy(re)) or spec == "Z7"


def test_inner_parts_matches_jax():
    a, b = _flat(2), _flat(3)
    got = TO.inner_parts(*_t(*a, *b))
    want = JO.inner_parts(*_j(*a, *b))
    for g, w in zip(got, want):
        assert abs(float(g) - float(w)) < EXP_TOL


@pytest.mark.parametrize("qubits", [[0], [7], [2, 4], [4, 2], [1, 3, 5],
                                    [6, 0, 7], list(range(N))])
def test_marginal_probabilities_match_jax(qubits):
    re, im = _flat(5)
    got = TO.marginal_probabilities(*_t(re, im), qubits, N)
    want = JO.marginal_probabilities(*_j(re, im), qubits, N)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) < EXP_TOL


@pytest.mark.parametrize("qubits", [[0], [7], [9], [3, 7], [9, 7, 2], [8, 1],
                                    [6, 5, 9, 7]])
def test_marginal_probabilities_halves_match_jax_and_flat(qubits):
    n = N + 2
    halves = _halves(6, n)
    got = TO.marginal_probabilities_halves(*_t(*halves), qubits, n)
    want = JO.marginal_probabilities_halves(*_j(*halves), qubits, n)
    assert np.max(np.abs(got - want)) < EXP_TOL
    re, im = _flat(6, n)
    flat = TO.marginal_probabilities(*_t(re, im), qubits, n)
    assert np.max(np.abs(got - flat)) < EXP_TOL


@pytest.mark.parametrize("cut", [1, 3, 4, 7])
def test_entanglement_entropy_matches_jax(cut):
    re, im = _flat(7)
    got = TO.entanglement_entropy(*_t(re, im), cut, N)
    want = JO.entanglement_entropy(*_j(re, im), cut, N)
    assert abs(got - want) < ENTROPY_TOL
    got_e = TO.entanglement_entropy(*_t(re, im), cut, N, base=np.e)
    want_e = JO.entanglement_entropy(*_j(re, im), cut, N, base=np.e)
    assert abs(got_e - want_e) < ENTROPY_TOL


@pytest.mark.parametrize("cut", [1, 2, 5, 7])
def test_entanglement_entropy_halves_matches_jax_and_flat(cut):
    n = N + 2
    halves = _halves(8, n)
    got = TO.entanglement_entropy_halves(*_t(*halves), cut, n)
    want = JO.entanglement_entropy_halves(*_j(*halves), cut, n)
    assert abs(got - want) < ENTROPY_TOL
    flat = TO.entanglement_entropy(*_t(*_flat(8, n)), cut, n)
    assert abs(got - flat) < ENTROPY_TOL


@pytest.mark.parametrize("call", [
    lambda O, s: O.marginal_probabilities(*s, [0, 0], N),
    lambda O, s: O.marginal_probabilities(*s, [N], N),
    lambda O, s: O.entanglement_entropy(*s, 0, N),
    lambda O, s: O.entanglement_entropy(*s, N, N),
    lambda O, s: O.entanglement_entropy(*s, 15, 30),
    lambda O, s: O.entanglement_entropy_halves(*(s * 2), 8, N),
    lambda O, s: O.marginal_probabilities_halves(*(s * 2), [1, 1], N),
])
def test_state_function_errors_match_jax(call):
    re, im = _flat(9)
    with pytest.raises(ValueError) as got:
        call(TO, _t(re, im))
    with pytest.raises(ValueError) as want:
        call(JO, _j(re, im))
    assert str(got.value) == str(want.value)


# --------------------------------------------------- circuit entry points
TERMS = [(0.8, "Z0 Z3"), (-0.4, "X1"), (0.3, "Y2 X4"), (0.5, "Z5"),
         (1.1, "I" * 9), (-0.2, "X1 Z0"), (0.25, "Y8 Y7 Z6")]


@pytest.mark.parametrize("strategy,method", [
    ("mxu", "auto"), ("mxu", "basis"), ("mxu", "state"),
    ("prefetch", "state"), ("megakernel", "basis"), ("reference", "basis")])
def test_expectation_pauli_sum_matches_jax(strategy, method):
    c = TM.random_circuit(9, 120, seed=9)
    got = TO.expectation_pauli_sum(c, TERMS, T.SimulatorConfig(
        strategy=strategy), method=method, device="cpu")
    want = JO.expectation_pauli_sum(JM.random_circuit(9, 120, seed=9), TERMS,
                                    JConfig(strategy=strategy), method=method)
    assert abs(got - want) < EXP_TOL


def test_expectation_pauli_sum_halves_route_matches_jax():
    """The in-place engine's route (each QWC group reduced on the four
    column halves), forced at n = 10 as in tests/test_observables.py."""
    n = 10
    terms = TM.tfim_terms(n, J=0.9, g=0.5) + [(0.3, "Y2 X7")]
    got = TO.expectation_pauli_sum(
        TM.random_circuit(n, 80, seed=13), terms,
        T.SimulatorConfig(strategy="prefetch", prefetch_inplace=True),
        method="basis", device="cpu")
    want = JO.expectation_pauli_sum(
        JM.random_circuit(n, 80, seed=13), terms,
        JConfig(strategy="prefetch", prefetch_inplace=True), method="basis")
    assert abs(got - want) < EXP_TOL


@pytest.mark.parametrize("pauli", ["ZZIII", "XIIII", "IYIII", "XYZIX"])
def test_expectation_pauli_matches_jax(pauli):
    got = TO.expectation_pauli(TM.random_circuit(5, 60, seed=11), pauli,
                               device="cpu")
    want = JO.expectation_pauli(JM.random_circuit(5, 60, seed=11), pauli)
    assert abs(got - want) < EXP_TOL


def test_expectation_pauli_sum_errors_match_jax():
    for method, cfg in (("bogus", "mxu"), ("state", "reference")):
        with pytest.raises(ValueError) as got:
            TO.expectation_pauli_sum(TM.ghz(3), [(1.0, "ZZI")],
                                     T.SimulatorConfig(strategy=cfg),
                                     method=method, device="cpu")
        with pytest.raises(ValueError) as want:
            JO.expectation_pauli_sum(JM.ghz(3), [(1.0, "ZZI")],
                                     JConfig(strategy=cfg), method=method)
        assert str(got.value) == str(want.value)


def test_overlap_and_fidelity_match_jax():
    c1, c2 = (TM.random_circuit(9, 60, seed=s) for s in (3, 4))
    j1, j2 = (JM.random_circuit(9, 60, seed=s) for s in (3, 4))
    v = T.Simulator(T.SimulatorConfig(strategy="reference"),
                    device="cpu").run(c2)
    for a, b, ja, jb in ((c1, c2, j1, j2), (c1, v, j1, v), (v, c1, v, j1)):
        got = TO.overlap(a, b, device="cpu")
        want = JO.overlap(ja, jb)
        assert abs(got - want) < EXP_TOL
    assert abs(TO.state_fidelity(c1, c2, device="cpu")
               - JO.state_fidelity(j1, j2)) < EXP_TOL
    assert abs(TO.state_fidelity(c1, c1, device="cpu") - 1.0) < EXP_TOL
    for bad in (TM.ghz(4), np.ones(5, dtype=complex)):
        jbad = JM.ghz(4) if not isinstance(bad, np.ndarray) else bad
        with pytest.raises(ValueError) as got:
            TO.overlap(c1, bad, device="cpu")
        with pytest.raises(ValueError) as want:
            JO.overlap(j1, jbad)
        assert str(got.value).split(":")[0] == str(want.value).split(":")[0]


def test_package_exports_the_jax_names_that_exist():
    import gpu_quantum_simulator_tpu as J

    names = {"circuit_unitary", "expectation_z", "norm_device",
             "sample_state_device", "top_amplitudes_device",
             "expectation_pauli", "expectation_pauli_sum", "pauli_decompose",
             "overlap", "state_fidelity"}
    assert names <= set(T.__all__) and names <= set(J.__all__)
    assert set(T.__all__) <= set(J.__all__) | {"RunResult"}
    for name in T.__all__:
        assert getattr(T, name) is not None
